"""PyTorch + CUDA port of ``kubeflow_tpu``'s LM serving path, for one H100.

The layout mirrors the JAX package (``models/``, ``ops/``, ``serve/``) so
each module's counterpart is easy to find; ``kubeflow_tpu`` stays the
numerics reference and nothing here imports it (or JAX). The attention
kernels the JAX package wrote in Pallas are hand-written CUDA C++ under
``ops/csrc/``, built with ``nvcc`` on first use.

Entry points take a ``device``: ``None`` means the CUDA card, and a host
without one raises instead of quietly running on the CPU. Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch twin.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` → ``cuda``; an explicit
    ``"cpu"`` is honoured. Asking for CUDA on a host without a card raises
    — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubeflow_tpu_torch needs a CUDA device; pass device='cpu' to "
            "run the plain PyTorch path instead"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
