"""Token sampling: the port of ``kubeflow_tpu/serve/generate.py:sample_logits``.

The whole-batch ``make_generate_fn`` path and ``LMRuntimeModel`` are not
ported yet (ROADMAP queue 1 item 3); the engine is the serving path.
"""

from __future__ import annotations

import torch


def sample_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """Per-row greedy/temperature sampling over ``(B, V)`` logits.

    ``temperature`` is per row ``(B,)``: rows at ``<= 0`` take the argmax
    (the first index on ties, as ``jnp.argmax``); the others draw from
    ``softmax(logits / t)`` by Gumbel-max with noise from ``generator``.
    The draws differ from JAX's threefry stream for the same seed, so only
    greedy streams match the JAX engine token for token.
    """
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand(
        scaled.shape, generator=generator, device=scaled.device
    ).clamp_min(torch.finfo(torch.float32).tiny)
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn)
