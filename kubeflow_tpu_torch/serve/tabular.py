"""Shared helpers for tabular (sklearn/xgboost-style) serving runtimes:
payload→(batch, features) coercion and model-file discovery. One
implementation so protocol fixes land in every tabular runtime at once.
A copy of ``kubeflow_tpu/serve/tabular.py``, which imports no JAX."""

from __future__ import annotations

import os
from typing import Any, Mapping, Sequence

import numpy as np


def coerce_tabular_payload(payload: Any) -> np.ndarray:
    """v1 ``{"instances": ...}``, v2 ``{"inputs": {name: tensor}}`` (first
    tensor), or a raw array-like → float32 ``(batch, features)``."""
    if isinstance(payload, Mapping) and isinstance(payload.get("inputs"), Mapping):
        arr = np.asarray(next(iter(payload["inputs"].values())), np.float32)
    elif isinstance(payload, Mapping) and "instances" in payload:
        arr = np.asarray(payload["instances"], np.float32)
    else:
        arr = np.asarray(payload, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"expected (batch, features); got {arr.shape}")
    return arr


def find_model_file(
    storage_path: str,
    *,
    preferred: Sequence[str],
    suffixes: Sequence[str],
    kind: str,
    exclude_suffixes: Sequence[str] = (),
) -> str:
    """The /mnt/models discovery contract: the path itself, a preferred
    basename, or exactly one ``*suffix`` file in the directory."""
    if os.path.isfile(storage_path):
        return storage_path
    if os.path.isdir(storage_path):
        for name in preferred:
            p = os.path.join(storage_path, name)
            if os.path.isfile(p):
                return p
        cands = [
            os.path.join(storage_path, n)
            for n in sorted(os.listdir(storage_path))
            if n.endswith(tuple(suffixes))
            and not n.endswith(tuple(exclude_suffixes))
        ]
        if len(cands) == 1:
            return cands[0]
        if cands:
            raise RuntimeError(
                f"ambiguous {kind} model dir {storage_path!r}: {cands}"
            )
    raise RuntimeError(
        f"no {kind} model file ({'/'.join(suffixes)}) under {storage_path!r}"
    )
