"""npz wire codec for KV-cache trees — the port's copy of the JAX
package's ``serve/kv_codec.py``, writing the same bytes.

One format carries three planes: cross-replica prefix-cache transfer
(``prefix_cache:export`` / ``:pull``), per-request KV spans from a
prefill replica to its decode replica (``kv_span:prefill``), and the
host-RAM KV tier (``serve/kv_tier.py``). Wire layout (``np.savez``
members, read back with ``allow_pickle=False``: the payload crosses a
network boundary and must stay plain arrays):

- ``"{i}|{layer}|{which}"`` — entry ``i``'s per-layer arrays (``which``
  ∈ ``k``/``v``/``k_scale``/``v_scale``);
- ``__keys__`` — JSON bytes: the token-id key of each entry;
- ``__meta__`` — optional JSON bytes: span metadata (``real_len``,
  ``first_tok``, ``valid``), absent for prefix-cache transfers.

Tensors cross between torch and the wire at two helpers only:

- :func:`tree_to_numpy` copies a cache tree to the host in the JAX
  pytree's order (layer names, then planes, sorted as strings: the order
  a jitted JAX function returns a dict in), so the members follow each
  other as in a JAX replica's blob. A bf16 plane becomes its bits viewed
  as a 2-byte void array, and :func:`encode_kv_entries` records it as
  ``'<V2'``, the descriptor numpy writes for the JAX side's
  ``ml_dtypes.bfloat16``: the blob is byte for byte the JAX codec's.
- :func:`numpy_to_pool` turns a decoded plane into a tensor of the
  receiving pool's dtype on its device. ``np.load`` gives a bf16 plane
  back as ``'|V2'`` (numpy knows no bfloat16); it is read as the pool's
  bf16 bits. This is the port's one difference from the reference, whose
  ``jnp.asarray`` rejects a ``'|V2'`` plane, so a JAX replica cannot
  read a bf16 blob (its own or the port's); no wire byte differs. Any
  other plane whose dtype is not the pool's is rejected.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any

import numpy as np
import torch

#: how numpy describes ``ml_dtypes.bfloat16`` in an ``.npy`` header
_BF16_DESCR = "<V2"
_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
}


def _write_npy(fid, arr: np.ndarray) -> None:
    """``np.lib.format.write_array`` for a C-contiguous plain array, with a
    2-byte void plane (a bf16 plane's bits) described as ``'<V2'``."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        header["descr"] = _BF16_DESCR
    np.lib.format.write_array_header_1_0(fid, header)
    fid.write(np.ascontiguousarray(arr).tobytes("C"))


def encode_kv_entries(entries, meta: dict | None = None) -> bytes:
    """``[(key, {layer: {"k": np, "v": np, ...}}), ...]`` (+ optional JSON
    ``meta``) → one npz blob, laid out as ``np.savez`` lays it out."""
    arrays: dict[str, Any] = {}
    keys = []
    for i, (key, tree) in enumerate(entries):
        keys.append([int(t) for t in key])
        for layer, kv in tree.items():
            for which, arr in kv.items():
                arrays[f"{i}|{layer}|{which}"] = arr
    arrays["__keys__"] = np.frombuffer(json.dumps(keys).encode(), dtype=np.uint8)
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    buf = io.BytesIO()
    # np.savez's own container: stored members, zip64 forced per member
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, np.asanyarray(arr))
    return buf.getvalue()


def decode_kv_entries(blob: bytes):
    """Inverse of :func:`encode_kv_entries` → ``(entries, meta)``; ``meta``
    is None for payloads encoded without one. Planes stay numpy arrays."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z.files else None)
        entries = []
        for i, key in enumerate(keys):
            tree: dict[str, dict[str, Any]] = {}
            prefix = f"{i}|"
            for name in z.files:
                if not name.startswith(prefix):
                    continue
                _, layer, which = name.split("|", 2)
                tree.setdefault(layer, {})[which] = z[name]
            entries.append((tuple(int(t) for t in key), tree))
    return entries, meta


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def tree_to_numpy(tree) -> dict:
    """``{layer: {plane: tensor}}`` → host arrays in the JAX pytree's
    order (sorted layer names, sorted planes). Blocks until the copies
    are done: callers run it off the scheduler thread."""
    return {name: {which: _to_numpy(tree[name][which])
                   for which in sorted(tree[name])}
            for name in sorted(tree)}


def plane_dtype_reject(arr: np.ndarray, like: torch.Tensor) -> str | None:
    """Why a wire plane cannot become a plane of ``like``'s dtype; None
    when it can (a ``V2`` plane holds bf16 bits)."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize == 2 and like.dtype == torch.bfloat16:
            return None
    elif _NP_TO_TORCH.get(arr.dtype) == like.dtype:
        return None
    return f"plane dtype {arr.dtype} does not match the pool's {like.dtype}"


def numpy_to_pool(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A decoded plane as a tensor of ``like``'s dtype on its device;
    raises ValueError when the dtypes differ (see the module docstring)."""
    reason = plane_dtype_reject(arr, like)
    if reason is not None:
        raise ValueError(reason)
    arr = np.array(arr, order="C")  # writable: np.load's may be read-only
    if arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device)
