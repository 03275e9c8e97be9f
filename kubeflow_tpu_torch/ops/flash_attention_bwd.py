"""Launch wrappers of the flash-attention backward kernels.

``csrc/flash_attention_bwd.cu`` holds two kernels, each behind its own C
entry point and counted by its own launch counter: ``DQ_LAUNCHES``
(``kft_flash_bwd_dq``, the Pallas ``_bwd_dq_kernel``) and
``DKV_LAUNCHES`` (``kft_flash_bwd_dkv``, the Pallas ``_bwd_dkv_kernel``).
They take CUDA tensors only: the public entry point, the plain twin and
the CPU route are ``flash_attention.flash_attention_bwd`` and
``flash_attention_bwd_reference``. Gradients come back in f32 (the JAX
``accum_dtype``), launched on the current stream. Both kernels run on
the tensor cores for bf16/f16 with D a multiple of 16 up to 128
(``"wgmma"``: ``flash_bwd_dq_wgmma_kernel`` / ``flash_bwd_dkv_wgmma_kernel``,
TMA loads into an mbarrier ring fed by a producer warp, warpgroup
products, persistent blocks) and otherwise on register-tiled f32 FMAs
(``"fma"``, ``flash_bwd_dq_fma_kernel`` / ``flash_bwd_dkv_fma_kernel``):
see :func:`dq_body` and :func:`dkv_body`.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.flash_attention import (
    COUNT_LOCK, _DTYPE_CODES, _check_launch, shape_key, tensor_cores)

#: dq kernel launches since the counter was last set to 0
DQ_LAUNCHES = 0
#: the same launches split by the body that ran (see :func:`dq_body`)
DQ_LAUNCHES_BY_BODY = {"wgmma": 0, "fma": 0}
#: the same launches split by shape (``flash_attention.shape_key``)
DQ_LAUNCHES_BY_SHAPE: dict[str, int] = {}
#: dk/dv kernel launches since the counter was last set to 0
DKV_LAUNCHES = 0
#: the same launches split by the body that ran (see :func:`dkv_body`)
DKV_LAUNCHES_BY_BODY = {"wgmma": 0, "fma": 0}
#: the same launches split by shape (``flash_attention.shape_key``)
DKV_LAUNCHES_BY_SHAPE: dict[str, int] = {}


def dq_body(dtype: torch.dtype, head_dim: int) -> str:
    """The dq kernel body a launch runs, as ``kft_flash_bwd_dq`` chooses
    it: ``"wgmma"`` where :func:`flash_attention.tensor_cores`, else
    ``"fma"``."""
    return "wgmma" if tensor_cores(dtype, head_dim) else "fma"


def dkv_body(dtype: torch.dtype, head_dim: int) -> str:
    """The dk/dv kernel body a launch runs, as ``kft_flash_bwd_dkv``
    chooses it: ``"wgmma"`` where :func:`flash_attention.tensor_cores`,
    else ``"fma"``."""
    return "wgmma" if tensor_cores(dtype, head_dim) else "fma"


def _checked(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids):
    B, H, Sq, Skv, D = _check_launch(
        q, k, v, q_segment_ids, kv_segment_ids, dout=dout, lse=lse,
        delta=delta,
    )
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise TypeError(
            f"dout {dout.dtype} {tuple(dout.shape)} must match q "
            f"{q.dtype} {tuple(q.shape)}"
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq):
            raise TypeError(f"{name} must be f32 (B, H, Sq) = {(B, H, Sq)}")
    return B, H, Sq, Skv, D


def _common(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids):
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    none = ctypes.c_void_p(0)
    seg = q_segment_ids is not None
    return [ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta),
            ptr(q_segment_ids) if seg else none,
            ptr(kv_segment_ids) if seg else none]


def _dims(dims, causal, window, scale, dtype, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    return [*dims, int(bool(causal)), 0 if window is None else int(window),
            float(scale), _DTYPE_CODES[dtype], ctypes.c_void_p(stream)]


def count_dq(body_name: str, key: str) -> None:
    """Count one dq launch of body ``body_name`` at shape ``key``."""
    global DQ_LAUNCHES
    with COUNT_LOCK:
        DQ_LAUNCHES += 1
        DQ_LAUNCHES_BY_BODY[body_name] += 1
        DQ_LAUNCHES_BY_SHAPE[key] = DQ_LAUNCHES_BY_SHAPE.get(key, 0) + 1


def count_dkv(body_name: str, key: str) -> None:
    """Count one dk/dv launch of body ``body_name`` at shape ``key``."""
    global DKV_LAUNCHES
    with COUNT_LOCK:
        DKV_LAUNCHES += 1
        DKV_LAUNCHES_BY_BODY[body_name] += 1
        DKV_LAUNCHES_BY_SHAPE[key] = DKV_LAUNCHES_BY_SHAPE.get(key, 0) + 1


def launch_dq(q, k, v, dout, lse, delta, *, causal, scale, q_segment_ids,
              kv_segment_ids, window):
    """f32 dq ``(B, H, Sq, D)`` from the kernel."""
    dims = _checked(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        args = _common(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids)
        count_dq(dq_body(q.dtype, dims[4]), shape_key(q.dtype, *dims, causal))
        code = lib.kft_flash_bwd_dq(
            *args, ctypes.c_void_p(dq.data_ptr()),
            *_dims(dims, causal, window, scale, q.dtype, q.device),
        )
    _build.check(lib, code, "flash_attention_bwd dq kernel")
    return dq


def launch_dkv(q, k, v, dout, lse, delta, *, causal, scale, q_segment_ids,
               kv_segment_ids, window):
    """f32 ``(dk, dv)``, each ``(B, H, Skv, D)``, from the kernel."""
    dims = _checked(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        args = _common(q, k, v, dout, lse, delta, q_segment_ids, kv_segment_ids)
        count_dkv(dkv_body(q.dtype, dims[4]), shape_key(q.dtype, *dims, causal))
        code = lib.kft_flash_bwd_dkv(
            *args, ctypes.c_void_p(dk.data_ptr()), ctypes.c_void_p(dv.data_ptr()),
            *_dims(dims, causal, window, scale, q.dtype, q.device),
        )
    _build.check(lib, code, "flash_attention_bwd dk/dv kernel")
    return dk, dv


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    dims = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn, outs in ((lib.kft_flash_bwd_dq, 1), (lib.kft_flash_bwd_dkv, 2)):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * (8 + outs) + dims
            fn.restype = ctypes.c_int
    return lib
