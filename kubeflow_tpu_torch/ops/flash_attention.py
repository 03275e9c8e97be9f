"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch twin.

Counterpart of ``kubeflow_tpu/ops/flash_attention.py``. Shapes follow the
JAX package: q ``(B, H, Sq, D)``, k/v ``(B, H, Skv, D)`` (GQA heads
repeated by the caller), optional int32 segment ids ``(B, Sq)`` and
``(B, Skv)``. :func:`flash_attention` returns the output in q's dtype and,
with ``return_residuals=True``, also the per-row log-sum-exp ``(B, H,
Sq)`` in f32.

CUDA tensors launch ``csrc/flash_attention.cu``; CPU tensors run
:func:`flash_attention_reference`. ``LAUNCHES`` counts kernel launches.
The backward kernels (the Pallas ``flash_attention_bwd``) belong to the
training slice: until then a gradient through the CUDA path raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubeflow_tpu_torch.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps exp() defined on masked rows
#: kernel launches since the counter was last set to 0
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 128  # the kernel's shared-memory tiles hold D <= 128


def _full_mask(q_shape, k_shape, q_seg, kv_seg, causal, window, device):
    """(B|1, 1, Sq, Skv) bool mask or None — causal aligned bottom-right
    (query i sits at position i + Skv - Sq), sliding window, segments."""
    sq, skv = q_shape[2], k_shape[2]
    mask = None
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=device).tril(
            diagonal=skv - sq
        )[None, None]
        if window is not None:
            qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
            kpos = torch.arange(skv, device=device)[None, :]
            mask = mask & ((qpos - kpos) < window)[None, None]
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def _check_args(q, k, v, causal, q_segment_ids, kv_segment_ids, window):
    if q.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "must be (B,H,Sq,D) / (B,H,Skv,D)"
        )
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} != kv heads {k.shape[1]} "
            "(repeat kv heads for GQA before calling)"
        )
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids or neither")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} needs causal=True and window >= 1")


def reference_attention(
    q, k, v, *, causal=False, scale=None,
    q_segment_ids=None, kv_segment_ids=None, window=None,
):
    """Plain attention: f32 scores, masked softmax, output in q's dtype —
    the numerics oracle of the JAX package's ``reference_attention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _full_mask(q.shape, k.shape, q_segment_ids, kv_segment_ids,
                      causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_reference(
    q, k, v, *, causal=False, scale=None,
    q_segment_ids=None, kv_segment_ids=None, window=None,
):
    """Plain twin of the kernel: ``(out, lse)`` with the kernel's softmax
    algebra (``lse = m + log(l)``, rows with ``l == 0`` safe). As in the
    kernel (and the Pallas ``p.astype(v.dtype)``), p is rounded to the
    input dtype for the p.v product while l sums the unrounded p."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _full_mask(q.shape, k.shape, q_segment_ids, kv_segment_ids,
                      causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, 1.0, l)
    pv = p.to(v.dtype).float()
    out = torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / safe_l
    return out.to(q.dtype), (m + torch.log(safe_l))[..., 0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    window: int | None = None,
    return_residuals: bool = False,
):
    """Fused attention. ``window`` (needs ``causal``): each query sees keys
    in ``[qpos - window + 1, qpos]``. ``return_residuals`` also returns the
    per-row lse ``(B, H, Sq)`` f32. CPU tensors run the plain twin; CUDA
    tensors launch the kernel (contiguous q/k/v, D <= 128)."""
    _check_args(q, k, v, causal, q_segment_ids, kv_segment_ids, window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, window=window)
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, **kw)
        return (out, lse) if return_residuals else out
    if return_residuals:
        return _launch(q, k, v, **kw)
    return _FlashAttention.apply(
        q, k, v, q_segment_ids, kv_segment_ids, causal, scale, window
    )


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel; the backward kernels are not ported."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, window):
        out, _ = _launch(q, k, v, causal=causal, scale=scale,
                         q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                         window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "flash-attention backward kernels are not ported yet "
            "(ROADMAP queue 2 item 3, the training slice)"
        )


def _launch(q, k, v, *, causal, scale, q_segment_ids, kv_segment_ids,
            window):
    global LAUNCHES
    seg = q_segment_ids is not None
    named = {"q": q, "k": k, "v": v}
    if seg:
        named.update(q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {_MAX_HEAD_DIM} not supported")
    if seg:
        if (q_segment_ids.dtype != torch.int32
                or kv_segment_ids.dtype != torch.int32):
            raise TypeError("segment ids must be int32")
        if tuple(q_segment_ids.shape) != (B, Sq) or \
                tuple(kv_segment_ids.shape) != (B, Skv):
            raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    none = ctypes.c_void_p(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        code = lib.kft_flash_forward(
            ptr(q), ptr(k), ptr(v),
            ptr(q_segment_ids) if seg else none,
            ptr(kv_segment_ids) if seg else none,
            ptr(out), ptr(lse), B, H, Sq, Skv, D, int(bool(causal)),
            0 if window is None else int(window), float(scale),
            _DTYPE_CODES[q.dtype], ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "flash_attention kernel")
    return out, lse


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.kft_flash_forward
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int] + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
