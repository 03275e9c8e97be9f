"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
twins, forward and backward.

Counterpart of ``kubeflow_tpu/ops/flash_attention.py``. Shapes follow the
JAX package: q ``(B, H, Sq, D)``, k/v ``(B, H, Skv, D)`` (GQA heads
repeated by the caller), optional int32 segment ids ``(B, Sq)`` and
``(B, Skv)``. :func:`flash_attention` returns the output in q's dtype and,
with ``return_residuals=True``, also the per-row log-sum-exp ``(B, H,
Sq)`` in f32. Without residuals it is differentiable: one autograd
function on both devices saves ``(q, k, v, out, lse)`` and its backward is
:func:`flash_attention_bwd`.

CUDA tensors launch ``csrc/flash_attention.cu`` (forward, ``LAUNCHES``
counts it) and ``csrc/flash_attention_bwd.cu`` (dq and dk/dv, counted by
``flash_attention_bwd.DQ_LAUNCHES`` / ``DKV_LAUNCHES``); CPU tensors run
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`.
Each kernel has two bodies, chosen by dtype and head dim alone
(:func:`body`): tensor cores for bf16/f16 with D a multiple of 16 up to
128, scalar f32 arithmetic otherwise (f32 inputs stay exact f32; a
tensor-core f32 product would be TF32).
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubeflow_tpu_torch.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps exp() defined on masked rows
#: kernel launches since the counter was last set to 0
LAUNCHES = 0
#: the same launches split by the body that ran (see :func:`body`)
LAUNCHES_BY_BODY = {"mma": 0, "scalar": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 128  # the kernel's shared-memory tiles hold D <= 128


def body(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body a launch runs, as the C entry points choose it:
    ``"mma"`` (tensor cores) for bf16/f16 with ``head_dim`` a multiple of
    16 up to 128, else ``"scalar"``. Shared by the forward and both
    backward kernels (dq, dk/dv)."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim % 16 == 0 \
            and 0 < head_dim <= _MAX_HEAD_DIM:
        return "mma"
    return "scalar"


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
    if return_residuals:
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, **kw)
        return _launch(q, k, v, **kw)
    return _FlashAttention.apply(
        q, k, v, q_segment_ids, kv_segment_ids, causal, scale, window
    )


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (the twin on the CPU), saving the JAX
    ``_flash_fwd`` residuals; backward through :func:`flash_attention_bwd`,
    gradients cast to the inputs' dtypes and none for the segment ids."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, window):
        kw = dict(causal=causal, scale=scale, q_segment_ids=q_seg,
                  kv_segment_ids=kv_seg, window=window)
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, **kw)
        else:
            out, lse = _launch(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.kw = dict(causal=causal, scale=scale, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, **ctx.kw,
        )
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def _bwd_probs(q, k, v, out, lse, dout, *, causal, scale,
               q_segment_ids=None, kv_segment_ids=None, window=None):
    """``(p, ds)`` of the backward, (B, H, Sq, Skv) f32, as the Pallas
    ``_prob_block`` and kernel bodies form them: p = exp(s·scale − lse),
    0 where masked and on dead rows (lse at the ``NEG_INF`` sentinel);
    ds = p·(dp − delta)·scale with dp = dO·Vᵀ, rounded to q's dtype."""
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    live = (lse > NEG_INF / 2)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None], 0.0)),
                    0.0)
    mask = _full_mask(q.shape, k.shape, q_segment_ids, kv_segment_ids,
                      causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    return p, ds


def flash_attention_bwd_reference(
    q, k, v, out, lse, dout, *, causal, scale=None,
    q_segment_ids=None, kv_segment_ids=None, window=None,
):
    """Plain twin of the backward kernels: f32 ``(dq, dk, dv)`` following
    the Pallas kernel bodies step for step (:func:`_bwd_probs`), then
    dq = ds·K, dk = dsᵀ·Q, dv = p(dO's dtype)ᵀ·dO, accumulated in f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_probs(q, k, v, out, lse, dout, causal=causal, scale=scale,
                       q_segment_ids=q_segment_ids,
                       kv_segment_ids=kv_segment_ids, window=window)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dout.float())
    return dq, dk, dv


def flash_attention_bwd(
    q, k, v, out, lse, dout, *, causal, scale=None,
    q_segment_ids=None, kv_segment_ids=None, window=None,
):
    """Flash-attention gradients from the forward's residuals: f32
    ``(dq, dk, dv)``. ``delta = rowsum(dO·O)`` is formed here in plain
    torch, as the JAX wrapper forms it outside Pallas; CUDA tensors then
    launch the dq and dk/dv kernels, CPU tensors run the twin."""
    _check_args(q, k, v, causal, q_segment_ids, kv_segment_ids, window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    from kubeflow_tpu_torch.ops import flash_attention_bwd as kernels

    delta = (dout.float() * out.float()).sum(-1)
    dq = kernels.launch_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = kernels.launch_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


def _check_launch(q, k, v, q_segment_ids, kv_segment_ids, **more):
    """The kernels' input contract: q/k/v, the segment ids and ``more``'s
    tensors on q's device and contiguous; q/k/v of one supported dtype,
    D <= 128; int32 segment ids of shape (B, Sq) / (B, Skv). Returns
    ``(B, H, Sq, Skv, D)``."""
    named = {"q": q, "k": k, "v": v, **more}
    if q_segment_ids is not None:
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
    if q_segment_ids is not None:
        if (q_segment_ids.dtype != torch.int32
                or kv_segment_ids.dtype != torch.int32):
            raise TypeError("segment ids must be int32")
        if tuple(q_segment_ids.shape) != (B, Sq) or \
                tuple(kv_segment_ids.shape) != (B, Skv):
            raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    return B, H, Sq, Skv, D


def _launch(q, k, v, *, causal, scale, q_segment_ids, kv_segment_ids,
            window):
    global LAUNCHES
    B, H, Sq, Skv, D = _check_launch(q, k, v, q_segment_ids, kv_segment_ids)
    seg = q_segment_ids is not None
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    none = ctypes.c_void_p(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        LAUNCHES_BY_BODY[body(q.dtype, D)] += 1
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
