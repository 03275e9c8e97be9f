"""Paged span attention over a block-table KV pool (the vLLM PagedAttention
analog), with its hand-written CUDA kernel and plain PyTorch twin.

Counterpart of ``kubeflow_tpu/ops/paged_attention.py``. The engine's pool
stores each layer's keys and values as ONE flat token axis —
``(kv_heads, pool_tokens, head_dim)`` — and a row's logical token ``j``
lives at pool token ``table[row, j // P] * P + j % P``. ``S`` queries per
row form a contiguous span starting at absolute position ``pos0[row]``
(S=1 decode, S=bucket prefill piece); causal and sliding-window masks are
arithmetic on positions, so no mask operand exists.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA
tensors and runs :func:`paged_attention_reference` for CPU tensors — the
choice follows the tensors' device only, never a fallback on error.
``LAUNCHES`` counts kernel launches (``LAUNCHES_BY_S`` by span length,
``LAUNCHES_BY_BODY`` by body, ``LAUNCHES_BY_SHAPE`` by :func:`shape_key`),
so a run can show the serving path went
through the kernel. The kernel has two bodies, chosen by q's dtype and
the rows a kv head ``G * S`` alone (:func:`body`): ``"decode"``, one lane
a key on f32 FMAs, for every dtype (f32 is the parity path) and for
bf16/f16 spans of at most ``_MMA_MIN_GS`` rows (the served decode); and
``"mma"``, ``mma.sync`` tensor-core products over a 16-row tile, for
bf16/f16 q with more rows (the speculative verify, GQA groups, prefill
pieces). In both, a row's visible pages are cut into fixed groups that
the warps of a thread-block cluster share, merged through distributed
shared memory in group order, so a row's output bits do not depend on
the batch or the table width. Both take head dims up to 128 whose pool
rows are a whole number of 16-byte chunks (:func:`kernel_supports`).

int8 KV: :func:`quantize_kv` makes per-(kv head, token) symmetric int8
codes plus an f32 scale; both read paths dequantize with the same single
multiply ``code * scale``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from kubeflow_tpu_torch.ops import _build

NEG_INF = -1e30  # the gather path's masked-score fill
#: kernel launches since the counter was last set to 0
LAUNCHES = 0
#: guards the counters: engines on several threads launch concurrently
COUNT_LOCK = threading.Lock()
#: the same launches by query span S (1: decode, K+1: a speculative
#: verify, a bucket or chunk: a prefill piece); cleared with LAUNCHES
LAUNCHES_BY_S: dict[int, int] = {}
#: the same launches by kernel body (:func:`body`); set to 0 with LAUNCHES
LAUNCHES_BY_BODY: dict[str, int] = {"decode": 0, "mma": 0}
#: the same launches by :func:`shape_key`; cleared with LAUNCHES
LAUNCHES_BY_SHAPE: dict[str, int] = {}

_DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3,
}
_MAX_HEAD_DIM = 128  # the decode body's lanes own at most 4 output columns each
#: rows a kv head (G * S) above which bf16/f16 spans take the "mma" body;
#: ``MMA_MIN_GS`` in ``csrc/paged_attention.cu``
_MMA_MIN_GS = 4


_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.int8: "int8"}


def shape_key(q_dtype: torch.dtype, kv_dtype: torch.dtype, B: int, H: int,
              Hkv: int, S: int, D: int, page_size: int, pages: int) -> str:
    """A launch's shape as ``LAUNCHES_BY_SHAPE`` names it, e.g.
    ``"bf16 kv=bf16 B8 H8 Hkv8 S1 D64 P32 W4"`` (``W``: the table's
    width in pages)."""
    return (f"{_DTYPE_NAMES[q_dtype]} kv={_DTYPE_NAMES[kv_dtype]} B{B} H{H} "
            f"Hkv{Hkv} S{S} D{D} P{page_size} W{pages}")


def body(groups: int, span: int, q_dtype: torch.dtype) -> str:
    """The kernel body a launch runs, by the C launcher's rule
    (``mma_body`` in ``csrc/paged_attention.cu``): ``"mma"``, tensor-core
    products over 16-row tiles, for bf16/f16 q with ``groups * span``
    (the GQA group times the query span) above ``_MMA_MIN_GS``; otherwise
    ``"decode"``, one lane a key on f32 FMAs."""
    half = q_dtype in (torch.bfloat16, torch.float16)
    return "mma" if half and groups * span > _MMA_MIN_GS else "decode"


def kernel_supports(head_dim: int, kv_dtype: torch.dtype) -> bool:
    """Whether the kernel takes pools of this head dim and dtype: D up to
    128 with a pool row of whole 16-byte chunks (both bodies copy whole
    rows with bulk or TMA copies), the rule ``kft_paged_attention`` in the
    CUDA source checks; the same for both bodies."""
    row_bytes = head_dim * torch.empty((), dtype=kv_dtype).element_size()
    return 0 < head_dim <= _MAX_HEAD_DIM and row_bytes % 16 == 0


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization over the trailing head_dim:
    ``(codes int8 (..., D), scales f32 (...,))`` with ``scale = max|x| /
    127`` (floored at 1e-8 / 127 so an all-zero vector stays zeros) and
    ``codes = clip(round(x / scale), -127, 127)``, round half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``codes (..., D) * scale (...,)``."""
    return codes.float() * scale[..., None].float()


def _score_mult(d: int, scale: float | None) -> float:
    # 1/sqrt(D) computed in f32, as the gather path spells it
    if scale is None:
        return float(np.float32(1.0) / np.sqrt(np.float32(d)))
    return float(scale)


def _validate(q, k_pool, v_pool, page_table, pos0, page_size, window,
              k_scale, v_scale):
    if q.dim() != 4 or k_pool.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} must be (B,H,S,D), pools (Hkv,T,D)")
    B, H, S, D = q.shape
    Hkv, T, Dk = k_pool.shape
    if Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs D={D}"
        )
    if H % Hkv:
        raise ValueError(f"{H} query heads not a multiple of {Hkv} kv heads")
    if T % page_size:
        raise ValueError(f"pool_tokens {T} not a multiple of page {page_size}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table {tuple(page_table.shape)} must be (B, W)")
    if pos0.shape != (B,):
        raise ValueError(f"pos0 {tuple(pos0.shape)} must be ({B},)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None and (
        tuple(k_scale.shape) != (Hkv, T) or tuple(v_scale.shape) != (Hkv, T)
    ):
        raise ValueError(f"scale shape {tuple(k_scale.shape)} != {(Hkv, T)}")


def paged_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos0: torch.Tensor,
    *,
    page_size: int,
    window: int | None = None,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: gather the row's whole window
    through the table, mask by position, and take the kernel's hardened
    softmax (masked keys add exactly 0; a row that sees no key is 0)."""
    _validate(q, k_pool, v_pool, page_table, pos0, page_size, window,
              k_scale, v_scale)
    B, H, S, D = q.shape
    Hkv = k_pool.shape[0]
    G = H // Hkv
    P = page_size
    W = page_table.shape[1] * P
    dev = q.device
    j = torch.arange(W, device=dev)
    table = page_table.long()
    flat = table[:, j // P] * P + (j % P)[None, :]           # (B, W)
    K = k_pool[:, flat].float()                               # (Hkv, B, W, D)
    V = v_pool[:, flat].float()
    if k_scale is not None:
        K = K * k_scale[:, flat][..., None].float()
        V = V * v_scale[:, flat][..., None].float()
    K, V = K.permute(1, 0, 2, 3), V.permute(1, 0, 2, 3)      # (B, Hkv, W, D)
    qg = q.reshape(B, Hkv, G * S, D).float()
    s = torch.einsum("bhrd,bhtd->bhrt", qg, K) * _score_mult(D, scale)
    qpos = pos0.long()[:, None] + (torch.arange(G * S, device=dev) % S)[None]
    mask = j[None, None, :] <= qpos[:, :, None]               # (B, GS, W)
    if window is not None:
        mask &= j[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrt,bhtd->bhrd", p, V) / torch.where(l == 0, 1.0, l)
    return o.reshape(B, H, S, D).to(q.dtype)


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos0: torch.Tensor,
    *,
    page_size: int,
    window: int | None = None,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of a span of S queries per row over a paged KV pool.

    Args:
      q: ``(B, H, S, D)`` queries; query s of row b sits at ``pos0[b] + s``.
      k_pool / v_pool: ``(kv_heads, pool_tokens, D)`` pools, same dtype as
        q, or int8 codes with ``k_scale``/``v_scale`` ``(kv_heads,
        pool_tokens)`` f32.
      page_table: ``(B, W_pages)`` int32 — page ordinal → pool page.
      pos0: ``(B,)`` int32 span start positions.
      page_size: tokens per page.
      window: optional sliding-window width (``>= 1``).
      scale: score multiplier; ``1/sqrt(D)`` in f32 by default.

    Returns ``(B, H, S, D)`` in q's dtype. CPU tensors run the plain twin;
    CUDA tensors launch the kernel, which takes only contiguous tensors.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, page_table, pos0, page_size=page_size,
            window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    _validate(q, k_pool, v_pool, page_table, pos0, page_size, window,
              k_scale, v_scale)
    return _launch(q, k_pool, v_pool, page_table, pos0, page_size, window,
                   scale, k_scale, v_scale)


def count_launch(S: int, body_name: str, key: str) -> None:
    """Count one launch of span ``S`` on body ``body_name`` at shape ``key``."""
    global LAUNCHES
    with COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_S[S] = LAUNCHES_BY_S.get(S, 0) + 1
        LAUNCHES_BY_BODY[body_name] += 1
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _launch(q, k_pool, v_pool, page_table, pos0, page_size, window, scale,
            k_scale, v_scale):
    quant = k_scale is not None
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "page_table": page_table, "pos0": pos0}
    if quant:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"q dtype {q.dtype} not supported")
    want_kv = torch.int8 if quant else q.dtype
    if k_pool.dtype != want_kv or v_pool.dtype != want_kv:
        raise TypeError(f"pools must be {want_kv}, got {k_pool.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    if page_table.dtype != torch.int32 or pos0.dtype != torch.int32:
        raise TypeError("page_table and pos0 must be int32")
    B, H, S, D = q.shape
    Hkv, T, _ = k_pool.shape
    if not kernel_supports(D, k_pool.dtype):
        raise ValueError(
            f"head_dim {D} with {k_pool.dtype} pools: the kernel takes D <= "
            f"{_MAX_HEAD_DIM} with rows of whole 16-byte chunks"
        )
    out = torch.empty_like(q)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    none = ctypes.c_void_p(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        count_launch(S, body(H // Hkv, S, q.dtype),
                     shape_key(q.dtype, k_pool.dtype, B, H, Hkv, S, D, page_size,
                               page_table.shape[1]))
        code = lib.kft_paged_attention(
            ptr(q), ptr(k_pool), ptr(v_pool),
            ptr(k_scale) if quant else none, ptr(v_scale) if quant else none,
            ptr(page_table), ptr(pos0), ptr(out),
            B, H, Hkv, S, D, T, page_size, page_table.shape[1],
            0 if window is None else int(window), _score_mult(D, scale),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "paged_attention kernel")
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.kft_paged_attention
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
