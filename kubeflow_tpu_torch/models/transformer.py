"""Decoder LM in PyTorch: the port of ``kubeflow_tpu/models/transformer.py``.

Same architecture and parameter layout as the JAX ``TransformerLM``
(pre-norm RMSNorm blocks, RoPE, SwiGLU MLP, GQA, an f32 unembed), so
weights move across with ``models/bridge.py``. Two attention branches are
ported:

- the **no-cache** forward, through :func:`dispatch_attention` with the
  single-device ``reference`` and ``flash`` strategies (``flash`` runs the
  CUDA kernel of ``ops/flash_attention.py`` on the card);
- the **dense** cache branch of ``make_generate_fn`` and the dense
  serving engine: this call's keys/values are written in place into a
  ``(B, kv_heads, max_len, head_dim)`` cache from :func:`init_kv_cache`
  at slot ``cache_index`` (one slot for every row, or one a row), and
  the query attends every slot through the default causal mask over
  absolute slots (with ``attn_window``) or the caller's ``kv_mask``, by
  torch ops (the JAX branch is XLA einsums, no Pallas kernel);
- the **paged** branch the serving engine uses: this call's keys/values
  are written into a flat ``(kv_heads, pool_tokens, head_dim)`` pool
  through a block table (in place — the pool is engine-owned state), then
  read back either by an index gather plus masked softmax (``gather``) or
  by the paged-attention CUDA kernel (``kernel``), for ``kv_quant``
  ``none`` and ``int8``.

Projections are :class:`Dense` layers: their weights are stored in
``param_dtype`` and cast to ``cfg.dtype`` at every call, as the JAX
``nn.Dense(dtype=cfg.dtype)`` casts its f32 ``param_dtype`` kernel. The
default ``param_dtype`` is ``cfg.dtype`` (the serving layout: the cast is
deterministic, so storing the cast weight gives the same result);
training builds with ``param_dtype=torch.float32`` so that optimizer
updates land on f32 master weights. Norm scales, the embedding table and
the unembed are f32 in both layouts, as in the JAX package.

:func:`make_init_fn` and :func:`make_loss_fn` are the trainer plumbing of
the JAX module (``make_init_fn``/``make_loss_fn``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)
from kubeflow_tpu_torch.ops.paged_attention import (
    dequantize_kv,
    paged_attention,
    quantize_kv,
)

ATTN_IMPLS = ("reference", "flash", "ring", "ulysses")
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 512
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    #: GQA: number of key/value heads (None = n_heads, plain MHA)
    n_kv_heads: int | None = None
    d_ff: int = 1024
    max_seq_len: int = 2048
    causal: bool = True
    use_rope: bool = True
    dtype: torch.dtype = torch.float32
    attn_impl: str = "flash"
    #: sliding-window attention (causal only): each position attends to
    #: the previous ``attn_window`` tokens
    attn_window: int | None = None
    remat: bool = False
    moe_every: int = 0
    dropout_rate: float = 0.0
    embed_impl: str = "gather"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}"
            )
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    def validate(self) -> None:
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in {ATTN_IMPLS}")
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl {self.attn_impl!r} is not ported yet "
                "(ROADMAP queue 1 item 10, distributed and parallel)"
            )
        if self.moe_every:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP queue 1 item 10)"
            )
        if self.remat or self.dropout_rate:
            raise NotImplementedError(
                "remat and dropout are not ported yet (ROADMAP queue 1 "
                "item 9, the rest of the training path)"
            )
        if self.embed_impl != "gather":
            raise NotImplementedError(
                f"embed_impl {self.embed_impl!r} is not ported yet "
                "(ROADMAP queue 1 item 10); 'gather' is"
            )
        if self.attn_window is not None:
            if self.attn_window < 1:
                raise ValueError(
                    f"attn_window must be >= 1, got {self.attn_window}"
                )
            if not self.causal:
                raise ValueError("attn_window requires causal=True")
        if self.n_kv_heads is not None and self.n_kv_heads < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got {self.n_kv_heads}")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} must be a multiple of n_kv_heads "
                f"{self.kv_heads}"
            )


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #

class Embedding(nn.Module):
    """Token embedding: a gather from an f32 table, cast to ``dtype``."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab_size, features, device=device)
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         base: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings; x: (B, H, S, D), positions: (B, S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(base, dtype=torch.float32), exps)
    angles = positions[:, None, :, None].float() * freq   # (B, 1, S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, features: int, device: torch.device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.scale).to(x.dtype)


class Dense(nn.Linear):
    """Bias-free projection with flax ``nn.Dense`` dtype semantics: the
    weight is stored in ``param_dtype`` and input and weight are cast to
    the compute ``dtype`` at every call (a no-op when the two agree)."""

    def __init__(self, n_in: int, n_out: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__(n_in, n_out, bias=False, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


def _linear(cfg: TransformerConfig, n_in: int, n_out: int,
            device: torch.device, param_dtype: torch.dtype) -> Dense:
    return Dense(n_in, n_out, dtype=cfg.dtype, param_dtype=param_dtype,
                 device=device)


def _grouped_cache_attention(q, K, V, mask, groups):
    """Cache-side attention in grouped (GQA) form: q (B, H, S, D) against
    an Hkv-head cache view K/V (B, Hkv, T, D) with mask (B, S, T); the
    repeated n_heads view of the cache is never materialized."""
    B, H, S, D = q.shape
    Hkv = K.shape[1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    qg = q.reshape(B, Hkv, groups, S, D)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), K.float()) * scale
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(V.dtype)
    o = torch.einsum("bhgst,bhtd->bhgsd", probs, V)
    return o.reshape(B, H, S, D)


def dispatch_attention(q, k, v, cfg: TransformerConfig, *, segment_ids=None):
    """Route to the configured attention strategy. q/k/v: (B, H, S, D)
    with kv heads already repeated. Only the single-device strategies are
    ported; ``ring``/``ulysses`` are rejected by ``cfg.validate()``."""
    if cfg.attn_impl == "reference":
        return reference_attention(
            q, k, v, causal=cfg.causal, window=cfg.attn_window,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        )
    if cfg.attn_impl != "flash":
        raise NotImplementedError(
            f"attn_impl {cfg.attn_impl!r} is not ported yet "
            "(ROADMAP queue 1 item 10)"
        )
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=cfg.causal,
        window=cfg.attn_window, q_segment_ids=seg, kv_segment_ids=seg,
    )


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.q_proj = _linear(cfg, cfg.d_model, H * D, device, param_dtype)
        self.k_proj = _linear(cfg, cfg.d_model, Hkv * D, device, param_dtype)
        self.v_proj = _linear(cfg, cfg.d_model, Hkv * D, device, param_dtype)
        self.o_proj = _linear(cfg, H * D, cfg.d_model, device, param_dtype)

    def forward(
        self, x, positions, segment_ids=None, layer_cache=None,
        cache_index=None, kv_mask=None,
        page_table=None, page_size=None, page_write_ok=None,
        paged_attn_impl="gather", kv_quant="none", quant_stats=None,
    ):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        groups = H // Hkv
        q = self.q_proj(x).view(B, S, H, D).transpose(1, 2)
        k = self.k_proj(x).view(B, S, Hkv, D).transpose(1, 2)
        v = self.v_proj(x).view(B, S, Hkv, D).transpose(1, 2)
        if cfg.use_rope:
            q, k = rope(q, positions), rope(k, positions)
        new_cache = None
        if page_table is not None:
            o, new_cache = self._paged(
                q, k, v, positions, layer_cache, page_table, page_size,
                page_write_ok, paged_attn_impl, kv_quant, quant_stats,
            )
        elif layer_cache is not None:
            o, new_cache = self._dense(q, k, v, layer_cache, cache_index,
                                       kv_mask)
        else:
            if groups > 1:
                k = k.repeat_interleave(groups, dim=1)
                v = v.repeat_interleave(groups, dim=1)
            o = dispatch_attention(q, k, v, cfg, segment_ids=segment_ids)
        o = o.transpose(1, 2).reshape(B, S, H * D).to(cfg.dtype)
        out = self.o_proj(o)
        if layer_cache is not None:
            return out, new_cache
        return out

    def _dense(self, q, k, v, layer_cache, cache_index, kv_mask):
        """DENSE decode/prefill: write this call's keys/values into the
        ``(B, kv_heads, T, D)`` cache IN PLACE at slots ``[cache_index,
        cache_index + S)`` (a scalar: every row at that slot; ``(B,)``:
        each row at its own), then attend all T slots. As JAX's
        ``dynamic_update_slice``, a write start is clamped into ``[0, T -
        S]``. With no ``kv_mask`` the mask is causal over absolute slots
        (slot == token position) with ``attn_window``; a caller's
        ``(B, T)`` mask applies to every query, a ``(B, S, T)`` one per
        query (the speculative verify span), and then the caller owns
        the window."""
        cfg = self.cfg
        B, Hkv, S, D = k.shape
        K, V = layer_cache["k"], layer_cache["v"]
        T = K.shape[2]
        dev = q.device
        per_row = torch.is_tensor(cache_index) and cache_index.ndim == 1
        if per_row:
            span = torch.arange(S, device=dev)
            slots = cache_index.clamp(0, T - S)[:, None] + span      # (B, S)
            idx = slots[:, None, :, None].expand(B, Hkv, S, D)
            K.scatter_(2, idx, k.to(K.dtype))
            V.scatter_(2, idx, v.to(V.dtype))
        else:
            start = min(max(int(cache_index), 0), T - S)
            K[:, :, start:start + S] = k.to(K.dtype)
            V[:, :, start:start + S] = v.to(V.dtype)
        if kv_mask is not None:
            kvm = kv_mask if kv_mask.ndim == 3 else kv_mask[:, None, :]
            mask = kvm.expand(B, S, T)
        else:
            span = torch.arange(S, device=dev)
            kpos = torch.arange(T, device=dev)
            if per_row:
                qpos = cache_index[:, None] + span                   # (B, S)
            else:
                qpos = (int(cache_index) + span)[None, :].expand(B, S)
            mask = kpos[None, None, :] <= qpos[:, :, None]           # (B, S, T)
            if cfg.attn_window is not None:
                mask = mask & (kpos[None, None, :]
                               > qpos[:, :, None] - cfg.attn_window)
        o = _grouped_cache_attention(q, K, V, mask, cfg.n_heads // Hkv)
        return o, layer_cache

    def _paged(self, q, k, v, positions, layer_cache, page_table, P,
               page_write_ok, paged_attn_impl, kv_quant, quant_stats):
        """PAGED decode/prefill: write this call's keys/values into the
        pool IN PLACE through the block table (row b's token j lives at
        ``table[b, j // P] * P + j % P``), then read the row's window.
        Pad positions and dead rows write to the scratch page 0. Under
        int8, a ``quant_stats`` list receives this layer's ``[Σ|deq(kq) -
        k| + Σ|deq(vq) - v|, Σ|k| + Σ|v|]`` over every written position
        (the JAX model's sown ``quant_stats``)."""
        cfg = self.cfg
        B, Hkv, S, D = k.shape
        groups = cfg.n_heads // Hkv
        W = page_table.shape[1] * P
        table = page_table.long()
        # clamped lookup: only rows with page_write_ok False can reach
        # past the table (dead rows), and their writes go to scratch
        ordinal = torch.clamp(positions // P, 0, table.shape[1] - 1)
        flat_w = torch.gather(table, 1, ordinal) * P + positions % P  # (B, S)
        if page_write_ok is not None:
            scratch = torch.arange(B * S, device=k.device).reshape(B, S) % P
            flat_w = torch.where(page_write_ok, flat_w, scratch)
        idx = flat_w.reshape(-1)

        def rows(t):  # (B, Hkv, S, ...) -> (Hkv, B*S, ...)
            return t.transpose(0, 1).reshape(Hkv, B * S, *t.shape[3:])

        if kv_quant == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            layer_cache["k"][:, idx] = rows(kq)
            layer_cache["v"][:, idx] = rows(vq)
            layer_cache["k_scale"][:, idx] = rows(ks)
            layer_cache["v_scale"][:, idx] = rows(vs)
            if quant_stats is not None:
                kf, vf = k.float(), v.float()
                err = ((dequantize_kv(kq, ks) - kf).abs().sum()
                       + (dequantize_kv(vq, vs) - vf).abs().sum())
                quant_stats.append(torch.stack(
                    [err, kf.abs().sum() + vf.abs().sum()]))
        elif kv_quant == "none":
            layer_cache["k"][:, idx] = rows(k.to(layer_cache["k"].dtype))
            layer_cache["v"][:, idx] = rows(v.to(layer_cache["v"].dtype))
        else:
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        K, V = layer_cache["k"], layer_cache["v"]
        Ks, Vs = layer_cache.get("k_scale"), layer_cache.get("v_scale")
        if paged_attn_impl == "kernel":
            # contiguous span positions (positions[b] == pos0[b] + arange(S))
            # hold for every engine caller: decode steps and prefill pieces
            o = paged_attention(
                q.contiguous(), K, V, page_table.to(torch.int32).contiguous(),
                positions[:, 0].to(torch.int32).contiguous(),
                page_size=P, window=cfg.attn_window, k_scale=Ks, v_scale=Vs,
            )
        elif paged_attn_impl == "gather":
            j = torch.arange(W, device=q.device)
            flat_r = (table[:, j // P] * P + (j % P)[None, :]).reshape(-1)
            Kg = K[:, flat_r].reshape(Hkv, B, W, D).transpose(0, 1)
            Vg = V[:, flat_r].reshape(Hkv, B, W, D).transpose(0, 1)
            if kv_quant == "int8":
                Ksg = Ks[:, flat_r].reshape(Hkv, B, W).transpose(0, 1)
                Vsg = Vs[:, flat_r].reshape(Hkv, B, W).transpose(0, 1)
                Kg, Vg = dequantize_kv(Kg, Ksg), dequantize_kv(Vg, Vsg)
            mask = j[None, None, :] <= positions[:, :, None]     # (B, S, W)
            if cfg.attn_window is not None:
                mask &= j[None, None, :] > positions[:, :, None] - cfg.attn_window
            o = _grouped_cache_attention(q, Kg, Vg, mask, groups)
        else:
            raise ValueError(f"unknown paged_attn_impl {paged_attn_impl!r}")
        return o, layer_cache


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.up_proj = _linear(cfg, cfg.d_model, cfg.d_ff, device, param_dtype)
        self.gate_proj = _linear(cfg, cfg.d_model, cfg.d_ff, device, param_dtype)
        self.down_proj = _linear(cfg, cfg.d_ff, cfg.d_model, device, param_dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device, param_dtype)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = Mlp(cfg, device, param_dtype)

    def forward(self, x, positions, segment_ids=None, layer_cache=None, **cached):
        new_cache = None
        if layer_cache is not None:
            h, new_cache = self.attn(
                self.ln1(x), positions, segment_ids, layer_cache=layer_cache,
                **cached,
            )
        else:
            h = self.attn(self.ln1(x), positions, segment_ids)
        x = x + h
        out = x + self.mlp(self.ln2(x))
        if layer_cache is not None:
            return out, new_cache
        return out


class TransformerLM(nn.Module):
    """Decoder LM (causal=True) or encoder (causal=False).

    ``forward(tokens) -> logits`` scores a batch with no cache. Dense
    serving passes a cache from :func:`init_kv_cache` plus
    ``cache_index`` (and optionally ``kv_mask``) and gets ``(logits,
    cache)``: prefill writes slots ``[idx, idx + S)``, decode steps pass
    S=1, and the cache is updated in place. Paged
    serving passes a pool from :func:`init_paged_kv_cache` plus
    ``page_table``/``page_size``/``page_write_ok`` and explicit
    ``positions`` and gets ``(logits, cache)``; the pool is updated in
    place, and under ``kv_quant="int8"`` a ``quant_stats`` list collects
    each layer's quantization-error sums. Parameters are allocated
    uninitialized on ``device`` (``None`` = the CUDA card): load a state
    dict or call :func:`init_weights`.
    ``param_dtype`` is the storage dtype of the projections (flax
    ``Dense.param_dtype``); ``None`` stores them in ``cfg.dtype``.
    """

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dev = resolve_device(device)
        param_dtype = cfg.dtype if param_dtype is None else param_dtype
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, cfg.dtype, dev)
        if not cfg.use_rope:
            self.pos_embedding = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, device=dev)
            )
        self.layers = nn.ModuleList(
            Block(cfg, dev, param_dtype) for _ in range(cfg.n_layers)
        )
        self.ln_f = RMSNorm(cfg.d_model, dev)
        self.unembed = nn.Linear(
            cfg.d_model, cfg.vocab_size, bias=False, device=dev,
            dtype=torch.float32,
        )

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    def forward(
        self, tokens, *, segment_ids=None, positions=None, cache=None,
        cache_index=None, kv_mask=None,
        page_table=None, page_size=None, page_write_ok=None,
        paged_attn_impl="gather", kv_quant="none", quant_stats=None,
    ):
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            ar = torch.arange(S, device=tokens.device)
            if torch.is_tensor(cache_index) and cache_index.ndim == 1:
                positions = cache_index[:, None] + ar
            else:
                start = 0 if cache_index is None else int(cache_index)
                positions = (start + ar).expand(B, S)
        x = self.embed(tokens)
        if not cfg.use_rope:
            x = x + self.pos_embedding[positions].to(cfg.dtype)
        cached = dict(
            cache_index=cache_index, kv_mask=kv_mask,
            page_table=page_table, page_size=page_size,
            page_write_ok=page_write_ok, paged_attn_impl=paged_attn_impl,
            kv_quant=kv_quant, quant_stats=quant_stats,
        )
        for i, block in enumerate(self.layers):
            if cache is not None:
                name = f"layers_{i}"
                x, cache[name] = block(
                    x, positions, segment_ids, layer_cache=cache[name],
                    **cached,
                )
            else:
                x = block(x, positions, segment_ids)
        logits = self.unembed(self.ln_f(x).float())
        if cache is not None:
            return logits, cache
        return logits


def init_kv_cache(
    cfg: TransformerConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype | None = None,
    *,
    device=None,
) -> dict:
    """Zeroed DENSE decode cache: one ``(batch, kv_heads, max_len,
    head_dim)`` K and V per layer in ``dtype`` (default the model's), so
    GQA configs pay for kv_heads, not n_heads."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {
        f"layers_{i}": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        for i in range(cfg.n_layers)
    }


def init_paged_kv_cache(
    cfg: TransformerConfig,
    pool_tokens: int,
    dtype: torch.dtype | None = None,
    kv_quant: str = "none",
    *,
    device=None,
) -> dict:
    """Zeroed PAGED cache: one flat (kv_heads, pool_tokens, head_dim) K and
    V per layer, shared by every row through a block table. ``kv_quant=
    "int8"`` stores int8 codes plus (kv_heads, pool_tokens) f32
    ``k_scale``/``v_scale``."""
    dev = resolve_device(device)
    shape = (cfg.kv_heads, pool_tokens, cfg.head_dim)
    if kv_quant == "int8":
        return {
            f"layers_{i}": {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:2], device=dev),
                "v_scale": torch.zeros(shape[:2], device=dev),
            }
            for i in range(cfg.n_layers)
        }
    if kv_quant != "none":
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    dtype = dtype or cfg.dtype
    return {
        f"layers_{i}": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        for i in range(cfg.n_layers)
    }


@torch.no_grad()
def init_weights(model: TransformerLM, seed: int) -> TransformerLM:
    """Random weights from ``seed``, drawn on the model's device: fan-in
    scaled normals for the embedding and projections, ones for the norm
    scales (the JAX initializers' scales; the streams differ)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name == "pos_embedding":
            p.normal_(0.0, 0.02, generator=gen)
        else:
            fan_in = p.shape[1]
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
    return model


# --------------------------------------------------------------------------- #
# Trainer plumbing
# --------------------------------------------------------------------------- #

def make_init_fn(cfg: TransformerConfig):
    """``init_params(seed, device) -> TransformerLM`` for the trainer: the
    model built on ``device`` with f32 master weights
    (``param_dtype=torch.float32``, compute in ``cfg.dtype``) and drawn by
    :func:`init_weights` from ``seed``."""

    def init_params(seed: int, device) -> TransformerLM:
        model = TransformerLM(cfg, device=device, param_dtype=torch.float32)
        return init_weights(model, seed)

    return init_params


def make_loss_fn():
    """``(model, {"inputs", "targets"}, generator) -> (loss, metrics)``:
    the mean token cross-entropy of the f32 logits (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``) and the
    argmax accuracy (first index on ties, as ``jnp.argmax``). MoE layers,
    whose aux loss the JAX function adds, raise in ``cfg.validate()``."""

    def loss_fn(model: TransformerLM, batch, generator=None):
        del generator  # no dropout in the ported model
        targets = batch["targets"].long()
        logits = model(batch["inputs"])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        acc = (logits.argmax(-1) == targets).float().mean()
        return loss, {"lm_loss": loss.detach(), "accuracy": acc}

    return loss_fn
