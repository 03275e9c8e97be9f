"""Decoder LM in PyTorch: the port of ``kubeflow_tpu/models/transformer.py``.

Same architecture and parameter layout as the JAX ``TransformerLM``
(pre-norm RMSNorm blocks, RoPE, SwiGLU MLP, GQA, an f32 unembed), so
weights move across with ``models/bridge.py``. Two attention branches are
ported:

- the **no-cache** forward, through :func:`dispatch_attention`: the
  ``reference`` and ``flash`` strategies (``flash`` runs the CUDA kernel
  of ``ops/flash_attention.py`` on the card) and, under a mesh, ``ring``
  and ``ulysses`` over the ``seq`` axis (``parallel/``), which run the same
  kernels per hop or over the full sequence;
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

**Under a mesh** (``core/mesh.py`` ``mesh_context``, one rank a process)
the model computes on its rank's block of the batch: rows over the
batch axes, positions over ``seq`` (RoPE positions offset by the
rank's chunk). Parameters the trainer sharded (``kft_spec``,
``parallel/sharding.py``) are used Megatron-style: dims over ``fsdp`` are
gathered at use; q/k/v/up/gate sharded over ``model`` on their output
dim are column-parallel (local heads, local d_ff), o/down on their input
dim row-parallel with one sum over ``model``; a vocabulary sharded over
``model`` makes the embedding a masked lookup (or the ``onehot``
product) summed over ``model`` and the unembed return this rank's
vocabulary columns, which :func:`make_loss_fn` reduces as a
vocab-parallel cross-entropy. Every ``moe_every``-th block's FFN is the
MoE of ``parallel/expert.py``, whose aux and z losses the loss adds as
the JAX loss does. A cached forward (dense or paged) under a mesh is
tensor-parallel serving: the rank's heads write and read the rank's
share of the cache (``init_kv_cache``/``init_paged_kv_cache`` with
``kv_heads``), o/down sum over ``model`` as in training, and the
vocabulary columns are gathered over ``model`` so that every rank holds
the whole logits; ``seq`` is not split there. Every rank holds the whole
batch there, so an MoE block routes it as one token group
(``moe_ffn(local_tokens=True)``): capacity counts every token of the
forward, pad and dead rows included, as the JAX cached forward does.

Under ``remat`` each block of a no-cache forward that records gradients
runs inside ``torch.utils.checkpoint`` and is recomputed in the backward,
as ``nn.remat(Block)`` is in JAX: the attention kernel's forward then
launches twice a layer a step. ``dropout_rate`` is accepted and unused,
as in the JAX model.

:func:`make_init_fn` and :func:`make_loss_fn` are the trainer plumbing of
the JAX module (``make_init_fn``/``make_loss_fn``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, Mesh, current_mesh
from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)
from kubeflow_tpu_torch.ops.paged_attention import (
    dequantize_kv,
    paged_attention,
    quantize_kv,
)
from kubeflow_tpu_torch.parallel.expert import MoEConfig, moe_ffn
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention_local
from kubeflow_tpu_torch.parallel.sharding import gather_at_use
from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention_local

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
    #: recompute each block in the backward (``torch.utils.checkpoint``,
    #: non-reentrant) instead of keeping its activations
    remat: bool = False
    #: with ``remat``: None recomputes everything; "dots" keeps the outputs
    #: of the products without batch dims (``aten.mm``/``aten.addmm``, JAX's
    #: ``dots_with_no_batch_dims_saveable``) and recomputes the rest, the
    #: attention kernel included
    remat_policy: str | None = None
    moe_every: int = 0               # every Nth layer uses MoE FFN (0 = never)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    #: accepted and unused, as in the JAX model (nothing there reads it)
    dropout_rate: float = 0.0
    #: "gather": table lookup; "onehot": one-hot product (the JAX
    #: package's SPMD-clean form for a vocabulary-sharded table)
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
        if self.remat_policy not in (None, "dots"):
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in (None, 'dots')"
            )
        if self.remat_policy is not None and not self.remat:
            raise ValueError("remat_policy requires remat=True")
        if self.embed_impl not in ("gather", "onehot"):
            raise ValueError(
                f"embed_impl {self.embed_impl!r} not in ('gather', 'onehot')")
        if self.attn_window is not None:
            if self.attn_window < 1:
                raise ValueError(
                    f"attn_window must be >= 1, got {self.attn_window}"
                )
            if not self.causal:
                raise ValueError("attn_window requires causal=True")
            if self.attn_impl not in ("flash", "reference"):
                raise ValueError(
                    "attn_window supports attn_impl 'flash'/'reference' "
                    f"(got {self.attn_impl!r}); window + context parallelism "
                    "is not implemented"
                )
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
    """Token embedding from an f32 table, cast to ``dtype``: a lookup
    (``gather``) or the one-hot product (``onehot``, the table cast to
    ``dtype`` first, as the JAX ``oh @ table.astype(dtype)``). A table
    whose vocabulary is sharded over ``model`` looks up the ids in this
    rank's range and sums the rows over ``model``."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype,
                 device: torch.device, impl: str = "gather"):
        super().__init__()
        self.dtype = dtype
        self.impl = impl
        self.embedding = nn.Parameter(
            torch.empty(vocab_size, features, device=device)
        )

    def forward(self, tokens: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        table = gather_at_use(self.embedding, mesh)
        local = table.shape[0]
        sharded = mesh is not None and _split(self.embedding, Axis.MODEL)
        ids, keep = tokens, None
        if sharded:
            ids = tokens - mesh.index(Axis.MODEL) * local
            keep = (ids >= 0) & (ids < local)
            ids = torch.where(keep, ids, 0)
        if self.impl == "onehot":
            oh = F.one_hot(ids.long(), local).to(self.dtype)
            if keep is not None:
                oh = oh * keep[..., None].to(self.dtype)
            x = oh @ table.to(self.dtype)
        else:
            x = F.embedding(ids, table).to(self.dtype)
            if keep is not None:
                x = x * keep[..., None].to(self.dtype)
        if sharded:
            x = coll.psum(x, Axis.MODEL, mesh=mesh)
        return x


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


def _split(p, axis: str) -> bool:
    """Whether the trainer sharded parameter ``p`` over ``axis``."""
    spec = getattr(p, "kft_spec", None)
    return spec is not None and any(
        axis in ((e,) if isinstance(e, str) else tuple(e or ())) for e in spec)


class Dense(nn.Linear):
    """Bias-free projection with flax ``nn.Dense`` dtype semantics: the
    weight is stored in ``param_dtype`` and input and weight are cast to
    the compute ``dtype`` at every call (a no-op when the two agree).
    Under a mesh a sharded weight is gathered at use over its non-local
    axes, and one whose input dim is split over ``model`` is row-parallel:
    its partial output is summed over ``model``. (A weight whose output
    dim is split over ``model`` is column-parallel; its caller passes the
    input through ``collectives.enter`` once for all its projections.)"""

    def __init__(self, n_in: int, n_out: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__(n_in, n_out, bias=False, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        w = gather_at_use(self.weight, mesh)
        y = F.linear(x.to(dt), w.to(dt))
        if mesh is not None and w.shape[1] < self.in_features:
            y = coll.psum(y, Axis.MODEL, mesh=mesh)
        return y

    def column_parallel(self) -> bool:
        """Whether this weight's output dim is split over ``model``."""
        spec = getattr(self.weight, "kft_spec", None)
        return spec is not None and Axis.MODEL in (
            (spec[0],) if isinstance(spec[0], str) else tuple(spec[0] or ()))


def _linear(cfg: TransformerConfig, n_in: int, n_out: int,
            device: torch.device, param_dtype: torch.dtype) -> Dense:
    return Dense(n_in, n_out, dtype=cfg.dtype, param_dtype=param_dtype,
                 device=device)


def _dots_saveable(ctx, op, *args, **kwargs):  # noqa: ARG001
    """The ``"dots"`` remat policy: keep the products without batch dims,
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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


def dispatch_attention(q, k, v, cfg: TransformerConfig, *, segment_ids=None,
                       mesh: Mesh | None = None):
    """Route to the configured attention strategy. q/k/v: (B, H, S, D)
    with kv heads already repeated; under a mesh, this rank's block
    (local rows, heads and sequence chunk). ``ring`` and ``ulysses``
    raise the JAX error outside a mesh; ``flash`` and ``reference``
    cannot shard ``seq``."""
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    if (cfg.attn_impl in ("flash", "reference") and mesh is not None
            and mesh.size(Axis.SEQ) > 1):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} cannot shard the seq axis; use "
            "'ring' or 'ulysses' for sequence parallelism"
        )
    if cfg.attn_impl == "reference":
        return reference_attention(
            q, k, v, causal=cfg.causal, window=cfg.attn_window,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        )
    if cfg.attn_impl != "flash" and mesh is None:
        raise ValueError(
            f"attn_impl {cfg.attn_impl!r} needs a mesh context (mesh_context)"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if cfg.attn_impl == "flash":
        return flash_attention(
            q, k, v, causal=cfg.causal, window=cfg.attn_window,
            q_segment_ids=seg, kv_segment_ids=seg,
        )
    local = ring_attention_local if cfg.attn_impl == "ring" \
        else ulysses_attention_local
    return local(q, k, v, axis_name=Axis.SEQ, causal=cfg.causal,
                 segment_ids=seg, mesh=mesh)


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
        mesh: Mesh | None = None,
    ):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        groups = H // Hkv
        if mesh is not None and self.q_proj.column_parallel():
            # column-parallel q/k/v: this rank's heads; the input's
            # gradient is summed over model once for all three
            if not (self.k_proj.column_parallel() and self.v_proj.column_parallel()):
                raise NotImplementedError(
                    "q_proj is split over 'model' but k_proj/v_proj are not")
            x = coll.enter(x, Axis.MODEL, mesh=mesh)
            H, Hkv = H // mesh.size(Axis.MODEL), Hkv // mesh.size(Axis.MODEL)
        q = self.q_proj(x, mesh).view(B, S, H, D).transpose(1, 2)
        k = self.k_proj(x, mesh).view(B, S, Hkv, D).transpose(1, 2)
        v = self.v_proj(x, mesh).view(B, S, Hkv, D).transpose(1, 2)
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
            o = dispatch_attention(q, k, v, cfg, segment_ids=segment_ids,
                                   mesh=mesh)
        o = o.transpose(1, 2).reshape(B, S, H * D).to(cfg.dtype)
        out = self.o_proj(o, mesh)
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
        o = _grouped_cache_attention(q, K, V, mask, q.shape[1] // Hkv)
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
        groups = q.shape[1] // Hkv
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

    def forward(self, x, mesh: Mesh | None = None):
        if mesh is not None and self.up_proj.column_parallel():
            x = coll.enter(x, Axis.MODEL, mesh=mesh)
        gate, up = self.gate_proj(x, mesh), self.up_proj(x, mesh)
        return self.down_proj(F.silu(gate) * up, mesh)


class Experts(nn.Module):
    """The MoE FFN's weights in the JAX layout (``router_kernel``
    ``(d_model, E)``, ``up_kernel`` ``(E, d_model, F)``, ``down_kernel``
    ``(E, F, d_model)``), applied by ``parallel/expert.py`` ``moe_ffn``."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        moe, d = cfg.moe, cfg.d_model
        self.router_kernel = nn.Parameter(
            torch.empty(d, moe.num_experts, device=device))
        self.up_kernel = nn.Parameter(
            torch.empty(moe.num_experts, d, moe.expert_dim, device=device))
        self.down_kernel = nn.Parameter(
            torch.empty(moe.num_experts, moe.expert_dim, d, device=device))

    def forward(self, y, mesh: Mesh | None = None, moe_stats=None,
                local_tokens: bool = False):
        """``local_tokens``: every rank holds the whole batch (a cached
        forward under a mesh), routed as one token group."""
        B, S, d = y.shape
        out, aux, stats = moe_ffn(
            y.reshape(B * S, d), gather_at_use(self.router_kernel, mesh),
            gather_at_use(self.up_kernel, mesh),
            gather_at_use(self.down_kernel, mesh), self.cfg.moe,
            rows=B, mesh=mesh, local_tokens=local_tokens)
        if moe_stats is not None:
            moe_stats.append((aux, stats))
        return out.reshape(B, S, d)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype, use_moe: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device, param_dtype)
        self.ln2 = RMSNorm(cfg.d_model, device)
        if use_moe:
            self.experts = Experts(cfg, device)
        else:
            self.mlp = Mlp(cfg, device, param_dtype)

    def forward(self, x, positions, segment_ids=None, layer_cache=None,
                mesh: Mesh | None = None, moe_stats=None, **cached):
        new_cache = None
        if layer_cache is not None:
            h, new_cache = self.attn(
                self.ln1(x), positions, segment_ids, layer_cache=layer_cache,
                mesh=mesh, **cached,
            )
        else:
            h = self.attn(self.ln1(x), positions, segment_ids, mesh=mesh)
        x = x + h
        if hasattr(self, "experts"):
            # a cached forward serves: its batch is whole on every rank
            out = x + self.experts(self.ln2(x), mesh, moe_stats,
                                   local_tokens=layer_cache is not None)
        else:
            out = x + self.mlp(self.ln2(x), mesh)
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
    each layer's quantization-error sums. ``moe_stats`` (a list, with or
    without a cache) collects each MoE block's ``(aux, stats)``.
    Parameters are allocated uninitialized on ``device`` (``None`` = the
    CUDA card): load a state dict or call :func:`init_weights`.
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
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, cfg.dtype, dev,
                               impl=cfg.embed_impl)
        if not cfg.use_rope:
            self.pos_embedding = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, device=dev)
            )
        self.layers = nn.ModuleList(
            Block(cfg, dev, param_dtype,
                  use_moe=cfg.moe_every > 0 and (i + 1) % cfg.moe_every == 0)
            for i in range(cfg.n_layers)
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
        moe_stats=None,
    ):
        cfg = self.cfg
        B, S = tokens.shape
        mesh = current_mesh()
        if cache is not None and mesh is not None and mesh.size(Axis.SEQ) > 1:
            raise NotImplementedError(
                "a cached forward under a mesh splits heads over 'model'; "
                "the seq axis is not split in serving")
        if positions is None:
            ar = torch.arange(S, device=tokens.device)
            if torch.is_tensor(cache_index) and cache_index.ndim == 1:
                positions = cache_index[:, None] + ar
            else:
                start = 0 if cache_index is None else int(cache_index)
                if mesh is not None and cache is None:
                    start = mesh.index(Axis.SEQ) * S  # this rank's chunk
                positions = (start + ar).expand(B, S)
        x = self.embed(tokens, mesh)
        if not cfg.use_rope:
            x = x + self.pos_embedding[positions].to(cfg.dtype)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        context_fn = noop_context_fn
        if cfg.remat_policy == "dots":
            context_fn = functools.partial(
                create_selective_checkpoint_contexts, _dots_saveable)
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
                    mesh=mesh, moe_stats=moe_stats, **cached,
                )
            elif remat:
                x = checkpoint(block, x, positions, segment_ids,
                               use_reentrant=False, context_fn=context_fn,
                               mesh=mesh, moe_stats=moe_stats)
            else:
                x = block(x, positions, segment_ids, mesh=mesh,
                          moe_stats=moe_stats)
        h = self.ln_f(x).float()
        if mesh is None:
            logits = self.unembed(h)
        else:
            w = gather_at_use(self.unembed.weight, mesh)
            split = _split(self.unembed.weight, Axis.MODEL)
            if split:
                # this rank's vocabulary columns (make_loss_fn reduces them)
                h = coll.enter(h, Axis.MODEL, mesh=mesh)
            logits = F.linear(h, w)
            if split and cache is not None:
                # serving: every rank's sampler sees the whole vocabulary
                logits = coll._all_gather(logits.contiguous(), mesh,
                                          Axis.MODEL, logits.dim() - 1)
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
    kv_heads: int | None = None,
) -> dict:
    """Zeroed DENSE decode cache: one ``(batch, kv_heads, max_len,
    head_dim)`` K and V per layer in ``dtype`` (default the model's), so
    GQA configs pay for kv_heads, not n_heads. ``kv_heads`` is the heads
    this rank holds (default all; a tensor-parallel rank's share)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (batch, kv_heads or cfg.kv_heads, max_len, cfg.head_dim)
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
    kv_heads: int | None = None,
) -> dict:
    """Zeroed PAGED cache: one flat (kv_heads, pool_tokens, head_dim) K and
    V per layer, shared by every row through a block table. ``kv_quant=
    "int8"`` stores int8 codes plus (kv_heads, pool_tokens) f32
    ``k_scale``/``v_scale``. ``kv_heads`` is the heads this rank holds
    (default all; a tensor-parallel rank's share)."""
    dev = resolve_device(device)
    shape = (kv_heads or cfg.kv_heads, pool_tokens, cfg.head_dim)
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
            fan_in = p.shape[0] if name.endswith("router_kernel") else p.shape[1]
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


def _vocab_parallel_ce(logits, targets, mesh):
    """Per-token cross-entropy and argmax-hit of logits whose vocabulary
    is split over ``model`` (this rank holds columns ``[i*V_l,
    (i+1)*V_l)``): the max and the sum of exponentials are reduced over
    ``model``, the target's logit comes from the rank that holds it."""
    V_l = logits.shape[-1]
    start = mesh.index(Axis.MODEL) * V_l
    local_max = logits.detach().amax(-1, keepdim=True)
    m = coll.pmax(local_max, Axis.MODEL, mesh=mesh)
    sumexp = coll.psum(torch.exp(logits - m).sum(-1), Axis.MODEL, mesh=mesh)
    t = targets - start
    mine = (t >= 0) & (t < V_l)
    picked = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    target_logit = coll.psum(torch.where(mine, picked, 0.0), Axis.MODEL, mesh=mesh)
    ce = torch.log(sumexp) + m[..., 0] - target_logit
    # global argmax, first index on ties: the largest local max wins, the
    # lower rank (lower vocabulary ids) on equal maxima
    arg = logits.detach().argmax(-1) + start
    both = coll._all_gather(torch.stack([local_max[..., 0], arg.float()], -1),
                            mesh, Axis.MODEL, -1, tiled=False)
    vals, ids = both[..., 0, :], both[..., 1, :]
    best = torch.argmax(vals, dim=-1, keepdim=True)   # first of equal maxima
    hit = torch.gather(ids, -1, best)[..., 0].long() == targets
    return ce, hit


def make_loss_fn():
    """``(model, {"inputs", "targets"}, key) -> (loss, metrics)``:
    the mean token cross-entropy of the f32 logits (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``) and the
    argmax accuracy (first index on ties, as ``jnp.argmax``), plus, with
    MoE layers, their aux and z losses as ``moe_aux`` (added to the loss,
    as the JAX function adds them) and the mean ``moe_dropped_frac``.

    Under a mesh each rank scores its block of tokens and the loss and
    metrics are the global means, by sums over the token axes whose
    gradient passes through unchanged: every rank returns the same loss,
    and its backward yields its share of the global gradient. A
    vocabulary split over ``model`` is reduced as a vocab-parallel
    cross-entropy."""

    def loss_fn(model: TransformerLM, batch, key=None):
        del key  # the model draws nothing
        targets = batch["targets"].long()
        moe: list = []
        logits = model(batch["inputs"], moe_stats=moe)
        mesh = current_mesh()
        vocab_split = logits.shape[-1] < model.cfg.vocab_size
        if not vocab_split and (mesh is None or mesh.group(Axis.TOKENS) is None):
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1))
            acc = (logits.argmax(-1) == targets).float().mean()
        else:
            if vocab_split:
                ce, hit = _vocab_parallel_ce(logits, targets, mesh)
            else:
                ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     targets.reshape(-1), reduction="none")
                hit = logits.argmax(-1) == targets
            n = targets.numel() * mesh.size(Axis.TOKENS)
            loss = _token_sum(ce.sum(), mesh) / n
            acc = _token_sum(hit.float().sum(), mesh) / n
        metrics = {"lm_loss": loss.detach()}
        if moe:
            aux = sum(a for a, _ in moe)
            loss = loss + aux
            metrics["moe_aux"] = aux.detach()
            metrics["moe_dropped_frac"] = (
                sum(st["moe_dropped_frac"] for _, st in moe) / len(moe)).detach()
        metrics["accuracy"] = acc
        return loss, metrics

    return loss_fn


def _token_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group(Axis.TOKENS) is None:
        return x
    return coll.psum(x, Axis.TOKENS, mesh=mesh)
