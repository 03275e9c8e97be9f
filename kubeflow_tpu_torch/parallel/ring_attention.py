"""Ring attention over the ``seq`` axis: the port of
``kubeflow_tpu/parallel/ring_attention.py``.

Sequence-sharded q stays put; the k/v shards rotate around the axis ring
(``core/collectives.py`` ring shifts) and each rank merges its per-hop
partial results with online-softmax algebra (:func:`_merge`, plain torch
as in the reference). The per-hop work is the port's flash kernel
(``ops/flash_attention.py``) with ``return_residuals=True``; the hops keep
the reference's static structure: hop 0 is the causal diagonal, a later
hop is a full non-causal block where the shard came from an earlier rank
(``src < me``) and is skipped (no launch) otherwise, and ``kv_seg`` rides
the ring with k and v. On seq rank j a causal sweep launches the forward
kernel 1 + j times.

The backward is a second sweep: per hop the flash backward kernels
(``flash_attention_bwd``) run against the GLOBAL merged ``o`` and ``lse``
the forward saved, so each hop yields that kv shard's exact share of the
softmax gradient; dq accumulates at home in f32, dk/dv accumulate in f32
on the rotating shard and take one more hop to arrive home. Both sweeps
live in one ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, Mesh, current_mesh
from kubeflow_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
)

#: hops run by ring sweeps in this process (forward and backward), the
#: counterpart of the kernels' launch counters for the ring's own work
HOPS = 0


def _merge(o, lse, o_t, lse_t):
    """Online-softmax merge of normalized partials (o, lse)."""
    lse_new = torch.logaddexp(lse, lse_t)
    w = torch.exp(lse - lse_new)[..., None]
    w_t = torch.exp(lse_t - lse_new)[..., None]
    return o * w + o_t * w_t.to(o.dtype), lse_new


def _hops(n: int, me: int, causal: bool) -> dict[int, bool]:
    """``{step: hop_causal}`` of the hops that run a kernel (at step s
    this rank holds the shard of rank ``(me - s) % n``): every hop
    without ``causal``, else the diagonal and the shards of earlier
    ranks."""
    return {step: causal and step == 0 for step in range(n)
            if not causal or step == 0 or (me - step) % n < me}


def _seg_kw(q_seg, kv_seg):
    if q_seg is None:
        return {}
    return {"q_segment_ids": q_seg, "kv_segment_ids": kv_seg}


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, axis, causal, scale):
        global HOPS
        n, me = mesh.size(axis), mesh.index(axis)
        runs = _hops(n, me, causal)
        q, k0, v0 = q.contiguous(), k.contiguous(), v.contiguous()
        k, v, kv_seg = k0, v0, seg
        o = torch.zeros_like(q)
        lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        for step in range(n):
            if step in runs:
                o_t, lse_t = flash_attention(
                    q, k, v, causal=runs[step], scale=scale,
                    return_residuals=True, **_seg_kw(seg, kv_seg))
                o, lse = _merge(o, lse, o_t, lse_t)
                HOPS += 1
            if step != n - 1:
                k = coll._ring_shift(k, mesh, axis)
                v = coll._ring_shift(v, mesh, axis)
                if kv_seg is not None:
                    kv_seg = coll._ring_shift(kv_seg, mesh, axis)
        ctx.save_for_backward(q, k0, v0, seg, o, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.scale = mesh, axis, causal, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        global HOPS
        q, k, v, seg, o, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n, me = mesh.size(axis), mesh.index(axis)
        runs = _hops(n, me, ctx.causal)
        do = do.to(q.dtype).contiguous()
        kv_seg = seg
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for step in range(n):
            if step in runs:
                dq_t, dk_t, dv_t = flash_attention_bwd(
                    q, k, v, o, lse, do, causal=runs[step], scale=ctx.scale,
                    **_seg_kw(seg, kv_seg))
                dq += dq_t
                dk += dk_t
                dv += dv_t
                HOPS += 1
            if step != n - 1:
                k = coll._ring_shift(k, mesh, axis)
                v = coll._ring_shift(v, mesh, axis)
                if kv_seg is not None:
                    kv_seg = coll._ring_shift(kv_seg, mesh, axis)
                dk = coll._ring_shift(dk, mesh, axis)
                dv = coll._ring_shift(dv, mesh, axis)
        # after n - 1 hops the accumulators sit one hop short of home
        dk = coll._ring_shift(dk, mesh, axis)
        dv = coll._ring_shift(dv, mesh, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_attention_local(
    q, k, v, *,
    axis_name: str = Axis.SEQ,
    causal: bool = False,
    scale: float | None = None,
    segment_ids=None,
    mesh: Mesh | None = None,
):
    """Ring attention on this rank's LOCAL seq shards: q/k/v
    ``(B, H, S_local, D)``, ``segment_ids`` ``(B, S_local)`` int32 (the
    local labels mask q; a rotating copy rides the ring with each kv
    shard). Differentiable in q, k and v."""
    m = current_mesh() if mesh is None else mesh
    if m is None:
        raise ValueError("ring attention needs a mesh (mesh_context)")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _Ring.apply(q, k, v, seg, m, axis_name, causal, scale)


def shard_global(x, mesh: Mesh, axis_name: str, seq_dim: int = 2):
    """This rank's block of a global ``(B, H, S, ...)`` (or ``(B, S)``
    with ``seq_dim=1``) array, as the wrappers' ``shard_map`` specs cut
    it."""
    x = x.chunk(mesh.size(Axis.BATCH), 0)[mesh.index(Axis.BATCH)]
    if seq_dim == 2:
        x = x.chunk(mesh.size(Axis.MODEL), 1)[mesh.index(Axis.MODEL)]
    return x.chunk(mesh.size(axis_name), seq_dim)[mesh.index(axis_name)]


def unshard_global(x, mesh: Mesh, axis_name: str):
    """The global ``(B, H, S, D)`` array from every rank's block, on every
    rank (the inverse of :func:`shard_global`; the gradient is this
    rank's block)."""
    x = coll.replicate(x, axis_name, gather_axis=2, mesh=mesh)
    x = coll.replicate(x, Axis.MODEL, gather_axis=1, mesh=mesh)
    return coll.replicate(x, Axis.BATCH, gather_axis=0, mesh=mesh)


def ring_attention(
    q, k, v, mesh: Mesh, *,
    axis_name: str = Axis.SEQ,
    causal: bool = False,
    scale: float | None = None,
    segment_ids=None,
):
    """Global-array convenience wrapper: every rank passes the same global
    q/k/v ``(B, H, S, D)`` (and ``segment_ids`` ``(B, S)``), computes its
    block (batch over data, heads over model, seq over ``axis_name``) and
    gets the global output back."""
    seg = None if segment_ids is None else shard_global(
        segment_ids, mesh, axis_name, seq_dim=1)
    # the inputs are replicated: each rank's gradient is summed with the
    # others' so every rank holds the global one
    axes = (Axis.DATA, Axis.FSDP, Axis.MODEL, axis_name)
    out = ring_attention_local(
        *(shard_global(coll.enter(t, axes, mesh=mesh), mesh, axis_name)
          .contiguous() for t in (q, k, v)),
        axis_name=axis_name, causal=causal, scale=scale, segment_ids=seg,
        mesh=mesh)
    return unshard_global(out, mesh, axis_name)
