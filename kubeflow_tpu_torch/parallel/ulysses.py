"""Ulysses sequence parallelism: the port of ``kubeflow_tpu/parallel/ulysses.py``.

On entry each rank holds every head of a sequence shard; an
``all_to_all`` over the ``seq`` axis swaps that for every position of a
head shard, the flash kernel (``ops/flash_attention.py``) runs over the
full sequence with the local heads, and a second ``all_to_all`` swaps
back. Both exchanges are differentiable (``core/collectives.py``), so the
kernel's own backward runs in between.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, Mesh, current_mesh
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.ring_attention import shard_global, unshard_global


def ulysses_attention_local(
    q, k, v, *,
    axis_name: str = Axis.SEQ,
    causal: bool = False,
    scale: float | None = None,
    segment_ids=None,
    mesh: Mesh | None = None,
):
    """q/k/v are this rank's ``(B, H, S_local, D)``; H must divide by the
    axis size. ``segment_ids`` ``(B, S_local)`` mask packed sequences (the
    full vector is gathered: after the exchange each rank attends over
    the whole sequence). Returns ``(B, H, S_local, D)``."""
    m = current_mesh() if mesh is None else mesh
    if m is None:
        raise ValueError("Ulysses attention needs a mesh (mesh_context)")
    seg_kw = {}
    if segment_ids is not None:
        full = coll._all_gather(segment_ids.to(torch.int32).contiguous(), m,
                                axis_name, 1).contiguous()
        seg_kw = {"q_segment_ids": full, "kv_segment_ids": full}
    n = m.size(axis_name)
    if n == 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, **seg_kw)
    H = q.shape[1]
    if H % n:
        raise ValueError(
            f"Ulysses needs heads ({H}) divisible by seq axis size ({n}); "
            "use ring attention instead"
        )

    def seq_to_heads(x):  # (B, H, S/n, D) -> (B, H/n, S, D)
        return coll.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                               mesh=m).contiguous()

    q, k, v = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    o = flash_attention(q, k, v, causal=causal, scale=scale, **seg_kw)
    # (B, H/n, S, D) -> (B, H, S/n, D)
    return coll.all_to_all(o, axis_name, split_axis=2, concat_axis=1, mesh=m)


def ulysses_attention(
    q, k, v, mesh: Mesh, *,
    axis_name: str = Axis.SEQ,
    causal: bool = False,
    scale: float | None = None,
    segment_ids=None,
):
    """Global-array convenience wrapper (batch over data, heads over
    model, seq over ``axis_name``), as ``ring_attention``'s."""
    seg = None if segment_ids is None else shard_global(
        segment_ids, mesh, axis_name, seq_dim=1)
    # the inputs are replicated: each rank's gradient is summed with the
    # others' so every rank holds the global one
    axes = (Axis.DATA, Axis.FSDP, Axis.MODEL, axis_name)
    out = ulysses_attention_local(
        *(shard_global(coll.enter(t, axes, mesh=mesh), mesh, axis_name)
          .contiguous() for t in (q, k, v)),
        axis_name=axis_name, causal=causal, scale=scale, segment_ids=seg,
        mesh=mesh)
    return unshard_global(out.contiguous(), mesh, axis_name)
