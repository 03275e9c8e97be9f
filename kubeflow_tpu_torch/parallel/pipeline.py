"""Pipeline parallelism over the ``pipe`` axis: the port of
``kubeflow_tpu/parallel/pipeline.py``.

Every rank runs the same program: stage s holds its layer shard, a
microbatch's activation hops to the next stage with one ring shift a
tick (``core/collectives.py``), and bubble ticks pass their input
through. GPipe (:func:`spmd_pipeline_local`, :func:`pipeline_apply`) is
differentiated by autograd through the shifts; 1F1B
(:func:`pipeline_value_and_grad` with ``schedule="1f1b"``) threads the
per-stage VJPs by hand with a bounded circular stash of stage inputs:
at tick t stage s forwards microbatch ``t - s`` and backwards microbatch
``t - 2(n-1) + s``, cotangents hopping back one stage a tick. A ``data``
(and ``fsdp``) axis beside ``pipe`` splits each microbatch's rows.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, Mesh, current_mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def spmd_pipeline_local(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,   # (n_micro, mb, ...) — consumed by stage 0
    *,
    axis_name: str = Axis.PIPE,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """GPipe on this rank: ``stage_params`` are this stage's. Returns the
    ``(n_micro, mb, ...)`` outputs on every rank (the last stage's,
    broadcast by a sum over the axis)."""
    mesh = current_mesh() if mesh is None else mesh
    n, s = mesh.size(axis_name), mesh.index(axis_name)
    n_micro = microbatches.shape[0]
    # every hop must be in every rank's autograd graph, one chain in tick
    # order, so that each rank runs each hop's backward (a send and a
    # receive that pair up across ranks) in the same order: the first
    # state depends on the inputs and an injected microbatch is selected,
    # not substituted
    no = torch.zeros((), dtype=torch.bool, device=microbatches.device)
    dep = microbatches.sum() + sum(p.sum() for p in _leaves(stage_params)
                                   if torch.is_tensor(p))
    state = torch.where(no, dep, torch.zeros_like(microbatches[0]))
    banked: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n - 1):
        j = t - s
        x_in = state
        if s == 0 and t < n_micro:
            x_in = torch.where(~no, microbatches[t], state)
        y = stage_fn(stage_params, x_in) if 0 <= j < n_micro else x_in
        if s == n - 1 and 0 <= j < n_micro:
            banked[j] = y
        state = coll.ring_shift(y, axis_name, mesh=mesh)
    zero = torch.zeros_like(microbatches[0])
    outputs = torch.stack([zero if b is None else b for b in banked])
    outputs = outputs + torch.where(no, state.sum(), 0.0)  # the last hop too
    return coll.psum(outputs, axis_name, mesh=mesh)


def _check(stacked_params, x, n_stages: int, n_microbatches: int) -> None:
    if x.shape[0] % n_microbatches:
        raise ValueError(
            f"batch {x.shape[0]} not divisible into {n_microbatches} microbatches")
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked param leading dim {leaf.shape[0]} != pipe axis {n_stages}")


def _local_inputs(stacked_params, x, mesh, n_microbatches, axis_name,
                  batch_axes):
    """This rank's stage params and ``(n_micro, mb_local, ...)`` rows:
    microbatch j is global rows ``[j*mb, (j+1)*mb)``, its rows split over
    ``batch_axes``. The inputs are replicated, so their gradients are
    summed over the pipeline and batch ranks (every rank then holds the
    global one)."""
    axes = (axis_name,) + tuple(batch_axes)
    s = mesh.index(axis_name)
    xm = x.reshape(n_microbatches, x.shape[0] // n_microbatches, *x.shape[1:])
    # one sum for all of them: the stages' graphs differ, so separate sums
    # could run in another order on each rank
    leaves = _leaves(stacked_params) + [xm]
    flat = coll.enter(torch.cat([t.reshape(-1) for t in leaves]), axes, mesh=mesh)
    parts = [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in leaves]),
                                           leaves)]
    params = _unflatten(stacked_params, [p[s] for p in parts[:-1]])
    xm = parts[-1]
    nb = mesh.size(batch_axes) if batch_axes else 1
    if nb > 1:
        xm = xm.chunk(nb, 1)[mesh.index(batch_axes)]
    return params, xm


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,   # leaves with leading dim = n_stages
    x: torch.Tensor,       # (batch, ...) global input
    mesh: Mesh,
    *,
    n_microbatches: int,
    axis_name: str = Axis.PIPE,
    batch_axes: tuple[str, ...] = (Axis.DATA, Axis.FSDP),
) -> torch.Tensor:
    """Global wrapper: every rank passes the stacked params and the global
    batch; stage s runs ``stage_fn`` on slice s, the batch is cut into
    microbatches (their rows split over ``batch_axes``) and the global
    output comes back on every rank. Differentiable (GPipe)."""
    _check(stacked_params, x, mesh.size(axis_name), n_microbatches)
    params, xm = _local_inputs(stacked_params, x, mesh, n_microbatches,
                               axis_name, batch_axes)
    out = spmd_pipeline_local(stage_fn, params, xm, axis_name=axis_name,
                              mesh=mesh)
    if batch_axes and mesh.group(batch_axes) is not None:
        # every batch rank's rows of each microbatch, on every rank
        out = coll.replicate(out, tuple(batch_axes), gather_axis=1, mesh=mesh)
    return out.reshape(x.shape[0], *out.shape[2:])


def live_activation_buffers(schedule: str, n_stages: int,
                            n_microbatches: int) -> int:
    """Peak per-stage stashed stage inputs: GPipe keeps one a microbatch;
    lockstep 1F1B starts microbatch j's backward at stage s
    ``2*(n-1-s)`` ticks after its forward, so ``2*(n_stages-1)+1``
    slots suffice whatever the microbatch count."""
    if schedule == "gpipe":
        return n_microbatches
    if schedule == "1f1b":
        return 2 * (n_stages - 1) + 1
    raise ValueError(f"unknown schedule {schedule!r}")


def _gather_stages(tree, mesh, axis_name):
    return _tree_map(
        lambda g: coll._all_gather(g.contiguous(), mesh, axis_name, 0,
                                   tiled=False), tree)


def pipeline_value_and_grad(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    n_microbatches: int,
    schedule: str = "1f1b",
    axis_name: str = Axis.PIPE,
    batch_axes: tuple[str, ...] = (Axis.DATA, Axis.FSDP),
    stats: dict | None = None,
) -> tuple[torch.Tensor, Any]:
    """``(loss, grads)`` for ``loss = mean_j loss_fn(y_j)`` through the
    pipeline, under ``schedule``; ``grads`` is the stacked tree, global on
    every rank. ``loss_fn`` maps one microbatch of last-stage outputs to
    a scalar mean. ``stats`` (a dict) receives ``live_buffers``: the most
    stage inputs this rank held at once for the backward."""
    if schedule == "gpipe":
        params = _tree_map(lambda p: p.detach().requires_grad_(True),
                           stacked_params)
        with torch.enable_grad():
            y = pipeline_apply(stage_fn, params, x, mesh,
                               n_microbatches=n_microbatches,
                               axis_name=axis_name, batch_axes=batch_axes)
            ym = y.reshape(n_microbatches, -1, *y.shape[1:])
            loss = torch.stack([loss_fn(ym[j]) for j in range(n_microbatches)]).mean()
            grads = torch.autograd.grad(loss, _leaves(params))
        if stats is not None:
            stats["live_buffers"] = n_microbatches
        return loss.detach(), _unflatten(params, list(grads))
    if schedule != "1f1b":
        raise ValueError(f"unknown schedule {schedule!r}")

    n = mesh.size(axis_name)
    _check(stacked_params, x, n, n_microbatches)
    with torch.no_grad():
        params, xm = _local_inputs(stacked_params, x, mesh, n_microbatches,
                                   axis_name, batch_axes)
    s = mesh.index(axis_name)
    m = xm.shape[0]
    slots = live_activation_buffers("1f1b", n, m)
    stash: dict[int, torch.Tensor] = {}
    live = 0
    leaves = [p.detach() for p in _leaves(params)]
    grads = [torch.zeros_like(p) for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    fwd_state = torch.zeros_like(xm[0])
    ct_state = torch.zeros_like(xm[0])

    def run_stage(ps, xin):
        return stage_fn(_unflatten(params, ps), xin)

    for t in range(m + 2 * (n - 1)):
        # forward half: microbatch jf = t - s
        jf = t - s
        active_f = 0 <= jf < m
        x_in = xm[t] if (s == 0 and t < m) else fwd_state
        with torch.no_grad():
            y = run_stage(leaves, x_in) if active_f else x_in
        if active_f:
            stash[jf % slots] = x_in
            live = max(live, len(stash))
        # backward half: microbatch jb = t - 2(n-1) + s
        jb = t - 2 * (n - 1) + s
        active_b = 0 <= jb < m
        dx = torch.zeros_like(xm[0])
        if active_b:
            if s == n - 1:
                # the last stage's cotangent: the microbatch it just forwarded
                with torch.enable_grad():
                    yl = y.detach().requires_grad_(True)
                    loss_j = loss_fn(yl)
                    (dy,) = torch.autograd.grad(loss_j, yl)
                ct_in = dy / m
                loss_acc = loss_acc + loss_j.detach().float() / m
            else:
                ct_in = ct_state
            x_saved = stash.pop(jb % slots)
            with torch.enable_grad():
                ps = [p.requires_grad_(True) for p in
                      (q.detach() for q in leaves)]
                xs = x_saved.detach().requires_grad_(True)
                out = run_stage(ps, xs)
                *dps, dx = torch.autograd.grad(out, ps + [xs], ct_in)
            grads = [g + d for g, d in zip(grads, dps)]
        # activation hop forward, cotangent hop backward
        fwd_state = coll._ring_shift(y.contiguous(), mesh, axis_name, 1)
        ct_state = coll._ring_shift(dx.contiguous(), mesh, axis_name, -1)
    loss = coll._all_reduce(loss_acc, mesh, axis_name)
    if batch_axes and mesh.group(batch_axes) is not None:
        nb = mesh.size(batch_axes)
        loss = coll._all_reduce(loss, mesh, batch_axes) / nb
        grads = [coll._all_reduce(g, mesh, batch_axes) / nb for g in grads]
    if stats is not None:
        stats["live_buffers"] = live
    return loss, _gather_stages(_unflatten(params, grads), mesh, axis_name)
