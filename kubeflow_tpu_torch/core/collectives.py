"""Collectives over a mesh axis: the port of ``kubeflow_tpu/core/collectives.py``.

JAX's wrappers are ``lax`` collectives over a named axis inside
``shard_map``; here each runs over the process group of this rank's
neighbours along the axis (``Mesh.group``). ``axis`` is an axis name or a
tuple of names, as in ``lax.psum``; the mesh is the ambient one
(``core/mesh.py`` ``mesh_context``) unless one is passed.

The ones that ring attention, Ulysses, FSDP and tensor parallelism
differentiate through are ``torch.autograd.Function`` s whose backward is
the transposed collective:

- :func:`psum`: forward all-reduce sum, backward identity (each rank's
  consumer is the same replicated computation: a row-parallel
  projection's output, a global mean);
- :func:`enter`: forward identity, backward all-reduce sum (replicated
  values entering rank-local computation: a column-parallel projection's
  input, Megatron's ``f``);
- :func:`all_gather`: backward reduce-scatter (each rank's consumer is its
  own: an FSDP parameter gathered at use);
- :func:`replicate`: an all-gather whose consumer is replicated (a
  global result every rank holds): backward keeps this rank's slice;
- :func:`reduce_scatter`: backward all-gather;
- :func:`ring_shift`: backward the inverse shift;
- :func:`all_to_all`: backward the inverse exchange.

Host staging lives here alone: under gloo, a CUDA tensor is copied into
pinned host memory (as f32 when it is a narrower float), reduced or moved
there and copied back. :data:`STAGED_BYTES` counts the bytes that cross
the host link both ways, :data:`COLLECTIVE_CALLS` the calls by kind and
:data:`COLLECTIVE_S` their wall seconds.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.core.mesh import Mesh, current_mesh

#: bytes copied device -> host -> device by staged collectives
STAGED_BYTES = 0
#: collectives issued, by kind
COLLECTIVE_CALLS: dict[str, int] = {}
#: wall seconds spent in collectives (staging and waiting included)
COLLECTIVE_S = 0.0


def reset_counters() -> None:
    global STAGED_BYTES, COLLECTIVE_S
    STAGED_BYTES = 0
    COLLECTIVE_S = 0.0
    COLLECTIVE_CALLS.clear()


def _mesh(mesh: Mesh | None) -> Mesh:
    m = current_mesh() if mesh is None else mesh
    if m is None:
        raise ValueError("collectives need a mesh: pass one or use mesh_context")
    return m


class _Staged:
    """A tensor as the backend wants it: itself, or under host staging a
    pinned host copy (narrow floats widened to f32) that :meth:`back`
    returns to the device in the original dtype."""

    def __init__(self, t: torch.Tensor, mesh: Mesh):
        global STAGED_BYTES
        self.dtype, self.device = t.dtype, t.device
        self.staged = mesh.staged and t.is_cuda
        if not self.staged:
            self.t = t.contiguous()
            return
        wide = (torch.float32 if t.is_floating_point()
                and t.dtype not in (torch.float32, torch.float64) else t.dtype)
        self.t = torch.empty(t.shape, dtype=wide, pin_memory=True)
        self.t.copy_(t)
        STAGED_BYTES += self.t.numel() * self.t.element_size()

    def back(self, t: torch.Tensor | None = None) -> torch.Tensor:
        global STAGED_BYTES
        t = self.t if t is None else t
        if not self.staged:
            return t
        STAGED_BYTES += t.numel() * t.element_size()
        return t.to(self.device, non_blocking=False).to(self.dtype)

    def empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.t.dtype, device=self.t.device,
                           pin_memory=self.staged)


def _timed(kind: str, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    global COLLECTIVE_S
    t0 = time.perf_counter()
    out = fn()
    COLLECTIVE_S += time.perf_counter() - t0
    COLLECTIVE_CALLS[kind] = COLLECTIVE_CALLS.get(kind, 0) + 1
    return out


# --------------------------------------------------------------------------- #
# raw collectives (no autograd)
# --------------------------------------------------------------------------- #

def _all_reduce(x: torch.Tensor, mesh: Mesh, axis, op=dist.ReduceOp.SUM):
    group = mesh.group(axis)
    if group is None:
        return x.clone()

    def run():
        s = _Staged(x, mesh)
        buf = s.t.clone() if not s.staged else s.t
        dist.all_reduce(buf, op=op, group=group)
        return s.back(buf)

    return _timed("all_reduce", run)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int, tiled: bool = True):
    group = mesh.group(axis)
    if group is None:
        return x.clone() if tiled else x.unsqueeze(dim)

    def run():
        n = dist.get_world_size(group)
        s = _Staged(x, mesh)
        parts = [s.empty(s.t.shape) for _ in range(n)]
        dist.all_gather(parts, s.t, group=group)
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        return s.back(out)

    return _timed("all_gather", run)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axis, dim: int):
    """Sum over the group, keep this rank's 1/n slice of ``dim`` (an
    all-reduce and a slice: every backend has the all-reduce)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, i = mesh.size(axis), mesh.index(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) not divisible by {n}")
    full = _all_reduce(x, mesh, axis)
    COLLECTIVE_CALLS["reduce_scatter"] = COLLECTIVE_CALLS.get("reduce_scatter", 0) + 1
    return full.chunk(n, dim)[i].contiguous()


def _ring_shift(x: torch.Tensor, mesh: Mesh, axis, shift: int = 1):
    """Shard i -> shard i + shift (mod n) around the axis ring."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, i = mesh.size(axis), mesh.index(axis)
    if shift % n == 0:
        return x.clone()
    peers = mesh.peers(axis)

    def run():
        s = _Staged(x, mesh)
        out = s.empty(s.t.shape)
        ops = [dist.P2POp(dist.isend, s.t, peers[(i + shift) % n], group),
               dist.P2POp(dist.irecv, out, peers[(i - shift) % n], group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return s.back(out)

    return _timed("ring_shift", run)


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis, split_axis: int,
                concat_axis: int):
    """Chunk ``split_axis`` n ways, send chunk j to rank j, concatenate the
    received chunks along ``concat_axis`` in rank order (``lax.all_to_all``
    with ``tiled=True``)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n = mesh.size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) not "
            f"divisible by axis size {n}")

    def run():
        s = _Staged(torch.stack(x.chunk(n, split_axis), 0), mesh)
        out = s.empty(s.t.shape)
        dist.all_to_all_single(out, s.t, group=group)
        return torch.cat(s.back(out).unbind(0), concat_axis)

    return _timed("all_to_all", run)


# --------------------------------------------------------------------------- #
# differentiable collectives
# --------------------------------------------------------------------------- #

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        mine = g.chunk(m.size(ctx.axis), ctx.dim)[m.index(ctx.axis)]
        return mine.contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ring_shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return (_ring_shift(g.contiguous(), ctx.mesh, ctx.axis, -ctx.shift),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split, ctx.concat = split_axis, concat_axis
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), ctx.mesh, ctx.axis, ctx.concat,
                            ctx.split), None, None, None, None)


def psum(x: torch.Tensor, axis, *, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the axis group; the gradient passes through unchanged."""
    return _Psum.apply(x, _mesh(mesh), axis)


def enter(x: torch.Tensor, axis, *, mesh: Mesh | None = None) -> torch.Tensor:
    """Identity forward; the gradient is summed over the axis group."""
    m = _mesh(mesh)
    if m.group(axis) is None:
        return x
    return _Enter.apply(x, m, axis)


def all_gather(x: torch.Tensor, axis, *, tiled: bool = True,
               gather_axis: int = 0, mesh: Mesh | None = None) -> torch.Tensor:
    """Concatenate (``tiled``) or stack the shards of the axis group along
    ``gather_axis`` in group order (FSDP's parameter gather)."""
    m = _mesh(mesh)
    if not tiled:
        return _AllGather.apply(x.unsqueeze(gather_axis), m, axis, gather_axis)
    return _AllGather.apply(x, m, axis, gather_axis)


def replicate(x: torch.Tensor, axis, *, gather_axis: int = 0,
              mesh: Mesh | None = None) -> torch.Tensor:
    """Concatenate the shards of the axis group along ``gather_axis`` for
    a consumer every rank runs alike (the global output of a sharded
    computation): the gradient is this rank's slice of the cotangent."""
    return _Replicate.apply(x, _mesh(mesh), axis, gather_axis)


def reduce_scatter(x: torch.Tensor, axis, *, scatter_axis: int = 0,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the axis group and keep this rank's slice (FSDP's
    gradient reduce-scatter)."""
    return _ReduceScatter.apply(x, _mesh(mesh), axis, scatter_axis)


def ring_shift(x: torch.Tensor, axis, *, shift: int = 1,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Rotate shards around the axis ring: shard i goes to shard i+shift
    (ring attention's kv hop, a pipeline stage handoff)."""
    return _RingShift.apply(x, _mesh(mesh), axis, shift)


def all_to_all(x: torch.Tensor, axis, *, split_axis: int, concat_axis: int,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Re-shard between two dims over the axis (Ulysses' seq <-> heads
    swap, MoE token dispatch)."""
    return _AllToAll.apply(x, _mesh(mesh), axis, split_axis, concat_axis)


def pmax(x: torch.Tensor, axis, *, mesh: Mesh | None = None) -> torch.Tensor:
    """Elementwise max over the axis group (no gradient)."""
    return _all_reduce(x.detach(), _mesh(mesh), axis, op=dist.ReduceOp.MAX)


def grad_allreduce(grads, axis, *, mesh: Mesh | None = None):
    """Mean-allreduce of a gradient tree (dict, list or tensor) over a
    data axis, the DDP allreduce."""
    m = _mesh(mesh)
    n = m.size(axis)
    if isinstance(grads, dict):
        return {k: grad_allreduce(v, axis, mesh=m) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(grad_allreduce(v, axis, mesh=m) for v in grads)
    return _all_reduce(grads, m, axis) / n


# --------------------------------------------------------------------------- #
# micro-benchmarks
# --------------------------------------------------------------------------- #

def benchmark_collective(
    mesh: Mesh,
    axis: str,
    kind: str = "psum",
    *,
    mb_per_shard: float = 4.0,
    dtype=torch.float32,
    iters: int = 10,
    warmup: int = 3,
) -> dict:
    """Time one collective over ``axis``; seconds an op and the nccl-tests
    bus bandwidth, the JAX harness's keys. ``kind``: psum | all_gather |
    reduce_scatter | ppermute | all_to_all."""
    n = mesh.size(axis)
    elem = torch.empty((), dtype=dtype).element_size()
    rows = max(int(mb_per_shard * 1e6 / (128 * elem)), n)
    rows -= rows % n
    nbytes = rows * 128 * elem
    ops = {
        "psum": lambda x: _all_reduce(x, mesh, axis),
        "all_gather": lambda x: _all_gather(x, mesh, axis, 0),
        "reduce_scatter": lambda x: _reduce_scatter(x, mesh, axis, 0),
        "ppermute": lambda x: _ring_shift(x, mesh, axis),
        "all_to_all": lambda x: _all_to_all(x, mesh, axis, 0, 1),
    }
    if kind not in ops:
        raise ValueError(f"unknown collective {kind!r}; options {sorted(ops)}")
    op = ops[kind]
    x = torch.ones((rows, 128), dtype=dtype, device=mesh.device)
    sync = (lambda: torch.cuda.synchronize(mesh.device)) \
        if mesh.device.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        op(x)
    sync()
    group = mesh.group(axis)
    if group is not None:
        dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = op(x)
    del out
    sync()
    sec = (time.perf_counter() - t0) / iters
    factor = {"psum": 2 * (n - 1) / n, "all_gather": (n - 1) / n,
              "reduce_scatter": (n - 1) / n, "ppermute": 1.0,
              "all_to_all": (n - 1) / n}[kind]
    busbw = nbytes * n * factor / sec if sec > 0 else float("inf")
    return {"kind": kind, "axis": axis, "axis_size": n,
            "bytes_per_shard": nbytes, "sec_per_op": sec,
            "bus_gbps": busbw / 1e9}


def benchmark_suite(mesh: Mesh, axis: str, **kw) -> list[dict]:
    return [benchmark_collective(mesh, axis, kind, **kw)
            for kind in ("psum", "all_gather", "reduce_scatter", "ppermute",
                         "all_to_all")]

