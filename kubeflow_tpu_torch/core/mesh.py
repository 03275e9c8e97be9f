"""Logical device meshes over ranks: the port of ``kubeflow_tpu/core/mesh.py``.

JAX runs one process over many devices and lays a ``MeshSpec`` onto them
as one ``jax.sharding.Mesh``. The port is SPMD across processes, one rank
a process (``torch.distributed``), so a mesh here is a grid of ranks plus
one process group per axis set and coordinate:

- the grid holds rank r at the coordinates JAX device r holds for the
  same ``MeshSpec`` (``Axis.ALL`` order, the ``dcn_data`` factor outermost
  and folded into the ``data`` position exactly as ``build_mesh``'s
  virtual-slice fallback folds it), so batch and sequence shards line up
  between the two packages (:func:`jax_device_grid`);
- :meth:`Mesh.group` gives the process group of this rank's neighbours
  over a tuple of axes. Groups are created on first use, for every
  coordinate at once: every rank calls ``group`` in the same order, which
  SPMD code does. A group's ranks are in grid (c-)order over its axes, so
  ``Mesh.index(axes)`` is this rank's position in it.

:func:`mesh_context` / :func:`current_mesh` make a mesh ambient for the
code under it (the model's attention dispatch, MoE and collectives read
it), as ``jax.set_mesh`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np


class Axis:
    """Canonical logical mesh-axis names (the JAX package's)."""

    DATA = "data"
    FSDP = "fsdp"
    MODEL = "model"
    EXPERT = "expert"
    SEQ = "seq"
    PIPE = "pipe"
    #: the cross-slice axis; JAX folds it into ``data``'s position
    DCN = "dcn_data"

    #: JAX's mesh axis order, outermost first
    ALL = (PIPE, DATA, FSDP, EXPERT, SEQ, MODEL)
    #: axes over which the batch is split (``dcn_data`` folded into data)
    BATCH = (DATA, FSDP)
    #: the rank grid's axes: ``dcn_data`` outermost, then ``ALL``
    GRID = (DCN,) + ALL
    #: axes that split a step's tokens: the batch axes and ``seq``
    TOKENS = (DCN, DATA, FSDP, SEQ)


#: chips per v5e slice -> its 2D ICI torus (the JAX package's table)
V5E_TOPOLOGIES: Mapping[int, tuple[int, ...]] = {
    1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4), 16: (4, 4), 32: (4, 8),
    64: (8, 8), 128: (8, 16), 256: (16, 16),
}


def slice_topology(num_devices: int, generation: str = "v5e") -> tuple[int, ...]:
    """Physical ICI topology for a slice of ``num_devices`` chips; a
    near-square 2D factorization for sizes not in the table."""
    del generation
    if num_devices in V5E_TOPOLOGIES:
        return V5E_TOPOLOGIES[num_devices]
    a = int(math.sqrt(num_devices))
    while a > 1 and num_devices % a != 0:
        a -= 1
    return (a, num_devices // a)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes plus the leading cross-slice ``dcn_data`` axis."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    expert: int = 1
    seq: int = 1
    pipe: int = 1
    dcn_data: int = 1

    @property
    def ici_axis_sizes(self) -> dict[str, int]:
        return {Axis.PIPE: self.pipe, Axis.DATA: self.data,
                Axis.FSDP: self.fsdp, Axis.EXPERT: self.expert,
                Axis.SEQ: self.seq, Axis.MODEL: self.model}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return Axis.ALL

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        """ICI-only logical shape; ``build_mesh`` folds ``dcn_data`` in."""
        return tuple(self.ici_axis_sizes[name] for name in Axis.ALL)

    @property
    def ici_devices(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def total_devices(self) -> int:
        return self.ici_devices * self.dcn_data

    @property
    def batch_partitions(self) -> int:
        """How many ways the global batch is split (data-like axes x DCN)."""
        return self.data * self.fsdp * self.dcn_data

    @property
    def grid_shape(self) -> tuple[int, ...]:
        """The rank grid's shape over ``Axis.GRID``."""
        return (self.dcn_data,) + self.axis_sizes

    def size(self, axis: str) -> int:
        return self.dcn_data if axis == Axis.DCN else self.ici_axis_sizes[axis]

    def validate(self, num_devices: int | None = None) -> None:
        for name, size in self.ici_axis_sizes.items():
            if size < 1:
                raise ValueError(f"mesh axis {name!r} must be >=1, got {size}")
        if self.dcn_data < 1:
            raise ValueError(f"dcn_data must be >=1, got {self.dcn_data}")
        if num_devices is not None and self.total_devices != num_devices:
            raise ValueError(
                f"MeshSpec wants {self.total_devices} devices "
                f"({dict(self.ici_axis_sizes)} x dcn_data={self.dcn_data}) "
                f"but {num_devices} are available"
            )

    @classmethod
    def data_parallel(cls, num_devices: int) -> "MeshSpec":
        return cls(data=num_devices)

    @classmethod
    def fsdp_parallel(cls, num_devices: int) -> "MeshSpec":
        return cls(fsdp=num_devices)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown MeshSpec fields: {sorted(unknown)}")
        return cls(**{k: int(v) for k, v in d.items()})

    def to_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


def rank_grid(spec: MeshSpec) -> np.ndarray:
    """Ranks laid out over ``Axis.GRID`` (``dcn_data`` outermost)."""
    spec.validate()
    return np.arange(spec.total_devices).reshape(spec.grid_shape)


def jax_device_grid(spec: MeshSpec) -> np.ndarray:
    """The rank grid in the JAX mesh's shape (``Axis.ALL``, the
    ``dcn_data`` blocks concatenated along ``data``): entry ``i`` is the
    rank that holds the coordinates of JAX device ``i`` (``build_mesh`` on
    one process's devices, contiguous id-ordered virtual slices)."""
    g = rank_grid(spec)
    return np.concatenate(list(g), axis=Axis.ALL.index(Axis.DATA))


def per_device_batch(global_batch: int, spec: MeshSpec) -> int:
    """Per-batch-shard size; validates divisibility like DDP samplers do."""
    parts = spec.batch_partitions
    if global_batch % parts != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"batch partitions {parts} (data={spec.data} x fsdp={spec.fsdp} "
            f"x dcn={spec.dcn_data})"
        )
    return global_batch // parts


def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    """An axis name or tuple of names in grid order; JAX's ``data``
    carries the ``dcn_data`` factor, so ``data`` brings ``dcn_data``."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in Axis.GRID:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {Axis.GRID}")
    if Axis.DATA in names:
        names = names + (Axis.DCN,)
    return tuple(a for a in Axis.GRID if a in names)


class Mesh:
    """This rank's view of a ``MeshSpec`` over the default process group:
    its coordinates, axis sizes and, by :meth:`group`, the process group
    of each axis set. ``device`` is where the rank computes (``None`` is
    the card, as for every entry point; ``"cpu"`` when asked); ``staged``
    says collectives on CUDA tensors go through pinned host memory (gloo
    on a card, ``core/collectives.py``)."""

    def __init__(self, spec: MeshSpec, rank: int, *, device=None,
                 backend: str | None = None):
        from kubeflow_tpu_torch import resolve_device

        spec.validate()
        if not 0 <= rank < spec.total_devices:
            raise ValueError(f"rank {rank} outside a {spec.total_devices}-rank mesh")
        self.spec = spec
        self.rank = rank
        self.device = resolve_device(device)
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.grid = rank_grid(spec)
        where = np.argwhere(self.grid == rank)[0]
        self.coords = {a: int(c) for a, c in zip(Axis.GRID, where)}
        self._groups: dict[tuple[str, ...], Any] = {}

    @property
    def shape(self) -> dict[str, int]:
        """The JAX mesh's shape (``data`` carries the ``dcn_data`` factor)."""
        s = dict(self.spec.ici_axis_sizes)
        s[Axis.DATA] *= self.spec.dcn_data
        return s

    def size(self, axes: str | Sequence[str]) -> int:
        return int(np.prod([self.spec.size(a) for a in _axes(axes)]))

    def index(self, axes: str | Sequence[str]) -> int:
        """This rank's position along ``axes`` (c-order over them): the
        JAX ``axis_index`` of that axis tuple, and its rank in
        :meth:`group`."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.spec.size(a) + self.coords[a]
        return idx

    @property
    def batch_index(self) -> int:
        """Which batch partition this rank holds (over data x fsdp x dcn)."""
        return self.index(Axis.BATCH)

    def peers(self, axes: str | Sequence[str]) -> list[int]:
        """Ranks that share every coordinate but ``axes``, in grid order."""
        names = _axes(axes)
        sel = tuple(slice(None) if a in names else self.coords[a]
                    for a in Axis.GRID)
        return [int(r) for r in self.grid[sel].reshape(-1)]

    def group(self, axes: str | Sequence[str]):
        """The process group of :meth:`peers` (``None`` when it is this
        rank alone). The first call for an axis set creates the groups of
        every coordinate, on every rank, in one order."""
        import torch.distributed as dist

        names = tuple(a for a in _axes(axes) if self.spec.size(a) > 1)
        if not names:
            return None
        if names not in self._groups:
            mine = None
            sel = tuple(slice(None) if a in names else 0 for a in Axis.GRID)
            n = int(np.prod([self.spec.size(a) for a in names]))
            other = [a for a in Axis.GRID if a not in names]
            # every coordinate of the other axes, in grid order
            for start in np.ndindex(*[self.spec.size(a) for a in other]):
                pos = dict(zip(other, start))
                sel = tuple(slice(None) if a in names else pos[a]
                            for a in Axis.GRID)
                ranks = [int(r) for r in self.grid[sel].reshape(-1)]
                assert len(ranks) == n
                g = dist.new_group(ranks, backend=self.backend)
                if self.rank in ranks:
                    mine = g
            self._groups[names] = mine
        return self._groups[names]


_CURRENT: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "kft_mesh", default=None)


def build_mesh(spec: MeshSpec, *, device=None) -> Mesh:
    """This process's :class:`Mesh` for ``spec`` over the default process
    group, which must hold exactly ``spec.total_devices`` ranks
    (``core/distributed.py`` brings it up from the env contract); a
    one-device spec needs no group. ``device=None`` is the card."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if spec.total_devices == 1:  # one rank: no group is ever needed
            spec.validate(1)
            return Mesh(spec, 0, device=device)
        raise RuntimeError(
            "build_mesh needs torch.distributed up: call "
            "core.distributed.initialize_from_env() first"
        )
    spec.validate(dist.get_world_size())
    return Mesh(spec, dist.get_rank(), device=device,
                backend=dist.get_backend())


@contextlib.contextmanager
def mesh_context(mesh: Mesh | None):
    """Make ``mesh`` ambient for the code in the block (``jax.set_mesh``)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Mesh | None:
    """The ambient mesh, ``None`` outside :func:`mesh_context`."""
    return _CURRENT.get()
