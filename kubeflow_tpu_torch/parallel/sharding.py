"""Rule-based parameter sharding: the port of ``kubeflow_tpu/parallel/sharding.py``.

First-match ``(regex, spec)`` rules keyed by the JAX param paths
(``layers_0/attn/q_proj/kernel``). A spec is a :class:`P`, one entry a
dim: an axis name, a tuple of names, or ``None`` (replicated), as a
``PartitionSpec``. Called on a JAX-style param tree the rules give the
spec tree; called on a port module they give ``{state_dict name: spec}``
in the port's layout, the bridge mapping each name to its JAX path and a
transposed ``nn.Linear`` weight taking the reversed spec
(:func:`module_specs`). The trainer shards each parameter by its spec
(:func:`shard_tensor`), keeps ``model`` and ``expert`` slices local and
gathers the other axes at use.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Sequence

from kubeflow_tpu_torch.core.mesh import Axis


class P(tuple):
    """A partition spec: ``P("model", "fsdp")``; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def padded(self, ndim: int) -> "P":
        if len(self) > ndim:
            raise ValueError(f"spec {self} has more entries than {ndim} dims")
        return P(*self, *([None] * (ndim - len(self))))


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (``None`` -> ``()``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def _map_tree(fn, tree, prefix=()):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    return fn("/".join(prefix), tree)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered ``(regex, P)`` pairs; first match wins, ``default`` when
    nothing matches. Calling the instance is the trainer's
    ``param_spec_fn`` contract."""

    rules: Sequence[tuple[str, P]]
    default: P = P()

    def spec_for(self, path: str, shape: tuple[int, ...]) -> P:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                if len([a for a in spec if a is not None]) > len(shape):
                    raise ValueError(
                        f"rule {pattern!r} spec {spec} has more axes than "
                        f"param {path} shape {shape}"
                    )
                return spec
        return self.default

    def __call__(self, params: Any) -> Any:
        """A JAX-style nested dict of arrays (or shapes) -> the spec tree;
        a port ``nn.Module`` -> ``{state_dict name: spec}`` in the port's
        layout."""
        if isinstance(params, Mapping):
            return _map_tree(lambda p, leaf: self.spec_for(p, _shape(leaf)),
                             params)
        return module_specs(self, params)

    def validate_divisibility(self, params: Any,
                              mesh_shape: dict[str, int]) -> None:
        """Fail fast when a sharded dim does not divide by its axis size."""

        def check(path, leaf):
            shape = _shape(leaf)
            spec = self.spec_for(path, shape)
            for dim, entry in enumerate(spec):
                for ax in spec_axes(entry):
                    n = mesh_shape.get(ax, 1)
                    if shape[dim] % n:
                        raise ValueError(
                            f"{path} dim {dim} ({shape[dim]}) not divisible "
                            f"by axis {ax!r} size {n}"
                        )

        _map_tree(check, params)


def transformer_rules(*, fsdp: bool = True, tensor: bool = True) -> ShardingRules:
    """The JAX ``transformer_rules`` for ``TransformerLM`` param names
    (flax kernels are (in, out)): vocab over ``model`` and d_model over
    ``fsdp`` for the tables; q/k/v/up/gate column-parallel (out over
    ``model``, in over ``fsdp``); o/down row-parallel (in over ``model``,
    out over ``fsdp``); norm scales replicated; MoE expert weights with
    the expert dim over ``expert``."""
    m = Axis.MODEL if tensor else None
    f = Axis.FSDP if fsdp else None
    rules: list[tuple[str, P]] = [
        (r"embed/embedding$", P(m, f)),
        (r"(q_proj|k_proj|v_proj)/kernel$", P(f, m)),
        (r"o_proj/kernel$", P(m, f)),
        (r"(up_proj|gate_proj)/kernel$", P(f, m)),
        (r"down_proj/kernel$", P(m, f)),
        (r"unembed/kernel$", P(f, m)),
        (r"(q_proj|k_proj|v_proj|up_proj|gate_proj)/bias$", P(m)),
        (r"(scale|bias)$", P()),
        (r"experts/(up|gate)_kernel$", P(Axis.EXPERT, f, m)),
        (r"experts/down_kernel$", P(Axis.EXPERT, m, f)),
        (r"experts/router_kernel$", P(f, None)),
    ]
    return ShardingRules(tuple(rules))


def module_specs(rules: ShardingRules, module) -> dict[str, P]:
    """``{state_dict name: spec}`` of a port ``TransformerLM`` in the
    port's layout: each name's JAX path from the bridge, and a
    transposed 2-D weight's spec reversed."""
    from kubeflow_tpu_torch.models.bridge import jax_path

    out = {}
    for name, p in module.named_parameters():
        path, transposed = jax_path(name)
        shape = tuple(p.shape)
        jshape = shape[::-1] if transposed else shape
        spec = rules.spec_for(path, jshape).padded(len(shape))
        out[name] = P(*spec[::-1]) if transposed else spec
    return out


def shard_tensor(t, spec: P, mesh):
    """This rank's shard of a full tensor under ``spec`` (each dim split
    over its axes in the order listed, the mesh's c-order)."""
    for dim, entry in enumerate(spec.padded(t.dim())):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = mesh.size(axes)
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} ({t.shape[dim]}) not divisible by {entry} ({n})")
        t = t.chunk(n, dim)[_index(mesh, axes)]
    return t.contiguous()


def _index(mesh, axes: Sequence[str]) -> int:
    """The shard index of this rank along ``axes`` in the order listed
    (JAX splits a dim over a tuple of axes major-to-minor as listed)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
    return idx


#: axes whose shards a rank computes with as they are (tensor- and
#: expert-parallel); every other axis of a spec is gathered at use
LOCAL_AXES = (Axis.MODEL, Axis.EXPERT)


def gathered_axes(spec: P | None) -> tuple[str, ...]:
    """The axes of ``spec`` gathered at use, in grid order (``data``
    carries the ``dcn_data`` factor, as in the mesh's groups)."""
    if spec is None:
        return ()
    names = {a for e in spec for a in spec_axes(e) if a not in LOCAL_AXES}
    if Axis.DATA in names:
        names.add(Axis.DCN)
    return tuple(a for a in Axis.GRID if a in names)


def check_spec(spec: P) -> None:
    """The layouts the port computes with: a dim is split over local axes
    or over gathered ones, not both, and a dim over several gathered axes
    lists them in grid order (the order their group concatenates)."""
    for entry in spec:
        axes = spec_axes(entry)
        local = [a for a in axes if a in LOCAL_AXES]
        if local and len(local) != len(axes):
            raise NotImplementedError(
                f"spec entry {entry!r} mixes {LOCAL_AXES} with gathered axes")
        if list(axes) != sorted(axes, key=Axis.GRID.index):
            raise NotImplementedError(
                f"spec entry {entry!r}: list its axes in grid order {Axis.GRID}")


def gather_at_use(p, mesh):
    """A parameter as a computation uses it: the shard a rank holds with
    every gathered axis (``fsdp``, ...) gathered, differentiably (the
    gradient is reduce-scattered back to the shard); ``model`` and
    ``expert`` slices stay local. A parameter without a spec is itself."""
    from kubeflow_tpu_torch.core import collectives as coll

    spec = getattr(p, "kft_spec", None)
    if spec is None or mesh is None:
        return p
    t = p
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if a not in LOCAL_AXES)
        if axes and mesh.group(axes) is not None:
            t = coll.all_gather(t, axes, gather_axis=dim, mesh=mesh)
    return t
