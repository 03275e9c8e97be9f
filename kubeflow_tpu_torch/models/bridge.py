"""Parameter bridge: the JAX ``TransformerLM`` param tree ⇄ the port's
``state_dict``.

The JAX tree is the nested dict ``model.init(...)["params"]`` builds
(``kubeflow_tpu/models/transformer.py:make_init_fn``), given as numpy
arrays (or anything ``np.asarray`` takes). Paths map one to one:

    embed/embedding                    -> embed.embedding
    pos_embedding                      -> pos_embedding     (use_rope=False)
    layers_{i}/ln1/scale, ln2/scale    -> layers.{i}.ln1.scale, ln2.scale
    layers_{i}/attn/{q,k,v,o}_proj/kernel -> layers.{i}.attn.{..}_proj.weight
    layers_{i}/mlp/{up,gate,down}_proj/kernel -> layers.{i}.mlp.{..}_proj.weight
    ln_f/scale                         -> ln_f.scale
    unembed/kernel                     -> unembed.weight

Flax ``Dense`` kernels are ``(in, out)`` and ``nn.Linear.weight`` is
``(out, in)``, so kernels are transposed. The bridge is pure numpy and
host-side; ``TransformerLM.load_state_dict`` casts to the model's dtypes.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")
_KNOWN = re.compile(
    r"^(embed\.embedding|pos_embedding|ln_f\.scale|unembed\.weight|"
    r"layers\.\d+\.(ln1|ln2)\.scale|"
    r"layers\.\d+\.attn\.[qkvo]_proj\.weight|"
    r"layers\.\d+\.mlp\.(up|gate|down)_proj\.weight)$"
)


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX param tree → port ``state_dict`` (f32 CPU tensors)."""
    sd = {}
    for path, arr in _flatten(params).items():
        if any(p == "experts" for p in path):
            raise NotImplementedError(
                "MoE expert params are not ported yet (ROADMAP queue 1 item 10)"
            )
        parts = [
            f"layers.{m.group(1)}" if (m := _LAYER.match(p)) else p
            for p in path
        ]
        a = np.asarray(arr, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = a.T
        name = ".".join(parts)
        if not _KNOWN.match(name):
            raise ValueError(f"unknown param path {'/'.join(path)!r}")
        sd[name] = torch.tensor(np.ascontiguousarray(a))
    return sd


def state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Port ``state_dict`` → JAX param tree (nested dict of f32 numpy)."""
    tree: dict[str, Any] = {}
    for name, t in sd.items():
        if not _KNOWN.match(name):
            raise ValueError(f"unknown state_dict key {name!r}")
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layers_{parts[1]}"] + parts[2:]
        a = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.T
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return tree
