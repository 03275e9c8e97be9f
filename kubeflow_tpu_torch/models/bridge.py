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
    layers_{i}/experts/{router,up,down}_kernel -> layers.{i}.experts.{..}_kernel
    ln_f/scale                         -> ln_f.scale
    unembed/kernel                     -> unembed.weight

Flax ``Dense`` kernels are ``(in, out)`` and ``nn.Linear.weight`` is
``(out, in)``, so kernels are transposed; the MoE expert weights are raw
parameters in the JAX layout (``(d_model, E)``, ``(E, d_model, F)``,
``(E, F, d_model)``) and keep it. :func:`jax_path` names a port
parameter's JAX path (the sharding rules are keyed by it). The bridge is pure numpy and
host-side; ``TransformerLM.load_state_dict`` casts to the model's dtypes.

:func:`bert_params_to_state_dict` and :func:`bert_state_dict_to_params`
do the same for the JAX ``BertForMaskedLM`` and
``BertForSequenceClassification`` trees (``kubeflow_tpu/models/
bert.py``), or a bare ``BertEncoder`` tree, against
``models/bert.py``'s modules: the path is the key (``layers_{i}`` ->
``layers.{i}``, ``kernel`` -> ``weight``, transposed), and ``bias``, the
LayerNorm ``scale``/``bias``, ``pos_embedding`` and each table's
``embedding`` keep their names:

    encoder/embed/embedding            -> encoder.embed.embedding
    encoder/type_embed/embedding       -> encoder.type_embed.embedding
    encoder/layers_{i}/attn/q_proj/kernel -> encoder.layers.{i}.attn.q_proj.weight
    encoder/layers_{i}/ln1/scale       -> encoder.layers.{i}.ln1.scale
    mlm_transform/bias, unembed/kernel -> mlm_transform.bias, unembed.weight

:func:`cnn_params_to_state_dict` and :func:`cnn_state_dict_to_params` do
it for the JAX ``MnistCNN`` and ``ResNet`` trees (``kubeflow_tpu/
models/mnist_cnn.py``, ``resnet.py``) against ``models/mnist_cnn.py``
and ``models/resnet.py``, whose submodules carry the flax names: the
path is the key, a dense ``kernel`` ``(in, out)`` becomes ``weight``
``(out, in)`` and a conv ``kernel`` ``(kh, kw, in, out)`` becomes
``weight`` ``(out, in, kh, kw)``; GroupNorm ``scale``/``bias`` and dense
or conv ``bias`` keep their names:

    Conv_0/kernel, Dense_1/bias        -> Conv_0.weight, Dense_1.bias
    stage1_block0/conv2/kernel         -> stage1_block0.conv2.weight
    stage1_block0/gn_proj/scale        -> stage1_block0.gn_proj.scale
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
    r"layers\.\d+\.mlp\.(up|gate|down)_proj\.weight|"
    r"layers\.\d+\.experts\.(router|up|down)_kernel)$"
)


_BERT_KNOWN = re.compile(
    r"^((encoder\.)?(embed\.embedding|type_embed\.embedding|pos_embedding|"
    r"ln_embed\.(scale|bias)|pooler\.(weight|bias)|"
    r"layers\.\d+\.attn\.[qkvo]_proj\.(weight|bias)|"
    r"layers\.\d+\.(up|down)_proj\.(weight|bias)|"
    r"layers\.\d+\.ln[12]\.(scale|bias))|"
    r"(mlm_transform|unembed|classifier)\.(weight|bias)|"
    r"mlm_ln\.(scale|bias))$"
)


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _to_state_dict(params: Mapping[str, Any], known) -> dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(params).items():
        parts = [
            f"layers.{m.group(1)}" if (m := _LAYER.match(p)) else p
            for p in path
        ]
        a = np.asarray(arr, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = a.T
        name = ".".join(parts)
        if not known.match(name):
            raise ValueError(f"unknown param path {'/'.join(path)!r}")
        sd[name] = torch.tensor(np.ascontiguousarray(a))
    return sd


def _to_params(sd: Mapping[str, torch.Tensor], known) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for name, t in sd.items():
        if not known.match(name):
            raise ValueError(f"unknown state_dict key {name!r}")
        parts = []
        for p in name.split("."):
            if p.isdigit() and parts and parts[-1] == "layers":
                parts[-1] = f"layers_{p}"
            else:
                parts.append(p)
        a = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.T
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return tree


def params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` param tree → port ``state_dict`` (f32 CPU
    tensors)."""
    return _to_state_dict(params, _KNOWN)


def jax_path(name: str) -> tuple[str, bool]:
    """A port ``TransformerLM`` parameter name → ``(its JAX param path,
    whether the port stores it transposed)``:
    ``layers.0.attn.q_proj.weight`` → ``("layers_0/attn/q_proj/kernel",
    True)``."""
    if not _KNOWN.match(name):
        raise ValueError(f"unknown state_dict key {name!r}")
    parts = []
    for p in name.split("."):
        if p.isdigit() and parts and parts[-1] == "layers":
            parts[-1] = f"layers_{p}"
        else:
            parts.append(p)
    transposed = parts[-1] == "weight"
    if transposed:
        parts[-1] = "kernel"
    return "/".join(parts), transposed


def state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Port ``TransformerLM`` ``state_dict`` → JAX param tree (nested dict
    of f32 numpy)."""
    return _to_params(sd, _KNOWN)


def bert_params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX BERT param tree (MLM, classifier or bare encoder) → the port's
    ``state_dict`` (f32 CPU tensors); an unknown path raises."""
    return _to_state_dict(params, _BERT_KNOWN)


def bert_state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's BERT ``state_dict`` → JAX param tree (nested dict of f32
    numpy); an unknown key raises."""
    return _to_params(sd, _BERT_KNOWN)


_CNN_KNOWN = re.compile(
    r"^((Conv|Dense)_\d+\.(weight|bias)|"
    r"(stem|head|stage\d+_block\d+\.(conv[123]|proj))\.(weight|bias)|"
    r"(gn_stem|stage\d+_block\d+\.gn(\d|_proj))\.(scale|bias))$"
)
#: flax conv kernel (kh, kw, in, out) <-> torch weight (out, in, kh, kw)
_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def cnn_params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``MnistCNN`` or ``ResNet`` param tree → the port's
    ``state_dict`` (f32 CPU tensors); an unknown path raises."""
    sd = {}
    for path, arr in _flatten(params).items():
        a = np.asarray(arr, dtype=np.float32)
        parts = list(path)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = a.transpose(_HWIO_TO_OIHW) if a.ndim == 4 else a.T
        name = ".".join(parts)
        if not _CNN_KNOWN.match(name):
            raise ValueError(f"unknown param path {'/'.join(path)!r}")
        sd[name] = torch.tensor(np.ascontiguousarray(a))
    return sd


def cnn_state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's ``MnistCNN`` / ``ResNet`` ``state_dict`` → JAX param tree
    (nested dict of f32 numpy); an unknown key raises."""
    tree: dict[str, Any] = {}
    for name, t in sd.items():
        if not _CNN_KNOWN.match(name):
            raise ValueError(f"unknown state_dict key {name!r}")
        parts = name.split(".")
        a = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.transpose(_OIHW_TO_HWIO) if a.ndim == 4 else a.T
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return tree
