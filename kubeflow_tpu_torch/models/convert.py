"""HF checkpoint interop: a torch BERT ``state_dict`` → the port's BERT
``state_dict`` (the port of ``kubeflow_tpu/models/convert.py``).

An HF checkpoint is already torch, so its keys map straight onto
``models/bert.py``'s, with no detour through a flax tree; the result is
what the JAX conversion followed by ``models/bridge.py`` gives. Name
mapping (HF → port; ``nn.Linear`` weights keep their ``(out, in)``
layout):

    embeddings.word_embeddings.weight        embed.embedding
    embeddings.position_embeddings.weight    pos_embedding
    embeddings.token_type_embeddings.weight  type_embed.embedding
    embeddings.LayerNorm.{weight,bias}       ln_embed.{scale,bias}
    encoder.layer.N.attention.self.query     layers.N.attn.q_proj
    …key/value                               …k_proj/v_proj
    encoder.layer.N.attention.output.dense   layers.N.attn.o_proj
    encoder.layer.N.attention.output.LayerNorm  layers.N.ln1
    encoder.layer.N.intermediate.dense       layers.N.up_proj
    encoder.layer.N.output.dense             layers.N.down_proj
    encoder.layer.N.output.LayerNorm         layers.N.ln2
    pooler.dense                             pooler
    cls.predictions.transform.dense          mlm_transform
    cls.predictions.transform.LayerNorm      mlm_ln
    cls.predictions.decoder (+ bias)         unembed
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import torch

from kubeflow_tpu_torch.models.bert import BertConfig


def bert_config_from_hf(hf: Mapping[str, Any], **overrides) -> BertConfig:
    """HF ``config.json`` dict → BertConfig."""
    base = dict(
        vocab_size=hf.get("vocab_size", 30522),
        hidden_size=hf.get("hidden_size", 768),
        num_layers=hf.get("num_hidden_layers", 12),
        num_heads=hf.get("num_attention_heads", 12),
        intermediate_size=hf.get("intermediate_size", 3072),
        max_position=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    base.update(overrides)
    return BertConfig(**base)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _pair(out: dict, state: Mapping[str, Any], hf_name: str, port_name: str,
          names=("weight", "bias")) -> None:
    """``{hf}.weight``/``.bias`` → ``{port}.<names[0]>``/``.<names[1]>``;
    a missing key raises ``KeyError`` (as the JAX conversion does)."""
    for hf_leaf, port_leaf in zip(("weight", "bias"), names):
        out[f"{port_name}.{port_leaf}"] = _f32(state[f"{hf_name}.{hf_leaf}"])


def hf_bert_state_to_state_dict(
    state: Mapping[str, Any], cfg: BertConfig, prefix: str = ""
) -> dict[str, torch.Tensor]:
    """HF ``BertModel`` state_dict → ``BertEncoder`` keys, each under
    ``prefix``. Accepts bare ``BertModel`` keys or ``bert.``-prefixed ones
    (as inside ``BertForMaskedLM`` dicts); HF keys the encoder does not
    use (``position_ids`` buffers, heads) are ignored."""
    if any(k.startswith("bert.") for k in state):
        state = {k[len("bert."):]: v for k, v in state.items()
                 if k.startswith("bert.")}
    ln = ("scale", "bias")
    sd = {
        "embed.embedding": _f32(state["embeddings.word_embeddings.weight"]),
        "pos_embedding": _f32(state["embeddings.position_embeddings.weight"]),
        "type_embed.embedding": _f32(
            state["embeddings.token_type_embeddings.weight"]),
    }
    _pair(sd, state, "embeddings.LayerNorm", "ln_embed", ln)
    for i in range(cfg.num_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}"
        for hf, port in (("self.query", "q_proj"), ("self.key", "k_proj"),
                         ("self.value", "v_proj"), ("output.dense", "o_proj")):
            _pair(sd, state, f"{p}.attention.{hf}", f"{q}.attn.{port}")
        _pair(sd, state, f"{p}.attention.output.LayerNorm", f"{q}.ln1", ln)
        _pair(sd, state, f"{p}.intermediate.dense", f"{q}.up_proj")
        _pair(sd, state, f"{p}.output.dense", f"{q}.down_proj")
        _pair(sd, state, f"{p}.output.LayerNorm", f"{q}.ln2", ln)
    if "pooler.dense.weight" in state:
        _pair(sd, state, "pooler.dense", "pooler")
    return {prefix + k: v for k, v in sd.items()}


def hf_bert_mlm_to_state_dict(
    state: Mapping[str, Any], cfg: BertConfig
) -> dict[str, torch.Tensor]:
    """HF ``BertForMaskedLM`` state_dict → ``BertForMaskedLM`` keys: the
    encoder under ``encoder.``, plus the prediction head when present
    (``cls.predictions.transform`` → mlm_transform/mlm_ln, the decoder,
    tied to the word embeddings in HF, → unembed)."""
    sd = hf_bert_state_to_state_dict(state, cfg, prefix="encoder.")
    if "cls.predictions.transform.dense.weight" in state:
        _pair(sd, state, "cls.predictions.transform.dense", "mlm_transform")
        _pair(sd, state, "cls.predictions.transform.LayerNorm", "mlm_ln",
              ("scale", "bias"))
        bias_key = ("cls.predictions.decoder.bias"
                    if "cls.predictions.decoder.bias" in state
                    else "cls.predictions.bias")
        sd["unembed.weight"] = _f32(state["cls.predictions.decoder.weight"])
        sd["unembed.bias"] = _f32(state[bias_key])
    return sd


def _load_bin(model_dir: Path) -> dict:
    weights = model_dir / "pytorch_model.bin"
    if not weights.exists():
        raise FileNotFoundError(
            f"no pytorch_model.bin under {model_dir} "
            "(safetensors support: convert externally for now)"
        )
    return torch.load(str(weights), map_location="cpu", weights_only=True)


def load_bert_dir(model_dir: str | Path, **cfg_overrides):
    """An HF-format model directory (``config.json`` +
    ``pytorch_model.bin``) → ``(BertConfig, BertEncoder state_dict)``."""
    model_dir = Path(model_dir)
    cfg_path = model_dir / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(f"no config.json under {model_dir}")
    cfg = bert_config_from_hf(json.loads(cfg_path.read_text()), **cfg_overrides)
    return cfg, hf_bert_state_to_state_dict(_load_bin(model_dir), cfg)


def is_hf_bert_dir(model_dir: str | Path | None) -> bool:
    """True when the directory holds an HF-format BERT checkpoint (the
    layout a storage initializer materializes from a storage_uri)."""
    if not model_dir:
        return False
    p = Path(model_dir)
    return (p / "config.json").exists() and (p / "pytorch_model.bin").exists()


def load_bert_mlm_dir(model_dir: str | Path, **cfg_overrides):
    """Like :func:`load_bert_dir` but keyed for ``BertForMaskedLM``: head
    pieces are included when the checkpoint carries them (missing pieces
    are left to the caller to initialize)."""
    model_dir = Path(model_dir)
    cfg = bert_config_from_hf(
        json.loads((model_dir / "config.json").read_text()), **cfg_overrides)
    return cfg, hf_bert_mlm_to_state_dict(_load_bin(model_dir), cfg)
