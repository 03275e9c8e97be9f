"""Serving runtimes of the port: the text tokenizer, the BERT predictor
runtime and the registry that resolves a model format to its runtime
(the JAX ``kubeflow_tpu/serve/runtimes.py``).

Eight runtimes are registered, as in the JAX ``default_registry``:

- ``kubeflow-tpu-causal-lm`` (formats ``causal-lm``, ``llm``):
  :class:`~kubeflow_tpu_torch.serve.generate.LMRuntimeModel`, one
  whole-generation program per request bucket;
- ``kubeflow-tpu-causal-lm-engine`` (``causal-lm-engine``, ``vllm``):
  :class:`~kubeflow_tpu_torch.serve.engine.LMEngineModel`, continuous
  batching;
- ``kubeflow-tpu-bert`` (``bert``, ``huggingface``) and
  ``kubeflow-tpu-bert-tiny`` (``bert-tiny``): :class:`BertRuntimeModel`,
  text or ids in, MLM top-token ids out, on the bucketed predictor;
- the classic tabular predictors, each ``(name, storage_path, *,
  device=None)``: ``kubeflow-tpu-xgboost`` (``xgboost``),
  ``kubeflow-tpu-lightgbm`` (``lightgbm``), ``kubeflow-tpu-pmml``
  (``pmml``) and ``kubeflow-tpu-sklearn`` (``sklearn``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    bert_base,
    bert_tiny,
    init_bert_weights,
)
from kubeflow_tpu_torch.serve.model import BucketSpec, TorchModel
from kubeflow_tpu_torch.serve.spec import RuntimeRegistry, ServingRuntime


class SimpleTokenizer:
    """Deterministic hash-bucket tokenizer, the JAX ``SimpleTokenizer``:
    lower-cased words and punctuation, each a crc32 bucket (stable across
    processes, unlike ``hash``) in ``[200, vocab_size)``; ``[mask]`` stays
    one token. [CLS]=101 / [SEP]=102 / [MASK]=103 follow BERT."""

    CLS, SEP, MASK, PAD = 101, 102, 103, 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        toks = re.findall(r"\[mask\]|\w+|[^\w\s]", text.lower())
        ids = [self.CLS]
        for t in toks:
            if t == "[mask]":
                ids.append(self.MASK)
            else:
                ids.append(200 + (zlib.crc32(t.encode()) % (self.vocab_size - 200)))
        ids.append(self.SEP)
        return ids


def _wordpiece_for(storage_path: str | None):
    """The checkpoint's own WordPiece tokenizer when ``storage_path`` is a
    directory with a ``vocab.txt``, cased as its ``tokenizer_config.json``
    says (default lower-case, as bert-base-uncased; vocab-size heuristics
    are not reliable), else None."""
    vocab_file = os.path.join(storage_path, "vocab.txt") if storage_path else None
    if not (vocab_file and os.path.isfile(vocab_file)):
        return None
    from kubeflow_tpu_torch.serve.tokenizer import WordPieceTokenizer

    lower = True
    tok_cfg = os.path.join(storage_path, "tokenizer_config.json")
    if os.path.isfile(tok_cfg):
        with open(tok_cfg) as f:
            lower = bool(json.load(f).get("do_lower_case", True))
    return WordPieceTokenizer(vocab_file, do_lower_case=lower)


class BertRuntimeModel(TorchModel):
    """Text or ids in → MLM top-token ids out, on the bucketed predictor.

    v1 rows: ``"text"``, ``{"text": ...}``, an id list, or ``{"input_ids",
    "attention_mask"?, "token_type_ids"?}``; v2 named tensors become such
    rows. Each answer row is the argmax token at every position of the
    row's seq bucket: the argmax runs on the card and only the ``(B, S)``
    int32 ids come back. An id outside the vocabulary (or a token type
    outside ``type_vocab_size``) is a 400, where the JAX gather would
    silently read a NaN row.

    ``storage_path`` (the /mnt/models contract), resolved at
    :meth:`load`, before a weight is built:

    1. an HF-format directory (``config.json`` + ``pytorch_model.bin``):
       converted by ``models/convert.py``; pieces it lacks (an MLM head
       absent from a bare ``BertModel`` dump) keep the fresh init. Its
       ``vocab.txt`` drives the WordPiece tokenizer;
    2. a port checkpoint or saved state (``serve/generate.py``
       :func:`~kubeflow_tpu_torch.serve.generate.restore_state`'s
       layouts);
    3. ``None``: ``state_dict`` (e.g. bridged JAX params), else fresh
       weights from seed 0 (a ``torch.Generator``, not flax's
       initializers).

    Anything else fails closed: the model never reports ready over
    weights it could not load. ``**config_overrides`` replace single
    config fields (typos fail in ``dataclasses.replace``). Default
    buckets are ``(1, 4, 16) × (32, 128)``; ``device=None`` is the card.
    """

    def __init__(
        self,
        name: str,
        storage_path: str | None = None,
        *,
        config: BertConfig | None = None,
        buckets: BucketSpec | None = None,
        device=None,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        **config_overrides: Any,
    ):
        from kubeflow_tpu_torch.models import convert

        hf_dir = convert.is_hf_bert_dir(storage_path)
        if config is not None:
            cfg = config
        elif hf_dir:
            with open(os.path.join(storage_path, "config.json")) as f:
                cfg = convert.bert_config_from_hf(json.load(f))
        else:
            cfg = bert_base()
        if isinstance(config_overrides.get("dtype"), str):
            # a manifest's ``extra`` names the type ("bfloat16"), as the
            # JAX runtime's flax config takes it
            dt = getattr(torch, config_overrides["dtype"], None)
            if not (isinstance(dt, torch.dtype) and dt.is_floating_point):
                raise ValueError(f"dtype {config_overrides['dtype']!r} is not "
                                 "a floating-point torch dtype")
            config_overrides["dtype"] = dt
        if config_overrides:
            cfg = dataclasses.replace(cfg, **config_overrides)
        self.config = cfg
        self.tokenizer = (_wordpiece_for(storage_path)
                          or SimpleTokenizer(cfg.vocab_size))
        self._storage_path = storage_path

        def restore() -> Mapping[str, torch.Tensor] | None:
            if hf_dir:
                return convert.load_bert_mlm_dir(storage_path)[1]
            if storage_path is None:
                return state_dict
            from kubeflow_tpu_torch.serve.generate import restore_state

            try:
                return restore_state(storage_path)
            except Exception as e:
                raise RuntimeError(
                    f"model {name!r}: storage_path {storage_path!r} is "
                    f"neither an HF-format dir nor a restorable checkpoint: {e}"
                ) from e

        def init_module(dev: torch.device) -> BertForMaskedLM:
            state = restore()  # a bad storage_path fails before any weight
            model = BertForMaskedLM(cfg, device=dev)
            init_bert_weights(model, 0)
            if state is not None:
                # checkpoint pieces win; pieces it lacks keep the fresh init
                # (an HF dir), and a key the model lacks fails closed
                _, unexpected = model.load_state_dict(state, strict=not hf_dir)
                if unexpected:
                    raise RuntimeError(
                        f"model {name!r}: checkpoint keys the model lacks: "
                        f"{sorted(unexpected)[:5]}")
            return model.eval().requires_grad_(False)

        def apply_fn(model, input_ids, attention_mask, token_type_ids):
            logits = model(input_ids, attention_mask=attention_mask,
                           token_type_ids=token_type_ids)
            # decode ON THE CARD: ship (B, S) int32 ids, not (B, S, V) f32
            # logits (512 bytes against 15.6 MB for a bert-base request)
            return logits.argmax(-1).to(torch.int32)

        super().__init__(
            name, apply_fn, init_module,
            buckets=buckets or BucketSpec(batch_sizes=(1, 4, 16), seq_lens=(32, 128)),
            device=device,
        )

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        rows = []
        for inst in self.payload_rows(payload):
            if isinstance(inst, str):
                rows.append(np.asarray(self.tokenizer.encode(inst), np.int32))
            elif isinstance(inst, Mapping) and isinstance(inst.get("text"), str):
                rows.append(
                    np.asarray(self.tokenizer.encode(inst["text"]), np.int32))
            else:
                # named dict rows (attention_mask/token_type_ids) or raw ids
                rows.append(self._normalize_row(inst))
        if not rows:
            raise ValueError("empty request")
        for r in rows:
            ids = r["input_ids"] if isinstance(r, Mapping) else r
            _check_range("input_ids", ids, self.config.vocab_size)
            if isinstance(r, Mapping) and "token_type_ids" in r:
                _check_range("token_type_ids", r["token_type_ids"],
                             self.config.type_vocab_size)
        return rows

    def postprocess(self, outputs: np.ndarray, headers=None) -> Any:
        # (batch, seq) token ids: the argmax already ran on the card
        if outputs.ndim == 3:  # a custom apply_fn returning raw logits
            outputs = np.argmax(outputs, axis=-1)
        return {"predictions": outputs.tolist()}


def _check_range(name: str, arr: np.ndarray, size: int) -> None:
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= size):
        raise ValueError(f"{name} must lie in [0, {size}); got "
                         f"[{int(arr.min())}, {int(arr.max())}]")


def default_registry() -> RuntimeRegistry:
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.generate import LMRuntimeModel
    from kubeflow_tpu_torch.serve.lightgbm_runtime import LightGBMRuntimeModel
    from kubeflow_tpu_torch.serve.pmml_runtime import PMMLRuntimeModel
    from kubeflow_tpu_torch.serve.sklearn_runtime import SklearnRuntimeModel
    from kubeflow_tpu_torch.serve.xgboost_runtime import XGBoostRuntimeModel

    reg = RuntimeRegistry()
    for fmt, factory in (("xgboost", XGBoostRuntimeModel),
                         ("lightgbm", LightGBMRuntimeModel),
                         ("pmml", PMMLRuntimeModel),
                         ("sklearn", SklearnRuntimeModel)):
        reg.register(ServingRuntime(
            name=f"kubeflow-tpu-{fmt}", supported_formats=(fmt,),
            factory=factory, priority=1,
        ))
    reg.register(ServingRuntime(
        name="kubeflow-tpu-causal-lm", supported_formats=("causal-lm", "llm"),
        factory=LMRuntimeModel, priority=1,
    ))
    # continuous batching (the vLLM-backend analog): concurrent requests
    # share one running decode batch — same data path, engine underneath
    reg.register(ServingRuntime(
        name="kubeflow-tpu-causal-lm-engine",
        supported_formats=("causal-lm-engine", "vllm"),
        factory=LMEngineModel, priority=1,
    ))
    reg.register(ServingRuntime(
        name="kubeflow-tpu-bert", supported_formats=("bert", "huggingface"),
        factory=BertRuntimeModel, priority=1,
    ))
    reg.register(ServingRuntime(
        name="kubeflow-tpu-bert-tiny", supported_formats=("bert-tiny",),
        factory=lambda name, path, **kw: BertRuntimeModel(
            name, path, config=bert_tiny(), **kw),
        priority=0,
    ))
    return reg
