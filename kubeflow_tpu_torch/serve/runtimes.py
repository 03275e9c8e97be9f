"""Serving runtimes of the port: the text tokenizer and the registry that
resolves a model format to its runtime (the JAX
``kubeflow_tpu/serve/runtimes.py``, LM half).

Two runtimes are registered, as in the JAX ``default_registry``:

- ``kubeflow-tpu-causal-lm`` (formats ``causal-lm``, ``llm``):
  :class:`~kubeflow_tpu_torch.serve.generate.LMRuntimeModel`, one
  whole-generation program per request bucket;
- ``kubeflow-tpu-causal-lm-engine`` (``causal-lm-engine``, ``vllm``):
  :class:`~kubeflow_tpu_torch.serve.engine.LMEngineModel`, continuous
  batching.

The JAX package's other runtimes are not ported yet: resolving their
formats raises ``NotImplementedError`` naming the ROADMAP item (BERT:
queue 1 item 8; sklearn, XGBoost, LightGBM and PMML: item 11).
"""

from __future__ import annotations

import re
import zlib

from kubeflow_tpu_torch.serve.spec import RuntimeRegistry, ServingRuntime

_BERT = "the BERT runtime is not ported yet (ROADMAP queue 1 item 8)"
_CLASSIC = "the {} runtime is not ported yet (ROADMAP queue 1 item 11)"

#: format or runtime name → why it does not resolve in the port
UNPORTED_RUNTIMES = {
    "bert": _BERT, "huggingface": _BERT, "bert-tiny": _BERT,
    "kubeflow-tpu-bert": _BERT, "kubeflow-tpu-bert-tiny": _BERT,
    **{fmt: _CLASSIC.format(fmt)
       for fmt in ("sklearn", "xgboost", "lightgbm", "pmml")},
    **{f"kubeflow-tpu-{fmt}": _CLASSIC.format(fmt)
       for fmt in ("sklearn", "xgboost", "lightgbm", "pmml")},
}


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


def default_registry() -> RuntimeRegistry:
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.generate import LMRuntimeModel

    reg = RuntimeRegistry(unported=UNPORTED_RUNTIMES)
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
    return reg
