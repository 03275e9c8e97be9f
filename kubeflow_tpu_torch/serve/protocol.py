"""Inference protocol codecs, v1 and v2 (Open Inference Protocol): the
port's copy of ``kubeflow_tpu/serve/protocol.py``.

- v1:  ``POST /v1/models/<m>:predict``  body ``{"instances": [...]}``
       → ``{"predictions": [...]}``
- v2:  ``POST /v2/models/<m>/infer``    body ``{"inputs": [{name, shape,
       datatype, data}]}`` → ``{"outputs": [...]}``.

Codecs are pure (dict ↔ numpy); the HTTP layer stays thin.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

# Open Inference Protocol datatype ↔ numpy. BF16 is wire-encoded as uint16
# words (no native JSON bf16); the receiving model reinterprets.
_V2_TO_NP = {
    "BOOL": np.bool_,
    "UINT8": np.uint8,
    "UINT16": np.uint16,
    "UINT32": np.uint32,
    "UINT64": np.uint64,
    "INT8": np.int8,
    "INT16": np.int16,
    "INT32": np.int32,
    "INT64": np.int64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
    "BYTES": np.object_,
}
_NP_TO_V2 = {np.dtype(v).name: k for k, v in _V2_TO_NP.items() if k != "BYTES"}
_NP_TO_V2["bfloat16"] = "BF16"


@dataclasses.dataclass
class InferTensor:
    """One named tensor in a v2 request/response."""

    name: str
    data: np.ndarray

    @classmethod
    def from_v2(cls, obj: Mapping[str, Any]) -> "InferTensor":
        dt = obj["datatype"].upper()
        if dt == "BF16":
            arr = np.asarray(obj["data"], np.uint16).reshape(obj["shape"])
        else:
            arr = np.asarray(obj["data"], _V2_TO_NP[dt]).reshape(obj["shape"])
        return cls(name=obj["name"], data=arr)

    def to_v2(self) -> dict[str, Any]:
        arr = np.asarray(self.data)
        dt = _NP_TO_V2.get(arr.dtype.name, "FP32")
        if dt == "BF16":
            data = arr.view(np.uint16).reshape(-1).tolist()  # wire = u16 words
        else:
            data = arr.reshape(-1).tolist()
        return {
            "name": self.name,
            "shape": list(arr.shape),
            "datatype": dt,
            "data": data,
        }


def decode_v1(body: Mapping[str, Any]) -> list[Any]:
    if "instances" not in body:
        raise ValueError("v1 request must contain 'instances'")
    return list(body["instances"])


def encode_v1(predictions: Any) -> dict[str, Any]:
    if isinstance(predictions, Mapping) and "predictions" in predictions:
        return dict(predictions)
    if isinstance(predictions, np.ndarray):
        predictions = predictions.tolist()
    return {"predictions": predictions}


def decode_v2(body: Mapping[str, Any]) -> dict[str, np.ndarray]:
    if "inputs" not in body:
        raise ValueError("v2 request must contain 'inputs'")
    return {t["name"]: InferTensor.from_v2(t).data for t in body["inputs"]}


def rows_from_named(tensors: Mapping[str, np.ndarray]) -> list[Any]:
    """Named batch-major v2 tensors → per-instance rows for the batcher.

    The batcher coalesces instances across requests, so each row must be
    self-contained. A lone tensor (any name) stays the legacy plain-row
    form; multi-input requests become per-instance dicts carrying every
    named tensor, so ``attention_mask``/``token_type_ids`` survive the
    data plane instead of being silently dropped.
    """
    if not tensors:
        raise ValueError("v2 request has no input tensors")
    if len(tensors) == 1:
        return list(np.asarray(next(iter(tensors.values()))))
    # Multi-input: one dict row per batch element carrying EVERY named
    # tensor. Which names a model requires (e.g. BERT's input_ids) is the
    # model's business, not this codec's — the protocol layer only checks
    # that batch dims agree.
    arrays = {k: np.asarray(v) for k, v in tensors.items()}
    sizes = {k: a.shape[0] if a.ndim else 0 for k, a in arrays.items()}
    n = next(iter(sizes.values()))
    if any(sz != n for sz in sizes.values()):
        raise ValueError(f"input batch dims disagree: {sizes}")
    return [{k: a[i] for k, a in arrays.items()} for i in range(n)]


def encode_v2(
    model_name: str, outputs: Mapping[str, Any] | Sequence[InferTensor] | np.ndarray
) -> dict[str, Any]:
    if isinstance(outputs, np.ndarray):
        tensors = [InferTensor("output_0", outputs)]
    elif isinstance(outputs, Mapping):
        tensors = [InferTensor(k, np.asarray(v)) for k, v in outputs.items()]
    else:
        tensors = list(outputs)
    return {"model_name": model_name, "outputs": [t.to_v2() for t in tensors]}
