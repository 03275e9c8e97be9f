"""Serving model base: the ``load / preprocess / predict / postprocess``
lifecycle of ``kubeflow_tpu/serve/model.py:Model`` (KServe's ``Model``),
trimmed to what the LM runtimes need, and ``BucketSpec``, the closed set
of padded shapes a runtime serves."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Mapping


class Model:
    """Base serving model: subclass and override the lifecycle hooks.

    The server calls ``preprocess → predict → postprocess`` per request;
    ``load()`` runs once before the model is marked ready.
    """

    def __init__(self, name: str):
        self.name = name
        self.ready = False

    def load(self) -> bool:
        self.ready = True
        return self.ready

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        return payload

    def predict(self, inputs: Any, headers: Mapping[str, str] | None = None) -> Any:
        raise NotImplementedError

    def postprocess(self, outputs: Any, headers: Mapping[str, str] | None = None) -> Any:
        return outputs

    def unload(self) -> None:
        self.ready = False

    def __call__(self, payload: Any, headers: Mapping[str, str] | None = None) -> Any:
        x = self.preprocess(payload, headers)
        return self.postprocess(self.predict(x, headers), headers)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Closed set of padded shapes a runtime serves.

    ``batch_sizes`` and ``seq_lens`` must be sorted ascending. A request
    of shape (b, s) is padded up to the smallest bucket >= it; an
    oversize request raises.
    """

    batch_sizes: tuple[int, ...] = (1, 4, 16)
    seq_lens: tuple[int, ...] = (32, 128, 512)

    def bucket_batch(self, n: int) -> int:
        i = bisect.bisect_left(self.batch_sizes, n)
        if i == len(self.batch_sizes):
            raise ValueError(f"batch {n} exceeds max bucket {self.batch_sizes[-1]}")
        return self.batch_sizes[i]

    def bucket_seq(self, n: int) -> int:
        i = bisect.bisect_left(self.seq_lens, n)
        if i == len(self.seq_lens):
            raise ValueError(f"seq {n} exceeds max bucket {self.seq_lens[-1]}")
        return self.seq_lens[i]
