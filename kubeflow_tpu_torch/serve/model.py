"""Serving model base: the ``load / preprocess / predict / postprocess``
lifecycle of ``kubeflow_tpu/serve/model.py:Model`` (KServe's ``Model``),
trimmed to what ``LMEngineModel`` needs."""

from __future__ import annotations

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
