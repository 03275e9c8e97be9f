"""Composed InferenceService: transformer + predictor + explainer. A copy
of ``kubeflow_tpu/serve/composite.py``.

Reference analog: KServe's transformer and explainer COMPONENTS ([kserve]
pkg/apis/serving/v1beta1/component.go — UNVERIFIED, mount empty, SURVEY.md
§0): a transformer is its own service that pre-processes the raw request,
calls the predictor over HTTP, and post-processes the response; an
explainer answers the ``:explain`` verb.

Here the components compose in process around the predictor's forward (a
network hop between a tokenizer and a model resident on the card would
dwarf the forward itself). The observable contract is the same: the
transformer's pre/postprocess bracket the predictor's full lifecycle;
``:explain`` routes to the explainer. ``__call__`` is synchronous, as the
port's ``Model.__call__`` is: the port's server runs a thread a request.
"""

from __future__ import annotations

from typing import Any, Mapping

from kubeflow_tpu_torch.serve.model import Model, retire as _retire_or_unload


class ComposedService(Model):
    """transformer.preprocess → predictor(load/pre/predict/post) →
    transformer.postprocess; ``explain`` → explainer."""

    def __init__(
        self,
        name: str,
        predictor: Model,
        *,
        transformer: Model | None = None,
        explainer: Model | None = None,
    ):
        self.name = name
        self.predictor = predictor
        self.transformer = transformer
        self.explainer = explainer

    @property
    def components(self) -> list[Model]:
        return [
            m for m in (self.transformer, self.predictor, self.explainer)
            if m is not None
        ]

    @property
    def ready(self) -> bool:
        return all(m.ready for m in self.components)

    @ready.setter
    def ready(self, value: bool) -> None:
        pass  # readiness is derived from the components

    def load(self) -> bool:
        for m in self.components:
            if not m.ready:
                m.load()
        return True

    def unload(self) -> None:
        for m in self.components:
            m.unload()

    def retire(self) -> None:
        for m in self.components:
            _retire_or_unload(m)

    # -- data path (batcher-compatible lifecycle) ----------------------- #

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        if self.transformer is not None:
            payload = self.transformer.preprocess(payload, headers)
        return self.predictor.preprocess(payload, headers)

    def predict(self, inputs: Any, headers=None) -> Any:
        return self.predictor.predict(inputs, headers)

    def postprocess(self, outputs: Any, headers=None) -> Any:
        out = self.predictor.postprocess(outputs, headers)
        if self.transformer is not None:
            out = self.transformer.postprocess(out, headers)
        return out

    def explain(self, payload: Any, headers=None) -> Any:
        # the transformer brackets every verb's input, as it does predict:
        # an explainer (or a predictor's own explain) sees the payload the
        # model scores
        if self.transformer is not None:
            payload = self.transformer.preprocess(payload, headers)
        if self.explainer is not None:
            return self.explainer.explain(payload, headers)
        return self.predictor.explain(payload, headers)

    def __call__(self, payload: Any, headers=None) -> Any:
        if self.transformer is not None:
            payload = self.transformer.preprocess(payload, headers)
        out = self.predictor(payload, headers)
        if self.transformer is not None:
            out = self.transformer.postprocess(out, headers)
        return out
