"""Serving plane of the port (the KServe equivalent), laid out as
``kubeflow_tpu/serve``:

- ``model``      — ``Model`` lifecycle (load/preprocess/predict/postprocess)
                   and ``TorchModel``, weights resident on the card and a
                   bucketed forward.
- ``protocol``   — v1 (``:predict``) and v2 / Open Inference codecs.
- ``server``     — the stdlib ``ModelServer`` (a thread a connection).
- ``tokenizer``  — WordPiece from vocab.txt (the kserve-bert data path).
- ``batcher``    — request batching (max batch size / max latency).
- ``logger``     — CloudEvents-style request/response logging.
- ``storage``    — storage-initializer (``file://``, ``registry://``).
- ``spec``       — ``InferenceService`` / ``ServingRuntime`` declarative specs.
- ``controller`` — InferenceService reconciler: replicas, autoscaling,
                   scale-to-zero, canary traffic split.
- ``composite``  — transformer/explainer components composed in process
                   around the predictor.
- ``graph``      — ``InferenceGraph`` sequence/switch/ensemble/splitter routing.
- ``modelmesh``  — many registered models under one memory budget, LRU
                   loads and evictions.
- ``generate``   — the ``causal-lm`` runtime (dense KV cache).
- ``engine``     — the continuous-batching LM engine (paged pool, prefix
                   cache, chunked prefill, SSE streaming, load shedding,
                   tensor-parallel serving).
- ``runtimes``, ``xgboost_runtime``, ``lightgbm_runtime``,
  ``pmml_runtime``, ``sklearn_runtime`` — the registry and its runtimes.

The names below are exported as the JAX package exports them (``TorchModel``
for ``JAXModel``; the ``ModelServer`` is its own dataplane). They import
on first use, so importing one submodule does not load the engine.
"""

import importlib

_EXPORTS = {
    "Model": "model",
    "TorchModel": "model",
    "BucketSpec": "model",
    "ModelServer": "server",
    "InferenceServiceSpec": "spec",
    "PredictorSpec": "spec",
    "ComponentSpec": "spec",
    "ServingRuntime": "spec",
    "InferenceServiceController": "controller",
    "ComposedService": "composite",
    "GraphSpec": "graph",
    "InferenceGraph": "graph",
    "RequestLogger": "logger",
    "MeshBackedModel": "modelmesh",
    "ModelMesh": "modelmesh",
    "LMEngine": "engine",
    "LMEngineConfig": "engine",
    "LMEngineModel": "engine",
    "EngineOverloaded": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
