"""ServingRuntime and predictor specs: the port of
``kubeflow_tpu/serve/spec.py``'s runtime half.

A ``ServingRuntime`` maps model formats to a ``Model`` factory (KServe
maps them to a container image); a ``RuntimeRegistry`` resolves a
component's format, or its explicit runtime name, to the
highest-priority runtime. Components carry no ``mesh`` yet: a
tensor-parallel model takes its mesh directly (``LMEngineModel(mesh=)``),
and the controller that would read a component's waits for ROADMAP
queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping


@dataclasses.dataclass
class ServingRuntime:
    """Maps a model format to a concrete ``Model`` factory
    ``(name, storage_path, **kwargs) -> Model``."""

    name: str
    supported_formats: tuple[str, ...]
    factory: Callable[..., Any]
    priority: int = 0


@dataclasses.dataclass
class ComponentSpec:
    """One InferenceService component (predictor, transformer or
    explainer)."""

    model_format: str | None = None
    storage_uri: str | None = None
    runtime: str | None = None  # an explicit ServingRuntime name
    min_replicas: int = 1  # 0 = scale-to-zero
    max_replicas: int = 1
    scale_target: int = 1  # target in-flight requests per replica
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PredictorSpec(ComponentSpec):
    canary_traffic_percent: int = 100


class RuntimeRegistry:
    """ClusterServingRuntime lookup: format → highest-priority runtime."""

    def __init__(self):
        self._runtimes: dict[str, ServingRuntime] = {}

    def register(self, rt: ServingRuntime) -> None:
        self._runtimes[rt.name] = rt

    def resolve(self, spec: ComponentSpec) -> ServingRuntime:
        if spec.runtime is not None:
            try:
                return self._runtimes[spec.runtime]
            except KeyError:
                raise ValueError(f"unknown runtime '{spec.runtime}'") from None
        candidates = [
            rt for rt in self._runtimes.values()
            if spec.model_format in rt.supported_formats
        ]
        if not candidates:
            raise ValueError(f"no runtime supports format '{spec.model_format}'")
        return max(candidates, key=lambda rt: rt.priority)
