"""ServingRuntime and predictor specs: the port of
``kubeflow_tpu/serve/spec.py``'s runtime half.

A ``ServingRuntime`` maps model formats to a ``Model`` factory (KServe
maps them to a container image); a ``RuntimeRegistry`` resolves a
component's format, or its explicit runtime name, to the
highest-priority runtime. Components carry no ``mesh``: multi-card
serving is not ported yet (ROADMAP queue 1 item 10).
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
    """ClusterServingRuntime lookup: format → highest-priority runtime.
    ``unported`` maps formats whose runtimes the port does not have yet
    to the reason, which resolving them raises as
    ``NotImplementedError``."""

    def __init__(self, unported: Mapping[str, str] | None = None):
        self._runtimes: dict[str, ServingRuntime] = {}
        self._unported = dict(unported or {})

    def register(self, rt: ServingRuntime) -> None:
        self._runtimes[rt.name] = rt

    def resolve(self, spec: ComponentSpec) -> ServingRuntime:
        if spec.runtime is not None:
            if spec.runtime in self._unported:
                raise NotImplementedError(self._unported[spec.runtime])
            try:
                return self._runtimes[spec.runtime]
            except KeyError:
                raise ValueError(f"unknown runtime '{spec.runtime}'") from None
        candidates = [
            rt for rt in self._runtimes.values()
            if spec.model_format in rt.supported_formats
        ]
        if not candidates:
            if spec.model_format in self._unported:
                raise NotImplementedError(self._unported[spec.model_format])
            raise ValueError(f"no runtime supports format '{spec.model_format}'")
        return max(candidates, key=lambda rt: rt.priority)
