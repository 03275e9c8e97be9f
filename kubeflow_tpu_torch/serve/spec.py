"""InferenceService and ServingRuntime declarative specs: a copy of
``kubeflow_tpu/serve/spec.py``.

Reference analog: [kserve] pkg/apis/serving/v1beta1/{inference_service,
predictor,component}.go and v1alpha1/servingruntime_types.go (UNVERIFIED,
mount empty, SURVEY.md §0). Semantics preserved:

- predictor / transformer / explainer component specs;
- min/maxReplicas + scaleTarget (concurrency) autoscaling knobs,
  minReplicas=0 ⇒ scale-to-zero;
- canary traffic percent on the predictor;
- ServingRuntime decouples model format → runtime implementation.

A component carries a ``MeshSpec`` (``core/mesh.py``), kept on the spec
as in the reference: neither controller hands it to a factory yet (a
tensor-parallel model takes its mesh directly, ``LMEngineModel(mesh=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from kubeflow_tpu_torch.core.mesh import MeshSpec


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
    mesh: MeshSpec | None = None
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PredictorSpec(ComponentSpec):
    canary_traffic_percent: int = 100


@dataclasses.dataclass
class InferenceServiceSpec:
    name: str
    predictor: PredictorSpec
    transformer: ComponentSpec | None = None
    explainer: ComponentSpec | None = None
    namespace: str = "default"

    def validate(self) -> None:
        if not self.name:
            raise ValueError("InferenceService needs a name")
        p = self.predictor
        if p.min_replicas < 0 or p.max_replicas < max(1, p.min_replicas):
            raise ValueError(
                f"bad replica bounds min={p.min_replicas} max={p.max_replicas}"
            )
        if not (0 <= p.canary_traffic_percent <= 100):
            raise ValueError("canaryTrafficPercent must be 0..100")
        if p.model_format is None and p.runtime is None:
            raise ValueError("predictor needs model_format or explicit runtime")

    @classmethod
    def from_manifest(cls, manifest: Mapping[str, Any]) -> "InferenceServiceSpec":
        """Reference-style InferenceService manifest → spec.

        Accepts the KServe v1beta1 shape: ``spec.predictor.model`` with
        ``modelFormat.name`` / ``storageUri`` / ``runtime``, replica bounds,
        ``canaryTrafficPercent``; optional transformer/explainer components.
        """
        if manifest.get("kind", "InferenceService") != "InferenceService":
            raise ValueError(f"not an InferenceService: {manifest.get('kind')!r}")
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})

        def component(d: Mapping[str, Any], klass):
            model = d.get("model", d)
            fmt = model.get("modelFormat")
            if isinstance(fmt, Mapping):
                fmt = fmt.get("name")
            kw = dict(
                model_format=fmt,
                storage_uri=model.get("storageUri"),
                runtime=model.get("runtime"),
                min_replicas=int(d.get("minReplicas", 1)),
                max_replicas=int(d.get("maxReplicas", max(1, int(d.get("minReplicas", 1))))),
                scale_target=int(d.get("scaleTarget", 1)),
                # runtime-specific keyword arguments ride the manifest; the
                # controller forwards them to the runtime's factory
                extra=dict(model.get("extra", {})),
            )
            if klass is PredictorSpec:
                kw["canary_traffic_percent"] = int(
                    d.get("canaryTrafficPercent", 100)
                )
            return klass(**kw)

        pred = spec.get("predictor")
        if not pred:
            raise ValueError("InferenceService manifest has no spec.predictor")
        out = cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            predictor=component(pred, PredictorSpec),
            transformer=(
                component(spec["transformer"], ComponentSpec)
                if spec.get("transformer")
                else None
            ),
            explainer=(
                component(spec["explainer"], ComponentSpec)
                if spec.get("explainer")
                else None
            ),
        )
        out.validate()
        return out


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
