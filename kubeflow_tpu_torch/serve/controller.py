"""InferenceService controller: reconcile InferenceService specs into
served models. A copy of ``kubeflow_tpu/serve/controller.py`` for a
threaded server.

Reference analog: [kserve] pkg/controller/v1beta1/inferenceservice/
{controller.go, reconcilers/{knative,raw,hpa}/} (UNVERIFIED, mount empty,
SURVEY.md §0). The reference reconciles each component into either a Knative
Service (serverless, scale-to-zero) or a raw Deployment+HPA. Without a
cluster, a "replica" here is a model a ``ModelServer`` can host plus an
autoscaler state machine with the same observable semantics:

- desired replicas ∈ [min, max], driven by in-flight concurrency vs
  ``scale_target`` (the Knative/KPA-style signal, ``autoscale/kpa.py``);
- minReplicas=0 ⇒ scale-to-zero after an idle window (the weights leave
  the card), cold-start on the next request (the activator path);
- canary: traffic split between ``default`` and ``canary`` model versions
  by ``canary_traffic_percent``, per request id the gateway's own salted
  hash (``gateway/router.py`` ``canary_slot``).

Threads: the port's server and gateway run a thread a request, and the
gateway's probe thread reads the services while ``apply`` changes them
(the JAX controller lives on one event loop). One lock guards the service
and recommender tables, readers iterate :meth:`services`' snapshot, each
``ReplicaSet`` has a lock of its own for ``route`` and
``autoscale_tick``, and ``apply``/``delete``/``promote_canary`` run one
at a time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import tempfile
import threading
import time

from kubeflow_tpu_torch.autoscale.kpa import KPAConfig, KPARecommender
from kubeflow_tpu_torch.gateway.router import canary_slot
from kubeflow_tpu_torch.serve import storage as storage_mod
from kubeflow_tpu_torch.serve.model import Model, retire as _retire
from kubeflow_tpu_torch.serve.spec import InferenceServiceSpec, RuntimeRegistry


@dataclasses.dataclass
class ReplicaSet:
    """Autoscaler state for one InferenceService component."""

    ready_replicas: int = 0
    desired_replicas: int = 0
    in_flight: int = 0
    last_request_ts: float = 0.0
    cold_starts: int = 0
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)


def _component_key(c) -> tuple | None:
    if c is None:
        return None
    return (c.model_format, c.storage_uri, c.runtime, dict(c.extra))


def _mat_key(spec_or_predictor) -> tuple:
    """What determines the materialised model; a change ⇒ reload. Accepts
    the full spec (predictor, transformer and explainer all count) or a
    bare component."""
    s = spec_or_predictor
    if hasattr(s, "predictor"):
        return (
            _component_key(s.predictor),
            _component_key(s.transformer),
            _component_key(s.explainer),
        )
    return _component_key(s)


@dataclasses.dataclass
class ServiceState:
    spec: InferenceServiceSpec
    default_model: Model | None = None
    canary_model: Model | None = None
    default_key: tuple | None = None
    canary_key: tuple | None = None
    replicas: ReplicaSet = dataclasses.field(default_factory=ReplicaSet)
    conditions: list[str] = dataclasses.field(default_factory=list)

    @property
    def ready(self) -> bool:
        return self.default_model is not None and self.default_model.ready


class InferenceServiceController:
    def __init__(
        self,
        registry: RuntimeRegistry,
        *,
        model_dir: str | None = None,
        idle_scale_to_zero_s: float = 30.0,
        rng: random.Random | None = None,
        canary_salt: str = "kft-canary",
        model_mesh=None,
    ):
        self.registry = registry
        #: where ``storage_uri``s are downloaded, one directory a spec hash
        self.model_dir = model_dir or os.path.join(
            tempfile.gettempdir(), "kubeflow_tpu_torch_models")
        self.idle_scale_to_zero_s = idle_scale_to_zero_s
        self._services: dict[str, ServiceState] = {}
        #: per-service KPA recommenders (autoscale/kpa.py) driving
        #: autoscale_tick — window state survives across ticks
        self._recommenders: dict[str, KPARecommender] = {}
        self._rng = rng or random.Random(0)
        #: salts the per-request-id canary hash (the gateway's split
        #: family); seedable so tests pin the cohort
        self.canary_salt = canary_salt
        #: optional ModelMesh (serve/modelmesh.py): when set, predictors are
        #: registered rather than loaded, so N services share one memory
        #: budget with on-demand loads and LRU eviction
        self.model_mesh = model_mesh
        #: guards ``_services`` and ``_recommenders`` (short holds)
        self._lock = threading.Lock()
        #: one apply / delete / promotion at a time (materialising loads)
        self._apply_lock = threading.RLock()

    # -- CRD-ish API --------------------------------------------------------

    def apply(self, spec: InferenceServiceSpec) -> ServiceState:
        spec.validate()
        key = f"{spec.namespace}/{spec.name}"
        with self._apply_lock:
            with self._lock:
                prev = self._services.get(key)
                st = ServiceState(spec=spec)
                if prev is not None:
                    # rollout: previous default becomes the stable side of
                    # a canary
                    st.default_model = prev.default_model
                    st.default_key = prev.default_key
                    st.canary_model = prev.canary_model
                    st.canary_key = prev.canary_key
                    st.replicas = prev.replicas
                self._services[key] = st
            self.reconcile(key)
            return st

    def delete(self, name: str, namespace: str = "default") -> None:
        with self._apply_lock:
            with self._lock:
                st = self._services.pop(f"{namespace}/{name}", None)
            if st:
                for m in (st.default_model, st.canary_model):
                    if m is not None:
                        _retire(m)

    def get(self, name: str, namespace: str = "default") -> ServiceState:
        with self._lock:
            return self._services[f"{namespace}/{name}"]

    def services(self) -> list[tuple[str, ServiceState]]:
        """A snapshot of ``(namespace/name, state)``, for readers on other
        threads (the gateway's route table feed)."""
        with self._lock:
            return list(self._services.items())

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, key: str) -> None:
        with self._apply_lock:
            with self._lock:
                st = self._services[key]
            self._reconcile(st)

    def _reconcile(self, st: ServiceState) -> None:
        spec = st.spec
        p = spec.predictor
        canary_pct = p.canary_traffic_percent

        new_key = _mat_key(spec)
        if st.default_model is None:
            # first deploy: the new spec is the default, whatever the pct
            st.default_model = self._materialise(spec)
            st.default_key = new_key
            st.conditions.append("PredictorReady")
        elif canary_pct == 100:
            # plain rollout: a changed spec replaces the default outright
            if st.default_key != new_key:
                old = st.default_model
                st.default_model = self._materialise(spec)
                st.default_key = new_key
                if old is not None:
                    _retire(old)
                st.conditions.append("PredictorReady")
            if st.canary_model is not None:
                _retire(st.canary_model)
                st.canary_model, st.canary_key = None, None
        else:
            # canary rollout: new spec serves pct% alongside the old default
            if st.canary_key != new_key:
                old = st.canary_model
                st.canary_model = self._materialise(spec)
                st.canary_key = new_key
                if old is not None:
                    _retire(old)
                st.conditions.append("PredictorReady")

        rs = st.replicas
        with rs.lock:
            # reconcile preserves the current scale (the autoscaler owns
            # sizing). A service idled to zero stays at zero across a
            # re-apply: the next request cold-starts it through the
            # activator path.
            if (rs.ready_replicas == 0 and p.min_replicas == 0
                    and rs.last_request_ts > 0):
                want = 0
            else:
                want = max(rs.ready_replicas, 1)
            rs.desired_replicas = max(p.min_replicas, min(want, p.max_replicas))
            if rs.ready_replicas == 0 and rs.desired_replicas > 0:
                rs.ready_replicas = rs.desired_replicas
        st.conditions.append("Ready")

    def _materialise(self, spec: InferenceServiceSpec) -> Model:
        predictor = self._materialise_component(
            spec, spec.predictor, spec.name
        )
        if spec.transformer is None and spec.explainer is None:
            return predictor
        # transformer/explainer components compose in process around the
        # predictor (serve/composite.py)
        from kubeflow_tpu_torch.serve.composite import ComposedService

        transformer = (
            self._materialise_component(
                spec, spec.transformer, f"{spec.name}-transformer"
            )
            if spec.transformer is not None
            else None
        )
        explainer = (
            self._materialise_component(
                spec, spec.explainer, f"{spec.name}-explainer"
            )
            if spec.explainer is not None
            else None
        )
        return ComposedService(
            spec.name, predictor, transformer=transformer, explainer=explainer
        )

    def _materialise_component(self, spec, comp, name: str) -> Model:
        rt = self.registry.resolve(comp)
        spec_hash = hashlib.sha256(
            repr(_component_key(comp)).encode()
        ).hexdigest()[:12]
        local_path = None
        if comp.storage_uri is not None:
            # download dir keyed by spec hash: identical components (e.g. a
            # predictor and explainer sharing one checkpoint) download once
            local_path = storage_mod.download(
                comp.storage_uri, os.path.join(self.model_dir, spec_hash)
            )
        if self.model_mesh is not None:
            from kubeflow_tpu_torch.serve.modelmesh import MeshBackedModel

            # mesh key = (service, spec hash): identical components within
            # a service (predictor + explainer on one checkpoint) share one
            # resident copy, and ModelMesh registrations are refcounted so
            # a rollout's retire of the old materialisation never takes
            # down a new one sharing the same component
            return MeshBackedModel(
                self.model_mesh,
                name,
                lambda: rt.factory(name, local_path, **dict(comp.extra)),
                key=f"{spec.namespace}/{spec.name}@{spec_hash}",
            )
        model = rt.factory(name, local_path, **dict(comp.extra))
        if not model.ready:
            model.load()
        return model

    # -- traffic / autoscaling ---------------------------------------------

    def route(
        self,
        name: str,
        namespace: str = "default",
        request_id: str | None = None,
    ) -> Model:
        """Pick default vs canary per the traffic split; handles cold start.

        With a ``request_id`` the split is a deterministic salted hash of
        the id (exactly the gateway's edge decision): a retried request
        re-hashes to the same revision and cannot flap mid-rollout, while
        the split stays exactly pct in expectation over distinct ids.
        Without an id the seeded RNG decides.
        """
        st = self.get(name, namespace)
        rs = st.replicas
        with rs.lock:
            if rs.ready_replicas == 0:  # scaled to zero: activator cold start
                rs.cold_starts += 1
                rs.ready_replicas = 1
                if st.default_model is not None and not st.default_model.ready:
                    st.default_model.load()
            rs.last_request_ts = time.monotonic()
            pct = st.spec.predictor.canary_traffic_percent
            if st.canary_model is not None:
                if request_id is not None:
                    take_canary = canary_slot(request_id, self.canary_salt) < pct
                else:
                    take_canary = self._rng.uniform(0, 100) < pct
                if take_canary:
                    return st.canary_model
            return st.default_model

    def promote_canary(self, name: str, namespace: str = "default") -> None:
        with self._apply_lock:
            st = self.get(name, namespace)
            if st.canary_model is None:
                return
            old = st.default_model
            st.default_model, st.canary_model = st.canary_model, None
            st.default_key, st.canary_key = st.canary_key, None
            st.spec.predictor.canary_traffic_percent = 100
            if old is not None:
                _retire(old)

    def _recommender_for(self, key: str, p) -> KPARecommender:
        """The service's KPA recommender, with its config refreshed from
        the live predictor spec (operators change scale_target and replica
        bounds between ticks; window state must survive the change)."""
        cfg = KPAConfig(
            target=float(max(p.scale_target, 1)),
            min_replicas=p.min_replicas,
            max_replicas=max(p.max_replicas, 1),
            scale_to_zero_grace_s=self.idle_scale_to_zero_s,
        )
        with self._lock:
            rec = self._recommenders.get(key)
            if rec is None:
                rec = self._recommenders[key] = KPARecommender(cfg)
            else:
                rec.config = cfg.validate()
            return rec

    def autoscale_tick(self, name: str, namespace: str = "default") -> int:
        """One autoscaler evaluation; returns the new ready replica count.

        Each tick feeds the observed in-flight concurrency into the KPA
        recommender's stable and panic windows and actuates the
        recommendation. Activity (``route()`` stamping
        ``last_request_ts``) anchors the scale-to-zero grace window, so a
        service that just served a request never drops to zero early. At
        zero replicas every revision unloads: its weights leave the card."""
        key = f"{namespace}/{name}"
        st = self.get(name, namespace)
        p, rs = st.spec.predictor, st.replicas
        rec = self._recommender_for(key, p)
        with rs.lock:
            rec.observe(rs.in_flight)
            if rs.last_request_ts > 0:
                # demand anywhere since the last tick holds the last
                # replica through the grace window
                rec._last_active_at = max(
                    rec._last_active_at or 0.0, rs.last_request_ts
                )
            r = rec.recommend(rs.ready_replicas)
            rs.desired_replicas = r.desired
            rs.ready_replicas = rs.desired_replicas
            if rs.ready_replicas == 0:  # release the card when scaled to zero
                for m in (st.default_model, st.canary_model):
                    if m is not None:
                        m.unload()
            return rs.ready_replicas
