"""High-density multi-model serving — the ModelMesh analog. The port of
``kubeflow_tpu/serve/modelmesh.py``.

Many registered models share one card's memory: a ``ModelMesh`` holds N
*registered* models (factories — cheap), materialises one onto the
device on its first request, measures its device footprint, and
LRU-evicts until the budget holds. Loading is fail-closed per model: a
broken model reports FAILED and never poisons its neighbours.

The footprint is read as the JAX mesh reads it: a model's weights, here
``TorchModel.module``'s parameters and buffers on its device. A model
without such a module (the tabular boosters, whose node arrays are not
weights) counts 0 bytes, as a JAX model without ``_params`` does.

States: REGISTERED (known, not resident) → LOADING → LOADED (weights on
the device) → back to REGISTERED on eviction; FAILED on load error
(sticky until the next explicit load attempt).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Mapping

from kubeflow_tpu_torch.obs import names, prom
from kubeflow_tpu_torch.serve.model import Model

LOAD_FAILURES = prom.REGISTRY.counter(
    names.MODELMESH_LOAD_FAILURES_TOTAL,
    "model loads that raised (per model entry)",
    labels=("model",),
)


class ModelState:
    REGISTERED = "Registered"   # known; weights not resident
    LOADING = "Loading"
    LOADED = "Loaded"           # weights in HBM, serving
    FAILED = "FailedToLoad"


def _device_bytes(model: Model) -> int:
    """Measured device footprint: the bytes of the model's weights
    (``module``'s parameters and buffers)."""
    module = getattr(model, "module", None)
    if module is None:
        return 0
    tensors = list(module.parameters()) + list(module.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


class _Entry:
    def __init__(self, name: str, factory: Callable[[], Model]):
        self.name = name
        self.factory = factory
        self.model: Model | None = None
        self.state = ModelState.REGISTERED
        self.bytes = 0
        self.last_used = 0.0
        self.loads = 0
        self.error: str | None = None
        self.failed_at = 0.0
        self.cooldown_s = 0.0  # jittered per failure; see ModelMesh._fail
        self.pins = 0  # in-flight requests holding the weights resident
        self.refs = 1  # registrations sharing this entry (rollouts, shared
        #              # components) — deregister removes only at zero
        self.draining = False  # deregistered while pinned: unload at unpin


class ModelMesh:
    """LRU-managed registry of models sharing one HBM budget."""

    def __init__(
        self,
        hbm_budget_bytes: int,
        *,
        clock=time.monotonic,
        retry_cooldown_s: float = 5.0,
        retry_jitter: float = 0.2,
        jitter_seed: int | None = None,
    ):
        if hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be positive")
        if not 0.0 <= retry_jitter < 1.0:
            raise ValueError(f"retry_jitter must be in [0, 1), got {retry_jitter}")
        self.budget = int(hbm_budget_bytes)
        self._clock = clock
        self._lock = threading.RLock()
        #: serializes loads: two concurrent loads could each pass the budget
        #: check against only-LOADED residency and jointly overshoot HBM —
        #: the one invariant this class exists to enforce. Loads are rare
        #: and slow (weights → HBM); coarse serialization is the right cost.
        self._load_lock = threading.Lock()
        #: a FAILED load becomes retryable after this long (transient
        #: storage flakes must not be a permanent 503 — see MeshBackedModel).
        #: Each failure draws its own cooldown in
        #: [retry_cooldown_s, retry_cooldown_s * (1 + retry_jitter)) so N
        #: replicas that all failed on the same broken backend desynchronize
        #: instead of re-hammering it in lockstep (thundering-herd retry).
        self.retry_cooldown_s = retry_cooldown_s
        self.retry_jitter = retry_jitter
        self._rng = random.Random(jitter_seed)
        self._entries: dict[str, _Entry] = {}
        #: deregistered-while-pinned entries: their weights are STILL in HBM
        #: until the last unpin drains them, so budget math must see them
        self._draining: list[_Entry] = []
        self.stats: dict[str, int] = {
            "loads": 0, "evictions": 0, "hits": 0, "misses": 0,
        }

    # -- registry ---------------------------------------------------------- #

    def register(self, name: str, factory: Callable[[], Model]) -> None:
        """Make a model servable WITHOUT loading it (density is the point:
        registration is O(1) metadata, HBM is spent only on demand).
        Registrations are REFCOUNTED: a rollout whose new materialisation
        shares the old one's key must survive the old one's deregister."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                self._entries[name] = _Entry(name, factory)
            else:
                e.refs += 1

    def deregister(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return
            e.refs -= 1
            if e.refs > 0:
                return
            self._entries.pop(name)
            if e.pins > 0:
                # an in-flight request holds the weights: unloading now
                # would free params mid-forward — the last unpin drains it,
                # and _draining keeps the bytes visible to budget math
                e.draining = True
                self._draining.append(e)
                return
            model, e.model = e.model, None
        if model is not None:
            model.unload()

    def release(self, name: str) -> None:
        """Evict ``name``'s weights but KEEP the registration — the
        scale-to-zero path: the next request cold-starts it back in. A
        ``deregister`` here would brick the service instead."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.state != ModelState.LOADED or e.pins > 0:
                return
            model, e.model, e.bytes = e.model, None, 0
            e.state = ModelState.REGISTERED
        model.unload()

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def resident(self) -> list[str]:
        with self._lock:
            return sorted(
                n for n, e in self._entries.items()
                if e.state == ModelState.LOADED
            )

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(
                e.bytes for e in self._entries.values()
                if e.state == ModelState.LOADED
            ) + sum(e.bytes for e in self._draining)

    def readiness(self, name: str) -> Mapping[str, Any]:
        with self._lock:
            e = self._entries[name]
            return {
                "name": name,
                "state": e.state,
                "bytes": e.bytes,
                "loads": e.loads,
                "error": e.error,
                "failed_at": e.failed_at,
                "cooldown_s": e.cooldown_s,
            }

    # -- placement ---------------------------------------------------------- #

    def model(self, name: str) -> Model:
        """The serving entry point: resident → touch; else load (evicting
        LRU residents as needed). Raises KeyError for unknown models and
        RuntimeError for models that cannot load or fit. FAILED entries stay
        rejected for ``retry_cooldown_s``, then the next request retries."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(name)
            e = self._entries[name]
            if e.state == ModelState.LOADED:
                e.last_used = self._clock()
                self.stats["hits"] += 1
                return e.model
            if (
                e.state == ModelState.FAILED
                and self._clock() - e.failed_at < e.cooldown_s
            ):
                raise RuntimeError(
                    f"model {name!r} failed to load: {e.error} (retry in "
                    f"{e.cooldown_s:.0f}s)"
                )
        # one load at a time: budget math must never race (see _load_lock)
        with self._load_lock:
            with self._lock:
                if name not in self._entries:
                    raise KeyError(name)
                e = self._entries[name]
                if e.state == ModelState.LOADED:  # a waiter: loaded meanwhile
                    e.last_used = self._clock()
                    self.stats["hits"] += 1
                    return e.model
                self.stats["misses"] += 1
                e.state = ModelState.LOADING
            try:
                model = e.factory()
                if not model.ready:
                    model.load()
                size = _device_bytes(model)
            except Exception as ex:
                self._fail(e, f"{type(ex).__name__}: {ex}")
                raise RuntimeError(
                    f"model {name!r} failed to load: {ex}"
                ) from ex
            with self._lock:
                if self._entries.get(name) is not e:
                    # deregistered while loading: committing would orphan
                    # HBM-resident weights outside all budget accounting
                    model.unload()
                    raise KeyError(name)
                if size > self.budget:
                    self._fail(
                        e, f"model needs {size} bytes > budget {self.budget}"
                    )
                    model.unload()
                    raise RuntimeError(e.error)
                self._evict_locked(need=size, keep=name)
                e.model = model
                e.bytes = size
                e.state = ModelState.LOADED
                e.error = None
                e.loads += 1
                e.last_used = self._clock()
                self.stats["loads"] += 1
                return model

    def _fail(self, e: _Entry, error: str) -> None:
        """Record a load failure: sticky-FAILED with a jittered cooldown."""
        with self._lock:
            e.state = ModelState.FAILED
            e.error = error
            e.failed_at = self._clock()
            e.cooldown_s = self.retry_cooldown_s * (
                1.0 + self._rng.uniform(0.0, self.retry_jitter)
            )
        LOAD_FAILURES.labels(model=e.name).inc()

    def cooldown_remaining(self, name: str) -> float:
        """Seconds until a FAILED entry becomes retryable; 0 when it is
        not FAILED (or unknown). What readiness probes should consult —
        the effective cooldown is per-failure jittered."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.state != ModelState.FAILED:
                return 0.0
            return max(0.0, e.cooldown_s - (self._clock() - e.failed_at))

    def _evict_locked(self, need: int, keep: str) -> None:
        """Evict least-recently-used UNPINNED residents until ``need``
        fits. Pinned entries (in-flight requests) are never evicted —
        pulling params out from under a running forward is a crash."""
        while self.resident_bytes() + need > self.budget:
            victims = [
                e for n, e in self._entries.items()
                if e.state == ModelState.LOADED and n != keep and e.pins == 0
            ]
            if not victims:
                raise RuntimeError(
                    f"cannot fit {need} bytes within budget {self.budget} "
                    "(remaining residents are pinned by in-flight requests)"
                )
            victim = min(victims, key=lambda e: e.last_used)
            victim.model.unload()
            victim.model = None
            victim.bytes = 0
            victim.state = ModelState.REGISTERED
            self.stats["evictions"] += 1

    def pinned(self, name: str):
        """Context manager: load + pin ``name`` for the duration of a
        request, so concurrent loads cannot evict it mid-forward."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            while True:
                model = self.model(name)
                with self._lock:
                    e = self._entries.get(name)
                    # re-check under the lock: an eviction may have struck
                    # between model() returning and the pin landing
                    if (
                        e is not None
                        and e.state == ModelState.LOADED
                        and e.model is model
                    ):
                        e.pins += 1
                        break
            try:
                yield model
            finally:
                # unpin the CAPTURED entry, never a same-name successor — a
                # deregister+re-register cycle must not steal another
                # request's pin
                drain = None
                with self._lock:
                    e.pins -= 1
                    if e.draining and e.pins == 0:
                        drain, e.model = e.model, None
                        e.bytes = 0
                        if e in self._draining:
                            self._draining.remove(e)
                if drain is not None:
                    drain.unload()

        return cm()


class MeshBackedModel(Model):
    """``Model``-shaped proxy over a ModelMesh entry, so the port's
    ``ModelServer`` (serve/server.py) serves mesh-managed models unchanged:
    readiness maps to the mesh state, the data path pulls the model in
    (evicting LRU) on demand. ``serve/controller.py`` places services
    onto the mesh through it (``InferenceServiceController(
    model_mesh=)``)."""

    def __init__(
        self,
        mesh: ModelMesh,
        name: str,
        factory: Callable[[], Model],
        *,
        key: str | None = None,
    ):
        # ``key`` is the mesh registry identity; it must be UNIQUE per
        # materialisation (a controller keys it by spec hash) so that a
        # rollout's new proxy never aliases the old one's factory, and the
        # old proxy's unload() removes only its own entry.
        self.name = name
        self.key = key or name
        self._mesh = mesh
        mesh.register(self.key, factory)

    @property
    def ready(self) -> bool:
        try:
            info = self._mesh.readiness(self.key)
        except KeyError:
            return False
        if info["state"] != ModelState.FAILED:
            # registered-but-not-resident still answers requests (load on
            # first use) — ModelMesh's "available" vs "loaded" distinction
            return True
        # FAILED: not-ready (503) during the cooldown so a broken model
        # doesn't reload-storm; ready again afterwards so the next request
        # reaches mesh.model(), the ONLY retry path from the data plane.
        # The cooldown is the per-failure jittered one, so N replicas that
        # failed together come back staggered.
        return self._mesh.cooldown_remaining(self.key) <= 0.0

    @ready.setter
    def ready(self, value: bool) -> None:
        pass  # state lives in the mesh; Model.__init__-style writes are moot

    def load(self) -> bool:
        self._mesh.model(self.key)
        return True

    def unload(self) -> None:
        """Release residency, KEEP the registration — this is what the
        autoscaler's scale-to-zero calls; the next request cold-starts the
        weights back in. Permanent removal is ``retire()``."""
        self._mesh.release(self.key)

    def retire(self) -> None:
        """Permanently remove from the mesh (service deleted / rolled out)."""
        self._mesh.deregister(self.key)

    def preprocess(self, payload: Any, headers=None) -> Any:
        with self._mesh.pinned(self.key) as m:
            return m.preprocess(payload, headers)

    def predict(self, inputs: Any, headers=None) -> Any:
        with self._mesh.pinned(self.key) as m:
            return m.predict(inputs, headers)

    def postprocess(self, outputs: Any, headers=None) -> Any:
        with self._mesh.pinned(self.key) as m:
            return m.postprocess(outputs, headers)

    def explain(self, payload: Any, headers=None) -> Any:
        with self._mesh.pinned(self.key) as m:
            return m.explain(payload, headers)

    def __call__(self, payload: Any, headers=None) -> Any:
        with self._mesh.pinned(self.key) as m:
            return m(payload, headers)
