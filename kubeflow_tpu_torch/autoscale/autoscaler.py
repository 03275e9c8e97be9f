"""The serving autoscaler: close the loop from live signals to replicas.
The port of ``kubeflow_tpu/autoscale/autoscaler.py`` on threads, in the
idiom of the port's gateway: ``tick_service``/``tick`` are plain calls,
``start()`` runs them on a tick thread every ``tick_interval_s`` and
``stop()`` ends it, and one ``threading.Lock`` a service serialises its
ticks (the reference's ``asyncio.Lock``).

Knative-KPA analog, colocated with the gateway the way Knative colocates
the autoscaler with the activator's stat stream:

    signals (replica /metrics + activator depth)
        → KPARecommender (stable/panic windows over the concurrency target)
        → actuator (ReplicaFleet launches/drains replicas)

The activator's cold-episode ``scale_up`` kick is wired to :meth:`kick`,
which the activator calls from a request thread: it marks demand and
runs one immediate tick on a worker thread of its own, so scale-from-zero
does not wait out a tick interval while a client sits parked, and the
request thread never waits on a replica launch.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

from kubeflow_tpu_torch.autoscale.kpa import KPAConfig, KPARecommender
from kubeflow_tpu_torch.autoscale.signals import ServiceSignals
from kubeflow_tpu_torch.obs import names, prom

logger = logging.getLogger(__name__)

#: the longest ``stop`` waits for a tick in flight (a replica launch on
#: the card takes seconds)
STOP_JOIN_S = 300.0

DESIRED = prom.REGISTRY.gauge(
    names.AUTOSCALER_DESIRED_REPLICAS,
    "recommender's current desired replica count",
    ("service",),
)
STABLE_CONCURRENCY = prom.REGISTRY.gauge(
    names.AUTOSCALER_STABLE_CONCURRENCY,
    "stable-window average observed concurrency",
    ("service",),
)
PANIC_CONCURRENCY = prom.REGISTRY.gauge(
    names.AUTOSCALER_PANIC_CONCURRENCY,
    "panic-window average observed concurrency",
    ("service",),
)
PANIC_MODE = prom.REGISTRY.gauge(
    names.AUTOSCALER_PANIC_MODE,
    "1 while the service is in panic mode (scale-down frozen)",
    ("service",),
)
SCALE_EVENTS = prom.REGISTRY.counter(
    names.AUTOSCALER_SCALE_EVENTS_TOTAL,
    "actuated replica-count changes",
    ("service", "direction"),
)


class _ServiceState:
    def __init__(
        self,
        name: str,
        config: KPAConfig,
        signals,
        actuator,
        clock,
    ):
        self.name = name
        self.signals = signals
        self.actuator = actuator
        self.recommender = KPARecommender(config, clock=clock)
        #: serializes ticks per service: a kick-triggered tick and the
        #: interval tick must not actuate the same service concurrently
        self.lock = threading.Lock()
        self.last: ServiceSignals | None = None
        self.last_recommendation = None


@dataclasses.dataclass
class TickResult:
    service: str
    desired: int
    current: int
    concurrency: float
    panic: bool


class ServingAutoscaler:
    """Owns one recommender per service and drives their actuators.

    ``signals`` is a callable → :class:`ServiceSignals`; ``actuator``
    exposes ``current() -> int`` and ``scale_to(n) -> None``
    (autoscale/fleet.py ReplicaFleet is the production one). ``clock`` is
    injectable for fake-clock tests."""

    def __init__(
        self,
        *,
        tick_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.tick_interval_s = tick_interval_s
        self._clock = clock
        self._services: dict[str, _ServiceState] = {}
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()
        #: out-of-band tick threads started by kick(), joined by stop()
        self._kicks: list[threading.Thread] = []
        self._kicks_lock = threading.Lock()

    def add_service(
        self,
        name: str,
        config: KPAConfig,
        signals: Callable[[], ServiceSignals],
        actuator: Any,
    ) -> None:
        self._services[name] = _ServiceState(
            name, config, signals, actuator, self._clock
        )

    def services(self) -> list[str]:
        return sorted(self._services)

    # -- the control loop ------------------------------------------------ #

    def kick(self, service: str) -> None:
        """The activator's cold-episode scale-up hook: mark demand and
        tick NOW (a parked client should not wait out the interval), on a
        worker thread, so the caller returns at once. Safe to call for
        unknown services (the activator may front services we do not
        scale)."""
        st = self._services.get(service)
        if st is None:
            return
        st.recommender.activity()
        t = threading.Thread(target=self.tick_service, args=(service,),
                             name=f"autoscaler-kick-{service}", daemon=True)
        with self._kicks_lock:
            self._kicks = [k for k in self._kicks if k.is_alive()]
            self._kicks.append(t)
        t.start()

    def tick_service(
        self, service: str, now: float | None = None
    ) -> TickResult | None:
        st = self._services.get(service)
        if st is None:
            return None
        with st.lock:
            now = self._clock() if now is None else now
            try:
                sig = st.signals()
            except Exception:  # noqa: BLE001 — a scrape must not kill the loop
                logger.exception("autoscaler: signal scrape failed for %s",
                                 service)
                return None
            st.last = sig
            st.recommender.observe(sig.concurrency, now=now)
            current = int(st.actuator.current())
            rec = st.recommender.recommend(current, now=now)
            st.last_recommendation = rec
            DESIRED.labels(service=service).set(rec.desired)
            STABLE_CONCURRENCY.labels(service=service).set(
                rec.stable_concurrency
            )
            PANIC_CONCURRENCY.labels(service=service).set(
                rec.panic_concurrency
            )
            PANIC_MODE.labels(service=service).set(1 if rec.panic else 0)
            if rec.desired != current:
                direction = "up" if rec.desired > current else "down"
                SCALE_EVENTS.labels(
                    service=service, direction=direction
                ).inc()
                logger.warning(
                    "autoscaler: %s %s %d -> %d (concurrency=%.2f "
                    "stable=%.2f panic=%.2f%s)",
                    service, direction, current, rec.desired,
                    sig.concurrency, rec.stable_concurrency,
                    rec.panic_concurrency, " PANIC" if rec.panic else "",
                )
                try:
                    st.actuator.scale_to(rec.desired)
                except Exception:  # noqa: BLE001 — retried next tick
                    logger.exception(
                        "autoscaler: scale_to(%d) failed for %s",
                        rec.desired, service,
                    )
            return TickResult(
                service=service,
                desired=rec.desired,
                current=current,
                concurrency=sig.concurrency,
                panic=rec.panic,
            )

    def tick(self, now: float | None = None) -> list[TickResult]:
        out = []
        for name in self.services():
            r = self.tick_service(name, now=now)
            if r is not None:
                out.append(r)
        return out

    def _run(self) -> None:
        """The interval loop: tick, then wait ``tick_interval_s`` or until
        :meth:`stop`."""
        while not self._stopping.is_set():
            self.tick()
            self._stopping.wait(self.tick_interval_s)

    def start(self) -> "ServingAutoscaler":
        if self._thread is None:
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._run, name="autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """End the tick thread and wait (at most ``STOP_JOIN_S`` each) for
        it and every kick's tick: a tick in flight finishes its scale
        operation rather than leaving the fleet half-changed."""
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(STOP_JOIN_S)
            self._thread = None
        with self._kicks_lock:
            kicks, self._kicks = self._kicks, []
        for t in kicks:
            t.join(STOP_JOIN_S)

    # -- introspection (dashboard /api/autoscaler) ----------------------- #

    def view(self) -> dict:
        out = {}
        for name, st in sorted(self._services.items()):
            rec = st.last_recommendation
            cfg = st.recommender.config
            out[name] = {
                "config": {
                    "target": cfg.target,
                    "min_replicas": cfg.min_replicas,
                    "max_replicas": cfg.max_replicas,
                    "stable_window_s": cfg.stable_window_s,
                    "panic_window_s": cfg.panic_window_s,
                    "panic_threshold": cfg.panic_threshold,
                    "scale_to_zero_grace_s": cfg.scale_to_zero_grace_s,
                },
                "current": int(st.actuator.current()),
                "desired": rec.desired if rec else None,
                "panic": bool(rec.panic) if rec else False,
                "stable_concurrency": (
                    rec.stable_concurrency if rec else 0.0
                ),
                "panic_concurrency": rec.panic_concurrency if rec else 0.0,
                "signals": dataclasses.asdict(st.last) if st.last else None,
            }
        return out
