"""Backend pool: the gateway's view of real server replicas. The port of
``kubeflow_tpu/gateway/backends.py``: the same breaker, ejection, drain
and selection rules, probed over the standard library's ``http.client``
(the reference probes with aiohttp).

Reference analogs: Envoy's cluster model as Istio deploys it (endpoint
health checking, outlier detection, circuit breaking — SURVEY.md §2.2) and
Knative's revision-backed endpoints. A ``Backend`` is one live
``ModelServer`` process addressed by URL; the pool owns everything about
its fitness to receive traffic:

- **readiness probing** — ``GET /v2/health/ready`` on an interval; a
  backend that fails ``eject_threshold`` consecutive probes is ejected
  (outlier detection) and re-admitted on the first passing probe;
- **circuit breaking** — request outcomes drive a per-backend breaker:
  ``failure_threshold`` consecutive failures open it, after ``recovery_s``
  it goes half-open and admits ONE trial request; success closes it,
  failure re-opens. Open/half-open state is visible on /metrics so a
  flapping replica is diagnosable from the edge;
- **drain-aware removal** — ``drain()`` stops new selection immediately
  and removes the backend once its last in-flight request releases, so
  rolling restarts are lossless;
- **least-outstanding selection** — the balancer picks the eligible
  backend with the fewest in-flight requests (round-robin among ties, a
  counter rather than RNG so routing stays deterministic and seedless).

The JAX pool runs on one event loop; the port's gateway serves a thread
a connection and probes from a thread of its own, so every method of
:class:`BackendPool` takes the pool's re-entrant ``lock``, and callers
that read a backend's breaker alongside a pick hold it too.
"""

from __future__ import annotations

import dataclasses
import functools
import http.client
import json
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from kubeflow_tpu_torch.obs import names, prom

BREAKER_OPEN = prom.REGISTRY.gauge(
    names.GATEWAY_BREAKER_OPEN,
    "1 while this backend's circuit breaker is open or half-open",
    ("backend",),
)
BREAKER_OPENS = prom.REGISTRY.counter(
    names.GATEWAY_BREAKER_OPENS_TOTAL,
    "closed-to-open breaker transitions",
    ("backend",),
)
BACKENDS_READY = prom.REGISTRY.gauge(
    names.GATEWAY_BACKENDS_READY,
    "backends currently eligible for selection",
    ("service",),
)


def _locked(fn):
    """Run a :class:`BackendPool` method under the pool's lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3
    recovery_s: float = 5.0


class CircuitBreaker:
    """Per-backend request-outcome state machine (closed → open → half-open).

    ``clock`` is injectable so tests drive recovery without sleeping.
    """

    def __init__(
        self,
        config: BreakerConfig | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or BreakerConfig()
        self._clock = clock
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._trial_in_flight = False

    def current_state(self) -> str:
        """State after applying the open→half-open time transition."""
        if (
            self.state == "open"
            and self._clock() - self._opened_at >= self.config.recovery_s
        ):
            self.state = "half_open"
            self._trial_in_flight = False
        return self.state

    def allow(self) -> bool:
        """May a request be dispatched now? Half-open grants exactly one
        trial at a time; the trial's outcome decides the next state."""
        st = self.current_state()
        if st == "closed":
            return True
        if st == "half_open" and not self._trial_in_flight:
            self._trial_in_flight = True
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._trial_in_flight = False
        self.state = "closed"

    def record_failure(self) -> bool:
        """Returns True when this failure TRANSITIONS the breaker to open
        (callers count distinct opens, not every failed request)."""
        self.consecutive_failures += 1
        st = self.current_state()
        if st == "half_open":
            self.state = "open"
            self._opened_at = self._clock()
            self._trial_in_flight = False
            return False  # re-open of an already-tripped breaker
        if st == "closed" and (
            self.consecutive_failures >= self.config.failure_threshold
        ):
            self.state = "open"
            self._opened_at = self._clock()
            return True
        return False


@dataclasses.dataclass
class Backend:
    """One addressable server replica behind the gateway."""

    url: str
    service: str
    revision: str = "default"  # "default" | "canary"
    #: disaggregated-serving role: "both" replicas take any traffic,
    #: "decode" replicas take client traffic but skip prefill work (they
    #: pull KV spans from a peer), "prefill" replicas NEVER receive
    #: client requests — the gateway only hands their URL to decode
    #: replicas via the x-kft-prefill-peer header
    role: str = "both"  # "both" | "prefill" | "decode"
    state: str = "active"  # "active" | "draining"
    outstanding: int = 0
    probe_ok: bool = True  # optimistic until the first probe says otherwise
    consecutive_probe_failures: int = 0
    breaker: CircuitBreaker = dataclasses.field(default_factory=CircuitBreaker)

    def view(self) -> dict:
        return {
            "url": self.url,
            "service": self.service,
            "revision": self.revision,
            "role": self.role,
            "state": self.state,
            "outstanding": self.outstanding,
            "probe_ok": self.probe_ok,
            "breaker": self.breaker.current_state(),
        }


class BackendPool:
    """All backends the gateway may route to, keyed by service."""

    def __init__(
        self,
        *,
        breaker: BreakerConfig | None = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 2.0,
        eject_threshold: int = 3,
        on_ready: Callable[[str], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._breaker_cfg = breaker or BreakerConfig()
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.eject_threshold = eject_threshold
        #: called with the service name whenever a backend becomes eligible
        #: again (probe recovery, breaker close, new backend) — the
        #: activator flushes its parked queue off this signal
        self.on_ready = on_ready
        self._clock = clock
        self._backends: dict[str, list[Backend]] = {}
        self._rr: dict[str, int] = {}  # tie-break rotation per service
        #: guards membership, counters and breakers (a thread a connection)
        self.lock = threading.RLock()

    # -- membership ------------------------------------------------------ #

    @_locked
    def add(
        self,
        service: str,
        url: str,
        *,
        revision: str = "default",
        role: str = "both",
    ) -> Backend:
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown backend role: {role!r}")
        existing = self.find(url)
        if existing is not None:
            # re-add of a draining/known URL revives it in place
            existing.state = "active"
            existing.service = service
            existing.revision = revision
            existing.role = role
            self._notify_ready(service)
            return existing
        b = Backend(
            url=url.rstrip("/"),
            service=service,
            revision=revision,
            role=role,
            breaker=CircuitBreaker(self._breaker_cfg, clock=self._clock),
        )
        self._backends.setdefault(service, []).append(b)
        self._refresh_ready_gauge(service)
        self._notify_ready(service)
        return b

    @_locked
    def find(self, url: str) -> Backend | None:
        url = url.rstrip("/")
        for blist in self._backends.values():
            for b in blist:
                if b.url == url:
                    return b
        return None

    @_locked
    def drain(self, url: str) -> None:
        """Stop selecting the backend; it is removed once its in-flight
        count hits zero (lossless rolling-restart removal)."""
        b = self.find(url)
        if b is None:
            return
        b.state = "draining"
        if b.outstanding == 0:
            self._remove(b)
        self._refresh_ready_gauge(b.service)

    @_locked
    def remove(self, url: str) -> None:
        b = self.find(url)
        if b is not None:
            self._remove(b)

    def _remove(self, b: Backend) -> None:
        blist = self._backends.get(b.service, [])
        if b in blist:
            blist.remove(b)
        self._refresh_ready_gauge(b.service)

    @_locked
    def services(self) -> list[str]:
        return sorted(self._backends)

    @_locked
    def backends_of(self, service: str) -> list[Backend]:
        return list(self._backends.get(service, []))

    # -- selection ------------------------------------------------------- #

    @_locked
    def selectable(self, service: str, revision: str | None = None) -> list[Backend]:
        """Backends eligible for new traffic (active, probe-healthy; the
        breaker filter happens in ``pick`` so half-open trials stay single).
        Prefill-role backends are never traffic-eligible: they only serve
        ``kv_span:prefill`` pulls from their decode peers."""
        return [
            b
            for b in self._backends.get(service, [])
            if b.state == "active"
            and b.probe_ok
            and b.role != "prefill"
            and (revision is None or b.revision == revision)
        ]

    @_locked
    def pick_prefill(self, service: str) -> Backend | None:
        """Least-outstanding healthy prefill-pool backend for a service,
        or None when the service runs colocated (no prefill backends —
        the common case, and the disagg fallback when every prefill
        replica is ejected/tripped)."""
        cands = [
            b
            for b in self._backends.get(service, [])
            if b.role == "prefill"
            and b.state == "active"
            and b.probe_ok
            and b.breaker.current_state() == "closed"
        ]
        if not cands:
            return None
        return min(cands, key=lambda b: (b.outstanding, b.url))

    @_locked
    def pick(
        self, service: str, revision: str | None = None,
        *, exclude: Backend | None = None,
    ) -> Backend | None:
        """Least-outstanding-requests among breaker-closed backends;
        falls back to granting one half-open trial when nothing is closed.
        ``exclude`` drops one backend from consideration when siblings
        exist (mid-stream failover must prefer a peer over the replica
        that just died, but a lone backend is still better than nothing —
        the watchdog may already be restarting its engine)."""
        base = self.selectable(service, revision)
        if exclude is not None and any(b is not exclude for b in base):
            base = [b for b in base if b is not exclude]
        closed = [b for b in base if b.breaker.current_state() == "closed"]
        if closed:
            low = min(b.outstanding for b in closed)
            tied = [b for b in closed if b.outstanding == low]
            i = self._rr.get(service, 0)
            self._rr[service] = i + 1
            return tied[i % len(tied)]
        # every healthy backend is tripped: probe the least-loaded one
        # whose breaker grants a trial (half-open single-request semantics)
        for b in sorted(base, key=lambda b: (b.outstanding, b.url)):
            if b.breaker.allow():
                return b
        return None

    @_locked
    def acquire(self, b: Backend) -> None:
        b.outstanding += 1

    @_locked
    def release(self, b: Backend) -> None:
        b.outstanding -= 1
        if b.state == "draining" and b.outstanding <= 0:
            self._remove(b)

    # -- request outcomes ------------------------------------------------ #

    @_locked
    def record(self, b: Backend, ok: bool) -> None:
        if ok:
            was_open = b.breaker.state != "closed"
            b.breaker.record_success()
            BREAKER_OPEN.labels(backend=b.url).set(0)
            if was_open:
                self._notify_ready(b.service)
        else:
            if b.breaker.record_failure():
                BREAKER_OPENS.labels(backend=b.url).inc()
            BREAKER_OPEN.labels(backend=b.url).set(
                0 if b.breaker.state == "closed" else 1
            )
        self._refresh_ready_gauge(b.service)

    # -- probing --------------------------------------------------------- #

    def probe_all(self) -> None:
        """One probe sweep over every backend (the gateway's probe thread
        calls this every ``probe_interval_s``), the probes in parallel,
        each bounded by ``probe_timeout_s``."""
        with self.lock:
            backends = [b for bl in self._backends.values() for b in bl]
        if not backends:
            return
        with ThreadPoolExecutor(max_workers=min(16, len(backends))) as ex:
            oks = list(ex.map(self.probe_one, backends))
        for b, ok in zip(backends, oks):
            self.observe_probe(b, ok)

    def probe_one(self, b: Backend) -> bool:
        """``GET /v2/health/ready`` answered 200 with ``"ready": true``."""
        u = urllib.parse.urlsplit(b.url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80, timeout=self.probe_timeout_s)
        try:
            conn.request("GET", u.path.rstrip("/") + "/v2/health/ready")
            resp = conn.getresponse()
            body = resp.read()
            return resp.status == 200 and bool(json.loads(body).get("ready"))
        except (OSError, http.client.HTTPException, ValueError, AttributeError):
            return False
        finally:
            conn.close()

    @_locked
    def observe_probe(self, b: Backend, ok: bool) -> None:
        """Fold one probe result into ejection state (also the unit-test
        seam — tests drive ejection without HTTP)."""
        if ok:
            b.consecutive_probe_failures = 0
            if not b.probe_ok:
                b.probe_ok = True
                self._notify_ready(b.service)
        else:
            b.consecutive_probe_failures += 1
            if b.consecutive_probe_failures >= self.eject_threshold:
                b.probe_ok = False  # outlier ejected until a probe passes
        self._refresh_ready_gauge(b.service)

    # -- plumbing -------------------------------------------------------- #

    @_locked
    def ready_count(self, service: str) -> int:
        return len(
            [
                b
                for b in self.selectable(service)
                if b.breaker.current_state() != "open"
            ]
        )

    def _refresh_ready_gauge(self, service: str) -> None:
        BACKENDS_READY.labels(service=service).set(self.ready_count(service))

    def _notify_ready(self, service: str) -> None:
        self._refresh_ready_gauge(service)
        if self.on_ready is not None and self.ready_count(service) > 0:
            self.on_ready(service)

    @_locked
    def view(self) -> list[dict]:
        return [
            b.view()
            for svc in sorted(self._backends)
            for b in self._backends[svc]
        ]
