"""Engine watchdog: detect a wedged or dead LMEngine and restart it. A
copy of ``kubeflow_tpu/serve/watchdog.py`` on the port's own registry.

Reference analogs: vLLM's async-engine health loop (the engine's event
loop dying fails all requests fast and marks the server unhealthy) and
Kubernetes' liveness-probe + restart supervision, applied to the one
component of a serving replica that can wedge without its process dying:
the decode scheduler thread blocked inside a device call.

Detection (``tick()``, driven by a daemon monitor thread or directly by
tests with an injected clock — no wall sleeps needed):

- **wedged** — the engine has work (active rows / queued admissions /
  prefills in flight) but its loop heartbeat has not advanced for more
  than ``max(min_wedge_s, wedge_factor × decode-gap EWMA)``. The EWMA
  term adapts the trip point to the replica's real chunk cadence; the
  floor keeps legitimate first-compile stalls (tens of seconds on a cold
  model) from false-tripping — tighten it after warmup.
- **loop_dead** — the scheduler thread exited without ``stop()``.
- **fatal** — the loop's crash handler recorded a fatal error.

Recovery (supervised restart, in trip order):

1. readiness flips FALSE first (``on_ready(False)`` → the model's
   ``/v2/health/ready`` goes 503, so the gateway's outlier ejection
   routes around the replica while it rebuilds);
2. every in-flight and queued request fails NOW with
   :class:`EngineRestarting` — a *retryable* error (plain 503, no
   ``Retry-After``) so the gateway's retry budget re-lands the work on a
   healthy replica instead of the client eating a timeout;
3. the engine is rebuilt from scratch (fresh KV cache, pager, prefix
   cache, carry — ``rebuild()``) and readiness restores. The wedged old
   thread is *abandoned*, not joined: it observes its engine's stop flag
   whenever the device call returns and exits on its own; the new engine
   shares nothing with it.

``kft_engine_watchdog_trips_total{model,reason}`` and
``kft_engine_restarts_total{model}`` count every trip/restart on the
shared registry AND in ``stats`` (exported on the owning ModelServer's
``/metrics`` so per-replica smoke assertions work cross-process).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

from kubeflow_tpu_torch.obs import names, prom

logger = logging.getLogger(__name__)

WATCHDOG_TRIPS = prom.REGISTRY.counter(
    names.ENGINE_WATCHDOG_TRIPS_TOTAL,
    "engine watchdog trips (wedged / loop_dead / fatal)",
    ("model", "reason"),
)
ENGINE_RESTARTS = prom.REGISTRY.counter(
    names.ENGINE_RESTARTS_TOTAL,
    "supervised engine restarts (device state rebuilt)",
    ("model",),
)


class EngineRestarting(RuntimeError):
    """The watchdog is tearing this engine down and rebuilding it.

    RETRYABLE by contract: the request did not fail on its own merits,
    the replica under it did — the gateway should re-dispatch it to a
    healthy backend (mapped to a bare 503, no ``Retry-After``)."""


@dataclasses.dataclass
class WatchdogConfig:
    """Trip thresholds. ``min_wedge_s`` must exceed the longest legitimate
    device stall — on a cold replica that is the first chunk compile, so
    the default is generous; deployments that warm up at load time can
    drop it to a few seconds for sub-second detection of real wedges."""

    interval_s: float = 0.5
    wedge_factor: float = 8.0
    min_wedge_s: float = 30.0
    #: wedge detection holds off this long after a restart: the rebuilt
    #: engine recompiles its programs on first traffic (a legitimate
    #: multi-second stall), and tripping on it would cascade restarts
    post_restart_grace_s: float = 30.0


class EngineWatchdog:
    """Monitors one engine slot (``get_engine`` resolves it each tick, so
    the restart swapping in a new engine is transparent) and supervises
    its restart via ``rebuild`` (must return the NEW started engine).

    ``on_ready(bool)`` flips the owning model's readiness; ``clock`` is
    injectable so tests drive trips without wall time.
    """

    def __init__(
        self,
        get_engine: Callable[[], Any],
        rebuild: Callable[[Exception], Any],
        *,
        on_ready: Callable[[bool], None] | None = None,
        config: WatchdogConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        model_name: str = "lm",
    ):
        self.get_engine = get_engine
        self.rebuild = rebuild
        self.on_ready = on_ready or (lambda ready: None)
        self.config = config or WatchdogConfig()
        self.clock = clock
        self.model_name = model_name
        self.stats: dict[str, Any] = {"trips": {}, "restarts": 0}
        self._last_restart_at: float | None = None
        #: a trip whose rebuild raised: retried on every tick until a
        #: rebuild succeeds (the replica stays not-ready meanwhile)
        self._rebuild_pending: Exception | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: serializes trip handling: the monitor thread and a test-driven
        #: tick() must not both rebuild the same wedged engine
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------- #

    def start(self) -> "EngineWatchdog":
        self._thread = threading.Thread(
            target=self._run, name=f"engine-watchdog-{self.model_name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.exception("engine watchdog tick failed")

    # -- detection -------------------------------------------------------- #

    def wedge_threshold_s(self, engine) -> float:
        gap_ms = float(engine.overlap.get("decode_gap_ms", 0.0))
        return max(
            self.config.min_wedge_s,
            self.config.wedge_factor * gap_ms / 1e3,
        )

    def _diagnose(self, engine) -> str | None:
        if engine._fatal is not None:
            return "fatal"
        if engine._stop.is_set():
            return None  # deliberate shutdown, not a fault
        thread = engine._thread
        if thread is not None and not thread.is_alive():
            return "loop_dead"
        if engine.busy():
            if (
                self._last_restart_at is not None
                and self.clock() - self._last_restart_at
                < self.config.post_restart_grace_s
            ):
                return None  # rebuilt engine is recompiling: not a wedge
            stalled = self.clock() - engine.heartbeat()
            if stalled > self.wedge_threshold_s(engine):
                return "wedged"
        return None

    def tick(self) -> str | None:
        """One detection pass; returns the trip reason (after handling it)
        or None. Safe to call directly from tests with a fake clock."""
        with self._lock:
            if self._rebuild_pending is not None:
                # a previous trip's rebuild failed: keep trying — the
                # replica is not-ready (routed around) until one succeeds
                self._finish_restart(self._rebuild_pending)
                return None
            engine = self.get_engine()
            if engine is None:
                return None
            reason = self._diagnose(engine)
            if reason is None:
                return None
            self._trip(engine, reason)
            return reason

    # -- recovery --------------------------------------------------------- #

    def _trip(self, engine, reason: str) -> None:
        WATCHDOG_TRIPS.labels(model=self.model_name, reason=reason).inc()
        self.stats["trips"][reason] = self.stats["trips"].get(reason, 0) + 1
        logger.error(
            "engine watchdog TRIP model=%s reason=%s (heartbeat stalled "
            "%.1fs, threshold %.1fs)",
            self.model_name, reason,
            self.clock() - engine.heartbeat(),
            self.wedge_threshold_s(engine),
        )
        # readiness FIRST: the gateway stops routing here before the
        # in-flight failures land, so retries go somewhere healthy
        self.on_ready(False)
        err = EngineRestarting(
            f"engine for {self.model_name!r} restarting after watchdog "
            f"trip ({reason})"
        )
        err.__cause__ = engine._fatal
        engine.poison(err)
        self._finish_restart(err)

    def _finish_restart(self, err: Exception) -> None:
        try:
            self.rebuild(err)
        except Exception:
            # rebuild failed: stay not-ready (the gateway keeps routing
            # around us); every subsequent tick retries the rebuild
            self._rebuild_pending = err
            logger.exception(
                "engine rebuild failed for %s; replica stays not-ready, "
                "will retry",
                self.model_name,
            )
            return
        self._rebuild_pending = None
        ENGINE_RESTARTS.labels(model=self.model_name).inc()
        self.stats["restarts"] += 1
        self._last_restart_at = self.clock()
        self.on_ready(True)
        logger.warning(
            "engine for %s restarted (restart #%d)",
            self.model_name, self.stats["restarts"],
        )
