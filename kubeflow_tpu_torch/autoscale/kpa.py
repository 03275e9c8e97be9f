"""KPA-style serving recommender: concurrency-targeted replica counts. A
copy of ``kubeflow_tpu/autoscale/kpa.py`` (pure Python, no JAX).

Reference analog: Knative's Pod Autoscaler (SURVEY.md §2.2 — the
``autoscaler`` deployment the activator kicks). The mechanics reproduced
here, each load-bearing for the burst acceptance e2e:

- **two windows over one signal** — observed concurrency (in-flight +
  queued + activator-parked) is averaged over a long *stable* window and
  a short *panic* window. The stable average sets the steady-state size;
  the panic average exists so a sudden burst is seen in seconds, not
  after a minute of averaging.
- **panic mode** — when the panic window alone demands
  ``panic_threshold``× the current capacity, the autoscaler panics: it
  scales to the panic demand immediately and REFUSES to scale down until
  the panic condition has been quiet for a full stable window (flapping
  up/down inside a burst is how replicas thrash).
- **scale to zero** — only outside panic, only when ``min_replicas == 0``,
  and only after ``scale_to_zero_grace_s`` of zero observed concurrency.
  The activator (gateway/activator.py) owns the wake-up path: its parked
  queue depth feeds back into the observed concurrency, so the first
  request after idle drives the recommendation back to 1.
- **rate limits** — one evaluation may grow capacity at most
  ``max_scale_up_rate``× and shrink it at most ``max_scale_down_rate``×,
  so a noisy signal cannot slam the replica count around.

Everything is fake-clock-drivable: ``observe``/``recommend`` take an
explicit ``now`` so tests pin window edges without wall sleeps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class KPAConfig:
    """Per-service autoscaling policy (the Knative annotation set)."""

    #: target in-flight requests per replica (Knative
    #: ``autoscaling.knative.dev/target``)
    target: float = 1.0
    min_replicas: int = 1  # 0 = scale-to-zero eligible
    max_replicas: int = 1
    stable_window_s: float = 60.0
    panic_window_s: float = 6.0
    #: panic when the panic-window demand alone reaches this multiple of
    #: current capacity (Knative panic-threshold-percentage / 100)
    panic_threshold: float = 2.0
    #: one evaluation may at most grow capacity by this factor…
    max_scale_up_rate: float = 1000.0
    #: …and shrink it by this factor (2.0 = halve at most)
    max_scale_down_rate: float = 2.0
    #: zero observed concurrency for this long before dropping to zero
    scale_to_zero_grace_s: float = 30.0

    def validate(self) -> "KPAConfig":
        if self.target <= 0:
            raise ValueError(f"target must be > 0, got {self.target}")
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                f"bad replica bounds min={self.min_replicas} "
                f"max={self.max_replicas}"
            )
        if not 0 < self.panic_window_s <= self.stable_window_s:
            raise ValueError(
                f"panic window {self.panic_window_s} must be in "
                f"(0, stable window {self.stable_window_s}]"
            )
        if self.panic_threshold < 1.0:
            raise ValueError(
                f"panic_threshold must be >= 1, got {self.panic_threshold}"
            )
        if self.max_scale_up_rate < 1.0 or self.max_scale_down_rate < 1.0:
            raise ValueError("scale rates must be >= 1")
        return self

    @classmethod
    def from_manifest(cls, d: dict) -> "KPAConfig":
        """camelCase ``autoscaling:`` manifest section → config."""
        return cls(
            target=float(d.get("target", 1.0)),
            min_replicas=int(d.get("minReplicas", 1)),
            max_replicas=int(
                d.get("maxReplicas", max(1, int(d.get("minReplicas", 1))))
            ),
            stable_window_s=float(d.get("stableWindowS", 60.0)),
            panic_window_s=float(d.get("panicWindowS", 6.0)),
            panic_threshold=float(d.get("panicThreshold", 2.0)),
            max_scale_up_rate=float(d.get("maxScaleUpRate", 1000.0)),
            max_scale_down_rate=float(d.get("maxScaleDownRate", 2.0)),
            scale_to_zero_grace_s=float(d.get("scaleToZeroGraceS", 30.0)),
        ).validate()


class _Window:
    """Timestamped samples with windowed averaging. One deque serves both
    window lengths (panic ⊆ stable); samples older than the longest
    window are pruned on every observe."""

    def __init__(self, max_window_s: float):
        self.max_window_s = max_window_s
        self._samples: deque[tuple[float, float]] = deque()

    def observe(self, now: float, value: float) -> None:
        self._samples.append((now, value))
        cutoff = now - self.max_window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def average(self, now: float, window_s: float) -> float:
        """Mean of samples inside ``(now - window_s, now]``; 0 when the
        window is empty (no evidence of demand is evidence of none)."""
        cutoff = now - window_s
        vals = [v for t, v in self._samples if t > cutoff and t <= now]
        return sum(vals) / len(vals) if vals else 0.0


@dataclasses.dataclass(frozen=True)
class Recommendation:
    desired: int
    stable_concurrency: float
    panic_concurrency: float
    panic: bool


class KPARecommender:
    """One service's sizing state machine. ``observe`` feeds the signal,
    ``recommend`` evaluates it against the current ready count."""

    def __init__(
        self,
        config: KPAConfig | None = None,
        *,
        clock=time.monotonic,
    ):
        self.config = (config or KPAConfig()).validate()
        self._clock = clock
        self._window = _Window(self.config.stable_window_s)
        #: first observe/recommend instant — scale-to-zero requires a full
        #: grace window of OBSERVED idleness, so a recommender created
        #: long after its service went quiet (autoscaler restart, slow
        #: warmup) cannot zero it on the first tick
        self._first_eval_at: float | None = None
        #: last instant with observed demand (nonzero concurrency or an
        #: explicit activity() poke) — the scale-to-zero grace anchor
        self._last_active_at: float | None = None
        #: last instant the panic condition held; panic mode persists for
        #: a stable window past it
        self._last_panic_at: float | None = None
        #: high-water desired while panicking — panic never scales down
        self._panic_peak = 0

    def observe(self, concurrency: float, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        if self._first_eval_at is None:
            self._first_eval_at = now
        self._window.observe(now, float(concurrency))
        if concurrency > 0:
            self._last_active_at = now

    def activity(self, now: float | None = None) -> None:
        """External demand marker (the activator's cold-episode kick):
        resets the scale-to-zero grace clock even before the queued
        request shows up in a scraped concurrency sample."""
        self._last_active_at = self._clock() if now is None else now

    @property
    def panicking(self) -> bool:
        return self._last_panic_at is not None

    def recommend(self, ready: int, now: float | None = None) -> Recommendation:
        now = self._clock() if now is None else now
        if self._first_eval_at is None:
            self._first_eval_at = now
        cfg = self.config
        stable_c = self._window.average(now, cfg.stable_window_s)
        panic_c = self._window.average(now, cfg.panic_window_s)
        want_stable = math.ceil(stable_c / cfg.target)
        want_panic = math.ceil(panic_c / cfg.target)

        # -- panic entry/exit -------------------------------------------- #
        if (
            want_panic > ready
            and want_panic >= cfg.panic_threshold * max(ready, 1)
        ):
            self._last_panic_at = now
            self._panic_peak = max(self._panic_peak, want_panic, ready)
        elif (
            self._last_panic_at is not None
            and now - self._last_panic_at >= cfg.stable_window_s
        ):
            self._last_panic_at = None
            self._panic_peak = 0
        panic = self._last_panic_at is not None

        if panic:
            # scale to the burst immediately; never down while panicking
            want = max(want_stable, want_panic, self._panic_peak)
            self._panic_peak = max(self._panic_peak, want)
        else:
            want = want_stable

        # -- rate limits vs current capacity ----------------------------- #
        if ready > 0:
            want = min(want, math.ceil(ready * cfg.max_scale_up_rate))
            if not panic:
                want = max(
                    want, math.floor(ready / cfg.max_scale_down_rate)
                )

        # -- scale-to-zero gate ------------------------------------------ #
        if want <= 0:
            idle_anchor = (
                self._last_active_at
                if self._last_active_at is not None
                else self._first_eval_at
            )
            if ready == 0:
                want = 0  # already at zero with no demand: stay there
            elif (
                cfg.min_replicas == 0
                and not panic
                and now - idle_anchor >= cfg.scale_to_zero_grace_s
            ):
                want = 0
            else:
                want = 1  # hold the last replica through the grace window

        desired = max(cfg.min_replicas, min(want, cfg.max_replicas))
        return Recommendation(
            desired=desired,
            stable_concurrency=stable_c,
            panic_concurrency=panic_c,
            panic=panic,
        )
