"""Open-loop arrival processes: seeded schedules, derived from NO clock.
A copy of ``kubeflow_tpu/loadgen/arrivals.py`` (pure Python): the same
process parameters and seed give the JAX package's schedule float for
float.

The defining property of an open-loop load test (vLLM's
``benchmark_serving`` idiom) is that arrivals do not wait on responses —
a slow server faces the same offered load as a fast one, so latency
degradation shows up as queueing and shedding instead of silently
throttling the client. The schedule is therefore a *value*: a tuple of
offsets from run start, fully determined by the process parameters and
the seed. Nothing here reads a clock and every draw comes from a
``random.Random`` seeded from the process config — two runs with the
same seed offer byte-identical traffic, which is what makes A/B trajectory
numbers comparable across commits.

Three processes:

- :class:`PoissonArrivals` — memoryless exponential gaps at a fixed rate,
  the canonical serving-bench arrival model;
- :class:`OnOffArrivals` — a piecewise-constant modulated Poisson (burst
  windows at ``burst_rps`` alternating with quiet windows at ``base_rps``),
  generated by exact thinning — the bursty diurnal/batch-release shape that
  exercises the autoscaler's panic window;
- :class:`ReplayArrivals` — arrivals reconstructed from a trace dump
  (obs/trace.py ``Tracer.snapshot``): yesterday's production tail
  becomes today's regression load.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Mapping

__all__ = [
    "PoissonArrivals",
    "OnOffArrivals",
    "ReplayArrivals",
    "ReplayRequest",
]


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson process: ``rate_rps`` arrivals/s over
    ``duration_s``, exponential inter-arrival gaps."""

    rate_rps: float
    duration_s: float
    seed: int = 0

    def schedule(self) -> tuple[float, ...]:
        if self.rate_rps <= 0 or self.duration_s <= 0:
            return ()
        rng = random.Random(f"{self.seed}:poisson")
        out: list[float] = []
        t = rng.expovariate(self.rate_rps)
        while t < self.duration_s:
            out.append(t)
            t += rng.expovariate(self.rate_rps)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class OnOffArrivals:
    """Modulated (on-off) Poisson: the rate alternates between
    ``burst_rps`` (for ``on_fraction`` of each ``period_s`` cycle) and
    ``base_rps``. Generated by thinning against ``max(base, burst)`` —
    exact for a piecewise-constant intensity, and every candidate point
    costs the same TWO draws whether accepted or not, so the schedule
    stays identical under parameter changes that don't change the rate
    envelope."""

    base_rps: float
    burst_rps: float
    period_s: float
    duration_s: float
    on_fraction: float = 0.5
    seed: int = 0

    def rate_at(self, t: float) -> float:
        """Offered rate at offset ``t`` — burst inside the on-window."""
        in_on = (t % self.period_s) < self.on_fraction * self.period_s
        return self.burst_rps if in_on else self.base_rps

    def schedule(self) -> tuple[float, ...]:
        peak = max(self.base_rps, self.burst_rps)
        if peak <= 0 or self.duration_s <= 0 or self.period_s <= 0:
            return ()
        rng = random.Random(f"{self.seed}:onoff")
        out: list[float] = []
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            u = rng.random()  # always drawn: keeps the stream aligned
            if t >= self.duration_s:
                return tuple(out)
            if u * peak < self.rate_at(t):
                out.append(t)


@dataclasses.dataclass(frozen=True)
class ReplayRequest:
    """One replayed arrival: when it arrived (offset from the first
    arrival in the dump) and the workload shape its engine span recorded."""

    offset_s: float
    prompt_tokens: int
    max_new_tokens: int
    model: str = ""
    priority: int | None = None
    trace_id: str = ""


def _engine_span(trace: Mapping[str, Any]) -> Mapping[str, Any] | None:
    for span in trace.get("spans", ()):
        if span.get("name") == "engine":
            return span
    return None


@dataclasses.dataclass(frozen=True)
class ReplayArrivals:
    """Arrivals parsed from the EXACT format a trace dump holds
    (``Tracer.snapshot()`` JSON: ``{"traces": [...]}``).

    Reconstruction: a trace's ``wall_time`` is stamped once at finalize
    and ``duration_ms`` spans first-span-start → finalize, so the request
    ARRIVED at ``wall_time - duration_ms/1e3``; the workload shape rides
    the ``engine`` span's ``prompt_tokens``/``max_new_tokens`` attrs.
    Traces without an engine span (health probes, non-generate traffic)
    are skipped. Offsets are re-based to the earliest surviving arrival,
    so replaying reproduces the dump's inter-arrival gaps exactly.
    """

    requests: tuple[ReplayRequest, ...] = ()

    @classmethod
    def from_snapshot(cls, snapshot: Mapping[str, Any]) -> "ReplayArrivals":
        arrivals: list[tuple[float, ReplayRequest]] = []
        for trace in snapshot.get("traces", ()):
            span = _engine_span(trace)
            if span is None:
                continue
            attrs = span.get("attrs", {})
            if "prompt_tokens" not in attrs:
                continue
            wall = float(trace.get("wall_time", 0.0))
            arrived = wall - float(trace.get("duration_ms", 0.0)) / 1e3
            arrivals.append((
                arrived,
                ReplayRequest(
                    offset_s=0.0,  # re-based below
                    prompt_tokens=int(attrs["prompt_tokens"]),
                    max_new_tokens=int(attrs.get("max_new_tokens", 0)),
                    model=str(attrs.get("model", "")),
                    priority=(
                        int(attrs["priority"])
                        if "priority" in attrs else None
                    ),
                    trace_id=str(trace.get("trace_id", "")),
                ),
            ))
        if not arrivals:
            return cls()
        arrivals.sort(key=lambda a: a[0])
        t0 = arrivals[0][0]
        return cls(requests=tuple(
            dataclasses.replace(req, offset_s=arrived - t0)
            for arrived, req in arrivals
        ))

    @classmethod
    def from_file(cls, path: str) -> "ReplayArrivals":
        with open(path) as f:
            return cls.from_snapshot(json.load(f))

    def schedule(self) -> tuple[float, ...]:
        return tuple(r.offset_s for r in self.requests)
