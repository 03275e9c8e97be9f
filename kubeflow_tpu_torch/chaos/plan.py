"""Declarative fault plans: failure as a first-class, testable input. A
copy of the serving part of ``kubeflow_tpu/chaos/plan.py``: the
:class:`Fault` base, the five serving faults and :class:`FaultPlan`.
The training faults (worker crash, preemption and wedge, slice loss,
checkpoint corruption) arrive with the trainer's chaos slice.

A :class:`FaultPlan` names, up front and deterministically, every failure
a run must survive; the injectors (:mod:`kubeflow_tpu_torch.chaos.injectors`)
drive each through the platform's own seams. Any random choice (the
victim replica) draws from ``seed``. Plans serialize
(``to_dict``/``from_dict``) with the JAX plan's kind strings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base trigger condition shared by every fault kind.

    ``at_step``: fire once the observed trainer step is >= this (None =
    fire as soon as the target is Running; serving faults ignore it).
    ``on_attempt``: only consider firing while the target worker is on
    this attempt.
    """

    at_step: int | None = None
    on_attempt: int = 0

    @property
    def kind(self) -> str:
        return type(self).__name__

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class WedgeEngine(Fault):
    """Serving fault: stall the named model's engine on its next device
    chunk dispatch (the scheduler thread blocks as if inside a wedged
    device call) for up to ``hold_s``. The engine watchdog must trip
    (``kft_engine_watchdog_trips_total{reason="wedged"}``), flip
    readiness, fail in-flight work retryably, and rebuild the engine."""

    model: str = ""
    hold_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class SlowDecode(Fault):
    """Serving fault: inflate every decode chunk of the named model's
    engine by ``delay_s`` — a brownout, not a blackout. Deadline-aware
    admission control must start shedding provably-late requests with
    503 + Retry-After instead of queueing them to a guaranteed miss."""

    model: str = ""
    delay_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class DropPrefixCache(Fault):
    """Serving fault: wipe the named model's engine prefix cache — the
    cold-cache state a freshly scaled replica starts in. The token
    streams must be unchanged (a pull from a warm peer, or a re-prefill)."""

    model: str = ""


@dataclasses.dataclass(frozen=True)
class DropKVShip(Fault):
    """Serving fault: fail the named model's next ``count`` cross-replica
    KV-span pulls at the wire seam — the prefill peer dying mid-ship. The
    decode replica must fall back to a LOCAL prefill with no
    client-visible failure."""

    model: str = ""
    count: int = 1


@dataclasses.dataclass(frozen=True)
class KillMidStream(Fault):
    """Serving fault: hard-kill the named model's serving replica the
    moment a streaming request has emitted at least ``after_tokens``
    tokens. The gateway's mid-stream failover must re-dispatch the stream
    to a healthy peer with the committed prefix. ``pid=None`` kills the
    process hosting the engine (in-process harnesses pass an action
    override to the injector instead)."""

    model: str = ""
    pid: int | None = None
    after_tokens: int = 1


FAULT_KINDS = {
    c.__name__: c
    for c in (WedgeEngine, SlowDecode, DropPrefixCache, DropKVShip,
              KillMidStream)
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, seedable set of faults for one run."""

    faults: tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"not a Fault: {f!r}")
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultPlan":
        faults = []
        for fd in d.get("faults", []):
            fd = dict(fd)
            kind = fd.pop("kind", None)
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; expected one of "
                    f"{sorted(FAULT_KINDS)}"
                )
            faults.append(FAULT_KINDS[kind](**fd))
        return cls(faults=tuple(faults), seed=int(d.get("seed", 0)))

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "faults": [f.to_dict() for f in self.faults],
        }
