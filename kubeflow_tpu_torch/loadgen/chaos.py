"""Chaos overlays: compose a FaultPlan with a load run's timeline. The port
of ``kubeflow_tpu/loadgen/chaos.py``: :func:`apply_overlay` is a blocking
call that sleeps to ``t0 + at_s`` and fires, which the harness runs on a
timer thread of its own beside the load client.

A load run adds a *window* to a fault plan: the overlay arms each fault
at a declared offset into the run and hands the reporter the
``[start, end)`` interval, so the goodput dip is attributed to the
injected window instead of eyeballed. Serving faults only: a load run
has no trainer steps to key off, so ``at_s`` (offset from run start)
replaces ``at_step`` as the deterministic trigger.

The overlay resolves each fault's victim through a caller-supplied
``engines`` view (model name → live engine objects, harness-owned) and
fires the injectors of :mod:`kubeflow_tpu_torch.chaos.injectors`;
production code still carries zero chaos branches.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Mapping, Sequence

from kubeflow_tpu_torch.chaos import injectors
from kubeflow_tpu_torch.chaos.plan import (
    DropKVShip,
    DropPrefixCache,
    Fault,
    FaultPlan,
    KillMidStream,
    SlowDecode,
    WedgeEngine,
)

__all__ = ["ChaosOverlay", "apply_overlay"]

SERVING_FAULTS = (
    WedgeEngine, SlowDecode, DropPrefixCache, DropKVShip, KillMidStream,
)


@dataclasses.dataclass(frozen=True)
class ChaosOverlay:
    """One fault plan armed ``at_s`` seconds into the run; the
    attribution window closes at ``at_s + window_s``."""

    plan: FaultPlan
    at_s: float
    window_s: float = 5.0

    def __post_init__(self) -> None:
        for f in self.plan.faults:
            if not isinstance(f, SERVING_FAULTS):
                raise ValueError(
                    f"{f.kind} is not a serving fault; load-run overlays "
                    "compose only with the engine-seam injectors"
                )

    @property
    def window(self) -> tuple[float, float]:
        return (self.at_s, self.at_s + self.window_s)

    @property
    def fault_kinds(self) -> tuple[str, ...]:
        return tuple(f.kind for f in self.plan.faults)


def _inject(fault: Fault, engine) -> None:
    if isinstance(fault, WedgeEngine):
        injectors.wedge_engine(engine, hold_s=fault.hold_s)
    elif isinstance(fault, SlowDecode):
        injectors.slow_decode(engine, delay_s=fault.delay_s)
    elif isinstance(fault, DropPrefixCache):
        injectors.drop_prefix_cache(engine)
    elif isinstance(fault, DropKVShip):
        injectors.drop_kv_ship(engine, count=fault.count)
    elif isinstance(fault, KillMidStream):
        # in-process harness replicas: poison the engine rather than
        # SIGKILL this very process (injectors.kill_mid_stream contract)
        from kubeflow_tpu_torch.serve.watchdog import EngineRestarting

        injectors.kill_mid_stream(
            engine, after_tokens=fault.after_tokens,
            action=lambda eng: eng.poison(
                EngineRestarting("loadgen chaos: replica killed mid-stream")
            ),
        )
    else:  # pragma: no cover — guarded by __post_init__
        raise ValueError(f"unhandled fault kind {fault.kind}")


def apply_overlay(
    overlay: ChaosOverlay,
    engines: Callable[[str], Sequence] | Mapping[str, Sequence],
    *,
    t0: float,
) -> list[str]:
    """Sleep until ``t0 + overlay.at_s`` (monotonic), then fire every
    fault in plan order. The victim is drawn deterministically from the
    plan seed over the model's CURRENT engines. Returns the injected
    kinds (for the report's ``chaos.faults``)."""
    delay = t0 + overlay.at_s - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    rng = random.Random(f"{overlay.plan.seed}:overlay")
    fired: list[str] = []
    for fault in overlay.plan.faults:
        model = getattr(fault, "model", "")
        pool = (
            engines(model) if callable(engines)
            else engines.get(model, ())
        )
        pool = [e for e in pool if e is not None]
        if not pool:
            continue  # the victim scaled away before the window opened
        victim = pool[rng.randrange(len(pool))]
        _inject(fault, victim)
        fired.append(fault.kind)
    return fired
