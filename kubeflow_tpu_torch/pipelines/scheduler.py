"""Recurring runs: the ScheduledWorkflow controller analog.

A copy of ``kubeflow_tpu/pipelines/scheduler.py``.

Reference analog (SURVEY.md §2.4 "ScheduledWorkflow controller"):
a CRD controller that fires pipeline runs on a cron/interval schedule
([pipelines] backend/src/crd/controller/scheduledworkflow/ —
UNVERIFIED, SURVEY.md §0). Semantics kept: interval trigger, max
concurrency 1 per schedule (no overlapping runs), pause/resume,
run-history cap, catch-up disabled (missed ticks collapse into one).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from typing import Any, Callable

from kubeflow_tpu_torch.pipelines.ir import PipelineIR
from kubeflow_tpu_torch.pipelines.runner import PipelineRunner, RunResult

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RecurringRun:
    pipeline: PipelineIR
    interval_s: float
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)
    max_runs: int | None = None          # stop after N fires (None = forever)
    name: str = ""
    uid: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:8])
    paused: bool = False
    # status
    fired: int = 0
    history: list[RunResult] = dataclasses.field(default_factory=list)
    next_at: float = 0.0
    running: bool = False      # overlap guard (maxConcurrency 1 per schedule)

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.name = self.name or f"{self.pipeline.name}-recurring"


class RunScheduler:
    """One background thread watches the clock; each due schedule fires
    on its own worker thread, so a slow run never starves other
    schedules. Overlapping fires of the SAME schedule are suppressed
    (the reference default `maxConcurrency: 1`)."""

    def __init__(self, runner: PipelineRunner,
                 on_result: Callable[[RecurringRun, RunResult], None] | None = None,
                 history_cap: int = 20):
        self.runner = runner
        self.on_result = on_result
        self.history_cap = history_cap
        self._schedules: dict[str, RecurringRun] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ #

    def add(self, rr: RecurringRun) -> str:
        with self._lock:
            rr.next_at = time.monotonic() + rr.interval_s
            self._schedules[rr.uid] = rr
        self._wake.set()
        return rr.uid

    def pause(self, uid: str) -> None:
        with self._lock:
            self._schedules[uid].paused = True

    def resume(self, uid: str) -> None:
        with self._lock:
            rr = self._schedules[uid]
            rr.paused = False
            # missed ticks collapse: next fire is one interval from now
            rr.next_at = time.monotonic() + rr.interval_s
        self._wake.set()

    def remove(self, uid: str) -> None:
        with self._lock:
            self._schedules.pop(uid, None)

    def get(self, uid: str) -> RecurringRun:
        with self._lock:
            return self._schedules[uid]

    def list(self) -> list[RecurringRun]:
        with self._lock:
            return list(self._schedules.values())

    # ------------------------------------------------------------------ #

    def start(self) -> "RunScheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kft-run-scheduler")
        self._thread.start()
        return self

    def shutdown(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout)

    def __enter__(self) -> "RunScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            due: list[RecurringRun] = []
            with self._lock:
                wait = 3600.0
                for rr in self._schedules.values():
                    if rr.paused or rr.running or (
                            rr.max_runs is not None
                            and rr.fired >= rr.max_runs):
                        continue
                    if rr.next_at <= now:
                        rr.running = True          # claim before spawning
                        rr.fired += 1
                        rr.next_at = now + rr.interval_s   # no catch-up
                        due.append(rr)
                    else:
                        wait = min(wait, rr.next_at - now)
            for rr in due:
                threading.Thread(target=self._fire, args=(rr,), daemon=True,
                                 name=f"kft-fire-{rr.name}").start()
            if not due:
                self._wake.wait(timeout=wait)
                self._wake.clear()

    def _fire(self, rr: RecurringRun) -> None:
        try:
            result = self.runner.run(rr.pipeline, rr.parameters)
        except Exception:
            logger.exception("recurring run %s fire %d crashed", rr.name, rr.fired)
            return
        finally:
            with self._lock:
                rr.running = False
            self._wake.set()    # re-evaluate: next fire may already be due
        rr.history.append(result)
        del rr.history[:-self.history_cap]
        if self.on_result:
            self.on_result(rr, result)
