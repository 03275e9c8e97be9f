"""Request batcher: group requests by max batch size OR max latency — the
port of ``kubeflow_tpu/serve/batcher.py`` (KServe's batcher agent, which
flushes a batch when ``maxBatchSize`` is reached or ``maxLatency``
elapses).

The port's server is ``ThreadingHTTPServer`` (a thread a connection)
where the JAX one is asyncio, so callers here are threads: a caller
blocks in :meth:`Batcher.submit` on a ``concurrent.futures.Future``, and
one flush thread a batcher runs the handler. The semantics are the JAX
batcher's:

- a batch flushes when the queue holds ``max_batch_size`` instances, or
  ``max_latency_ms`` after its oldest entry arrived;
- an oversize flush is split into handler calls of at most
  ``max_batch_size`` instances;
- the handler runs outside the queue lock, so new requests accumulate
  into the next batch while a forward is in flight (on the JAX event
  loop the forward blocks the loop, so requests pile up behind it
  alike);
- an entry whose deadline passed while it waited is shed with
  ``DeadlineExceeded(stage="batch_queue")`` and counted in
  ``DEADLINE_EXPIRED{stage="batch_queue"}``, never costing a forward;
- when a co-batched handler call raises, each caller's instances are
  re-run alone, so one malformed request fails only its own caller
  (``fail_isolations`` counts these events).

Request tracing: a caller's dataplane span (``trace=``) parents a
``batcher.wait`` span over the entry's time in the queue; each flush opens
one ``batcher.flush`` span under the first traced caller's wait span, as
the JAX batcher does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence

from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.serve.deadline import DEADLINE_EXPIRED, DeadlineExceeded

#: queue entry: (instances, caller future, absolute deadline or None,
#: arrival time on ``time.monotonic()``, wait span or None)
_Entry = tuple[list[Any], Future, "float | None", float, Any]


@dataclasses.dataclass
class BatcherConfig:
    max_batch_size: int = 16
    max_latency_ms: float = 5.0


class Batcher:
    """Coalesces waiting callers into handler calls of ≤ max_batch_size.

    ``handler`` receives a list of instances (never more than
    ``max_batch_size``) and returns one output per instance, in order.
    Handler calls run one at a time on the batcher's flush thread,
    started by the first submit; :meth:`close` stops it.
    """

    def __init__(
        self,
        handler: Callable[[list[Any]], Sequence[Any]],
        config: BatcherConfig | None = None,
    ):
        self._handler = handler
        self.config = config or BatcherConfig()
        self._queue: list[_Entry] = []
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._closed = False
        self.stats = {
            "batches": 0, "instances": 0, "fail_isolations": 0,
            "deadline_shed": 0,
        }

    @property
    def queue_depth(self) -> int:
        """Instances waiting for the next flush: the balancer's backlog
        signal, ``kft_server_queue_depth`` on /metrics."""
        with self._cv:
            return self._queued()

    @property
    def mean_occupancy(self) -> float:
        """Mean instances per handler call: how full the batches run."""
        batches = self.stats["batches"]
        return self.stats["instances"] / batches if batches else 0.0

    def _queued(self) -> int:
        return sum(len(e[0]) for e in self._queue)

    def submit(self, instances: list[Any], *,
               deadline: float | None = None, trace: Any = None) -> list[Any]:
        """Block until ``instances`` are served; their outputs, in order.
        ``deadline`` (absolute ``time.monotonic()``) rides the entry: one
        that passes before its flush is shed with
        :class:`DeadlineExceeded` instead of costing a forward. ``trace``
        (the caller's dataplane span) parents a ``batcher.wait`` span
        covering the entry's time in the queue."""
        fut: Future = Future()
        wspan = TRACER.span("batcher.wait", parent=trace) if trace else None
        if wspan:
            wspan.set_attr("instances", len(instances))
        with self._cv:
            if self._closed:
                if wspan:
                    wspan.end("error")
                raise RuntimeError("batcher is closed")
            self._queue.append(
                (instances, fut, deadline, time.monotonic(), wspan))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flush_loop, name="batcher-flush", daemon=True)
                self._thread.start()
            self._cv.notify()
        return fut.result()

    def close(self, timeout: float = 10.0) -> None:
        """Serve what is queued, then stop the flush thread."""
        with self._cv:
            self._closed = True
            self._cv.notify()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)

    def _flush_loop(self) -> None:
        latency = self.config.max_latency_ms / 1e3
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return  # closed and drained
                # wait for a full batch or the oldest entry's latency
                while self._queued() < self.config.max_batch_size and not self._closed:
                    left = self._queue[0][3] + latency - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch, self._queue = self._queue, []
            self._run_batch(batch)

    def _shed_expired(self, queue: list[_Entry]) -> list[_Entry]:
        """Fail queued entries whose deadline passed while they waited for
        the flush: they must never take a forward's batch slot."""
        now = time.monotonic()
        kept = []
        for entry in queue:
            deadline, fut, wspan = entry[2], entry[1], entry[4]
            if deadline is not None and now > deadline:
                self.stats["deadline_shed"] += 1
                DEADLINE_EXPIRED.labels(stage="batch_queue").inc()
                if wspan:
                    wspan.event("deadline_expired", stage="batch_queue")
                    wspan.end("deadline")
                fut.set_exception(DeadlineExceeded(
                    "deadline expired in the batch queue", stage="batch_queue"))
            else:
                kept.append(entry)
        return kept

    def _run_batch(self, queue: list[_Entry]) -> None:
        queue = self._shed_expired(queue)
        if not queue:
            return
        flat: list[Any] = []
        for entry in queue:
            flat.extend(entry[0])
        # one flush span per batch, parented to the first traced caller;
        # every caller's wait span ends here with the flush size it joined
        fspan = None
        for entry in queue:
            wspan = entry[4]
            if wspan:
                if fspan is None:
                    fspan = TRACER.span("batcher.flush", parent=wspan)
                    fspan.set_attr("flush_size", len(flat))
                    fspan.set_attr("callers", len(queue))
                wspan.set_attr("flush_size", len(flat))
                wspan.end()
        try:
            outputs: list[Any] = []
            step = self.config.max_batch_size
            for i in range(0, len(flat), step):
                outputs.extend(self._handler(flat[i : i + step]))
                self.stats["batches"] += 1
        except Exception as e:  # noqa: BLE001 — delivered to the callers
            if len(queue) == 1:
                queue[0][1].set_exception(e)
                if fspan:
                    fspan.end("error")
                return
            # isolate the offender: re-run each caller's instances alone so
            # one malformed request does not fail every co-batched one; the
            # re-runs count toward "instances", so occupancy stays honest
            self.stats["fail_isolations"] += 1
            if fspan:
                fspan.event("fail_isolation", callers=len(queue))
            for instances, fut, *_ in queue:
                try:
                    fut.set_result(list(self._handler(list(instances))))
                    self.stats["batches"] += 1
                    self.stats["instances"] += len(instances)
                except Exception as per:  # noqa: BLE001 — this caller's own
                    fut.set_exception(per)
            if fspan:
                fspan.end()
            return
        self.stats["instances"] += len(flat)
        off = 0
        for instances, fut, *_ in queue:
            n = len(instances)
            fut.set_result(outputs[off : off + n])
            off += n
        if fspan:
            fspan.end()
