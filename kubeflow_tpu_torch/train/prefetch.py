"""The training hot loop's overlap layer: device prefetch + async metric drain.

Counterpart of the JAX package's ``train/prefetch.py``, with the same
classes, thread names and ``window_stats`` keys (``data_stall_ms``,
``h2d_ms``; the drain adds ``device_step_ms`` and ``steps_per_sec``):

- :class:`DevicePrefetcher`: a bounded background producer pulls host
  batches from the iterator and places them on the device ``depth``
  batches ahead. On the card, :func:`device_placer` copies a pinned host
  batch on a side CUDA stream and records an event; the consumer's
  :meth:`PlacedBatch.claim` makes the current stream wait on that event
  and ``record_stream``s the tensors, so the copy overlaps the running
  step and the caching allocator never reuses the memory too early.
- :class:`MetricsDrain`: the loop hands over each step's metric tensors
  with an event recorded after the step; this thread waits on the event
  and reads the values. The loop thread never synchronises with the card
  per step. The gap between consecutive ready times is the device step
  time (``device_step_ms``).

Both threads are named ``kft-*`` and joined by ``close()``; a crashed
producer or drain never deadlocks the loop.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.train.metrics import set_overlap_gauges

PREFETCH_THREAD_NAME = "kft-prefetch"
DRAIN_THREAD_NAME = "kft-metrics-drain"


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #

def map_batch(fn: Callable[[Any], Any], batch: Any) -> Any:
    """``fn`` applied to every leaf of a batch: a dict (``{"inputs",
    "targets"}``), a tuple or list (``(images, labels)``), or one array."""
    if isinstance(batch, Mapping):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def batch_leaves(batch: Any) -> list:
    """The leaves of a batch, in :func:`map_batch`'s order."""
    leaves: list = []
    map_batch(leaves.append, batch)
    return leaves


class PlacedBatch:
    """A batch already on its device, with the event its copy recorded
    (``None`` on the CPU)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: Any, event: torch.cuda.Event | None):
        self.tensors = tensors
        self.event = event

    def claim(self) -> Any:
        """The tensors, made safe to use on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.event.device)
            stream.wait_event(self.event)
            for t in batch_leaves(self.tensors):
                t.record_stream(stream)
        return self.tensors


def device_placer(device: torch.device) -> Callable[[Any], PlacedBatch]:
    """``place(host_batch) -> PlacedBatch`` for ``device``: the numpy
    arrays of a batch (:func:`map_batch`) become tensors; on CUDA through
    pinned memory and a side stream."""
    if device.type != "cuda":
        def place_cpu(host: Any) -> PlacedBatch:
            return PlacedBatch(
                map_batch(lambda v: torch.from_numpy(np.array(v)), host), None
            )

        return place_cpu

    stream = torch.cuda.Stream(device)

    def place(host: Any) -> PlacedBatch:
        with torch.cuda.stream(stream):
            out = map_batch(
                lambda v: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    device, non_blocking=True),
                host,
            )
            event = torch.cuda.Event()
            event.record(stream)
        return PlacedBatch(out, event)

    return place


# --------------------------------------------------------------------- #
# fetchers
# --------------------------------------------------------------------- #

class _End:
    """Producer sentinel: end-of-stream or a carried producer error."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException | None = None):
        self.error = error


class _Fetcher:
    """Interface shared by the threaded and inline fetchers."""

    def __iter__(self):
        return self

    def __next__(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def window_stats(self) -> dict[str, float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class DevicePrefetcher(_Fetcher):
    """Bounded background producer: host batches → placed batches.

    ``depth`` bounds how many placed batches may be in flight; each holds
    device memory, so the bound is a memory budget too. ``close()`` is
    idempotent, unblocks a producer parked on a full queue, joins it, and
    discards buffered batches. Buffered batches were consumed from the
    iterator, so a resuming caller rebuilds the stream from a
    ``start_step -> iterator`` factory (see ``Trainer.fit``).
    ``h2d_ms`` is the producer's time to pull and enqueue a copy (the
    copy itself runs on the side stream).
    """

    def __init__(
        self,
        it: Iterator[Any] | Iterable[Any],
        place: Callable[[Any], Any],
        *,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(it)
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stall_s = 0.0
        self._h2d_s = 0.0
        self._batches = 0
        self._thread = threading.Thread(
            target=self._run, name=PREFETCH_THREAD_NAME, daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    host = next(self._it)
                except StopIteration:
                    self._put(_End())
                    return
                t0 = time.perf_counter()
                placed = self._place(host)
                dt = time.perf_counter() - t0
                with self._lock:
                    self._h2d_s += dt
                if not self._put(placed):
                    return
        except BaseException as e:  # noqa: BLE001 — carried to the consumer
            self._put(_End(e))

    def _put(self, item: Any) -> bool:
        """Queue.put that never outlives close(): False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "prefetch producer thread died without a sentinel"
                    )
        if isinstance(item, _End):
            self.close()
            if item.error is not None:
                raise item.error
            raise StopIteration
        with self._lock:
            self._stall_s += time.perf_counter() - t0
            self._batches += 1
        return item

    def window_stats(self) -> dict[str, float]:
        """Pop the per-batch mean ``data_stall_ms``/``h2d_ms`` of the
        window since the last call."""
        with self._lock:
            stall, h2d, n = self._stall_s, self._h2d_s, self._batches
            self._stall_s = self._h2d_s = 0.0
            self._batches = 0
        scale = 1e3 / max(n, 1)
        return {"data_stall_ms": stall * scale, "h2d_ms": h2d * scale}

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)


class InlineFetcher(_Fetcher):
    """``prefetch_depth=0``: the same interface with no thread; pulling
    and placing are charged in full to ``data_stall_ms``/``h2d_ms``."""

    def __init__(self, it: Iterator[Any] | Iterable[Any], place: Callable[[Any], Any]):
        self._it = iter(it)
        self._place = place
        self._stall_s = 0.0
        self._h2d_s = 0.0
        self._batches = 0

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        host = next(self._it)
        t1 = time.perf_counter()
        placed = self._place(host)
        self._stall_s += t1 - t0
        self._h2d_s += time.perf_counter() - t1
        self._batches += 1
        return placed

    def window_stats(self) -> dict[str, float]:
        stall, h2d, n = self._stall_s, self._h2d_s, self._batches
        self._stall_s = self._h2d_s = 0.0
        self._batches = 0
        scale = 1e3 / max(n, 1)
        return {"data_stall_ms": stall * scale, "h2d_ms": h2d * scale}

    def close(self) -> None:
        pass


def make_fetcher(
    it: Iterator[Any] | Iterable[Any],
    place: Callable[[Any], Any],
    *,
    depth: int,
) -> _Fetcher:
    """Depth 0 → inline; depth >= 1 → threaded device prefetch."""
    if depth <= 0:
        return InlineFetcher(it, place)
    return DevicePrefetcher(it, place, depth=depth)


# --------------------------------------------------------------------- #
# metric drain
# --------------------------------------------------------------------- #

_STOP = object()


class MetricsDrain:
    """Asynchronous consumer of per-step metric tensors.

    :meth:`put` takes a step's metrics and the event recorded after the
    step (``None`` on the CPU). This thread waits on the event, never the
    loop thread; log-boundary items are converted to floats and written.
    Any exception here (above all ``NonFiniteMetricError`` from the
    writer's alarm) is stored, the thread keeps draining and discarding,
    and the error is re-raised on the loop thread at the next
    :meth:`poll` or :meth:`close`.
    """

    def __init__(self, writer, *, history: list[dict], hooks=(), depth: int = 64,
                 heartbeat=None):
        self._writer = writer
        #: ``obs/heartbeat.py`` ``HeartbeatWriter`` (or None): every drained
        #: step is stamped into the beat file, so the supervisor's progress
        #: watch sees steps complete, not just a live thread
        self._hb = heartbeat
        self._history = history
        self._hooks = tuple(hooks or ())
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: BaseException | None = None
        self._raised = False
        self._last_ready: float | None = None
        self._win_step_s = 0.0
        self._win_steps = 0
        self._t_logged: float | None = None
        self._step_logged: int | None = None
        self._thread = threading.Thread(
            target=self._run, name=DRAIN_THREAD_NAME, daemon=True
        )
        self._thread.start()

    def put(
        self,
        step: int,
        metrics: Mapping[str, Any],
        *,
        log: bool,
        event: torch.cuda.Event | None = None,
        extra: Mapping[str, float] | None = None,
    ) -> None:
        """Enqueue one step's metrics; throttles (never deadlocks)."""
        item = (step, metrics, log, event, dict(extra or ()))
        while True:
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                if not self._thread.is_alive():
                    return  # poll()/close() surface whatever killed it

    def poll(self) -> None:
        """Re-raise a drain-side error on the caller."""
        if self._error is not None and not self._raised:
            self._raised = True
            raise self._error

    def close(self) -> None:
        """Flush + join, then surface any pending drain error."""
        self.shutdown()
        self.poll()

    def shutdown(self) -> None:
        """Idempotent no-raise join (exception-path cleanup)."""
        if self._thread.is_alive():
            while True:
                try:
                    self._q.put(_STOP, timeout=0.5)
                    break
                except queue.Full:
                    if not self._thread.is_alive():
                        break
            self._thread.join(timeout=30.0)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            if self._error is not None:
                continue  # drain-and-discard: the loop must never block
            try:
                self._process(*item)
            except BaseException as e:  # noqa: BLE001 — re-raised via poll()
                self._error = e

    def _process(self, step, metrics, log, event, extra) -> None:
        if event is not None:
            event.synchronize()  # this step has run on the card
        if self._hb is not None:
            self._hb.beat(step)
        now = time.perf_counter()
        if self._last_ready is not None:
            self._win_step_s += now - self._last_ready
            self._win_steps += 1
        self._last_ready = now
        if self._t_logged is None:
            # the first step's readiness starts the rate clock: its
            # kernel build and warm-up are reported as compile_ms instead
            self._t_logged = now
            self._step_logged = step
        if not log:
            return
        m = {k: float(v) for k, v in metrics.items()}
        steps = step - self._step_logged
        elapsed = now - self._t_logged
        if steps > 0 and elapsed > 0:
            m["steps_per_sec"] = steps / elapsed
        else:
            # the first step is itself a log boundary: the loop's
            # dispatch-side estimate is the only clock available
            m["steps_per_sec"] = float(extra.pop("fallback_steps_per_sec", 0.0))
        if self._win_steps:
            m["device_step_ms"] = self._win_step_s / self._win_steps * 1e3
        self._win_step_s = 0.0
        self._win_steps = 0
        self._t_logged = now
        self._step_logged = step
        extra.pop("fallback_steps_per_sec", None)
        m.update(extra)
        set_overlap_gauges(m)
        self._writer.write(step, m)
        self._history.append({"step": step, **m})
        for h in self._hooks:
            h(step, m)


def live_kft_threads() -> list[str]:
    """Names of still-alive overlap threads (the leak check)."""
    return [
        t.name
        for t in threading.enumerate()
        if t.name in (PREFETCH_THREAD_NAME, DRAIN_THREAD_NAME) and t.is_alive()
    ]
