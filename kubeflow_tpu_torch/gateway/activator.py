"""Activator: park requests while a service has zero ready backends. The
port of ``kubeflow_tpu/gateway/activator.py``.

Reference analog: the Knative activator — when a service is scaled to
zero, the activator sits in the data path, buffers requests, pokes the
autoscaler, and replays the buffer once a replica is up:

- a request arriving with no eligible backend parks in a **bounded FIFO**
  per service (overflow → ``QueueOverflow`` ⇒ 429, deadline →
  ``ActivationTimeout`` ⇒ 503 — the two Knative envelope semantics);
- parking kicks ``scale_up(service)`` once per cold episode (not per
  request), so the replica starts off the request path while the client
  waits;
- when the pool reports a backend ready, the queue flushes strictly in
  admission order.

The reference parks asyncio futures on its event loop. The port's
gateway serves a thread a connection, so a parked request is a thread
blocked on one ``threading.Condition``: each waiter holds a ticket in
the FIFO, ``notify`` marks every parked ticket woken and wakes them all,
and a woken thread leaves in ticket order (a thread that wakes before
the tickets ahead of it have left waits for them), so the flush is in
admission order as the reference's future wake-ups are. The client sees
the same statuses and the same order.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable

from kubeflow_tpu_torch.obs import names, prom

QUEUE_DEPTH = prom.REGISTRY.gauge(
    names.GATEWAY_QUEUE_DEPTH,
    "requests parked in the activator FIFO",
    ("service",),
)
#: the same depth under its autoscaler-facing name: parked demand counts
#: as concurrency, or scale-from-zero never fires
ACTIVATOR_QUEUE_DEPTH = prom.REGISTRY.gauge(
    names.GATEWAY_ACTIVATOR_QUEUE_DEPTH,
    "autoscaler input: requests parked in the activator FIFO",
    ("service",),
)
COLD_EPISODE = prom.REGISTRY.gauge(
    names.GATEWAY_ACTIVATOR_COLD_EPISODE,
    "1 while a cold-episode scale-up kick is outstanding",
    ("service",),
)
ACTIVATIONS = prom.REGISTRY.counter(
    names.GATEWAY_ACTIVATIONS_TOTAL,
    "scale-from-zero kicks issued by the activator",
    ("service",),
)


class QueueOverflow(Exception):
    """Parked-queue capacity exceeded — shed with 429."""


class ActivationTimeout(Exception):
    """No backend became ready within the deadline — shed with 503."""


class _Ticket:
    __slots__ = ("woken",)

    def __init__(self) -> None:
        self.woken = False


class Activator:
    def __init__(
        self,
        *,
        queue_limit: int = 256,
        timeout_s: float = 30.0,
        scale_up: Callable[[str], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.queue_limit = queue_limit
        self.timeout_s = timeout_s
        self.scale_up = scale_up
        self._clock = clock
        self._cv = threading.Condition()
        self._parked: dict[str, deque[_Ticket]] = {}
        #: services with a scale-up kick outstanding; cleared on flush so
        #: the next cold episode kicks again. Ordered for stable views.
        self._kicked: OrderedDict[str, float] = OrderedDict()

    def depth(self, service: str) -> int:
        with self._cv:
            return len(self._parked.get(service, ()))

    def _set_depth_locked(self, service: str) -> None:
        n = len(self._parked.get(service, ()))
        QUEUE_DEPTH.labels(service=service).set(n)
        ACTIVATOR_QUEUE_DEPTH.labels(service=service).set(n)

    def wait(
        self,
        service: str,
        *,
        timeout_s: float | None = None,
        span=None,
    ) -> None:
        """Park until ``notify(service)`` — admission order preserved.

        ``span`` (the gateway's ``activator.park`` span) records how deep
        the request parked and whether the episode ended in activation or
        a timeout."""
        kick = False
        with self._cv:
            q = self._parked.setdefault(service, deque())
            if len(q) >= self.queue_limit:
                if span:
                    span.event("overflow", parked=len(q))
                raise QueueOverflow(
                    f"activator queue for {service!r} is full "
                    f"({self.queue_limit} parked)"
                )
            ticket = _Ticket()
            q.append(ticket)
            if span:
                span.set_attr("parked_depth", len(q))
            self._set_depth_locked(service)
            if service not in self._kicked and self.scale_up is not None:
                self._kicked[service] = self._clock()
                ACTIVATIONS.labels(service=service).inc()
                COLD_EPISODE.labels(service=service).set(1)
                kick = True
        if kick:
            try:
                # outside the lock: scale_up may add a backend, whose
                # readiness calls notify() from this very thread
                self.scale_up(service)
            except Exception:  # noqa: BLE001 — a failed kick must not kill
                pass  # the parked request; the deadline still bounds it
        deadline = time.monotonic() + (
            self.timeout_s if timeout_s is None else timeout_s)
        with self._cv:
            try:
                while True:
                    # leave in admission order: only the head of the FIFO
                    # may go, once it was woken
                    if ticket.woken and q and q[0] is ticket:
                        if span:
                            span.event("activated")
                        return
                    left = deadline - time.monotonic()
                    if left <= 0 and not ticket.woken:
                        if span:
                            span.event("timeout")
                        raise ActivationTimeout(
                            f"no backend for {service!r} became ready in time"
                        )
                    self._cv.wait(max(left, 0.0) if not ticket.woken else None)
            finally:
                if ticket in q:
                    q.remove(ticket)
                self._set_depth_locked(service)
                self._cv.notify_all()  # the next ticket may be the head now

    def notify(self, service: str) -> None:
        """A backend for ``service`` is ready: wake every parked waiter in
        admission (FIFO) order. Waiters re-select a backend themselves —
        the first may consume capacity, later ones may re-park."""
        with self._cv:
            self._kicked.pop(service, None)
            COLD_EPISODE.labels(service=service).set(0)
            for ticket in self._parked.get(service, ()):
                ticket.woken = True
            self._cv.notify_all()

    def view(self) -> dict:
        with self._cv:
            return {
                "queue_depth": {
                    s: len(q) for s, q in self._parked.items() if q
                },
                "pending_scale_ups": list(self._kicked),
            }
