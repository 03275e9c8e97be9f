"""ReplicaFleet: the autoscaler's actuator over real serving replicas. The
port of ``kubeflow_tpu/autoscale/fleet.py`` on threads: ``launch`` and
``stop`` are blocking callables and one ``threading.Lock`` serialises
scale operations.

One fleet owns the replica lifecycle for ONE service: launching new
replicas (in-process ``ModelServer``s here; the ``launch`` callable
decides), keeping the gateway's :class:`BackendPool` membership in sync
(a ``pool.add`` wakes the activator's parked queue), and running the
prefix-KV rebalance around every membership change:

- **scale-up**: the new replica is launched and — BEFORE it joins the
  pool — pulls the prefix entries the post-add hash ring assigns to it
  from their previous owners, so its first remapped request hits warm KV
  instead of re-prefilling;
- **scale-down**: the leaving replica first evacuates its entries to the
  survivors that now own them, then leaves the pool (no new selection;
  the pool drops it after its last in-flight release), the fleet waits
  for that, bounded by ``drain_timeout_s``, and only then stops it — a
  stream in flight finishes on the replica it started on.

The JAX module's ``subprocess_launcher`` (replicas as ``kft serve``
processes) waits for the port's replica command line (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

from kubeflow_tpu_torch.autoscale import kv_transfer
from kubeflow_tpu_torch.obs import names, prom

logger = logging.getLogger(__name__)

KV_TRANSFERS = prom.REGISTRY.counter(
    names.AUTOSCALER_KV_TRANSFERS_TOTAL,
    "prefix-KV entries moved between replicas after a ring remap",
    ("service",),
)
REPLICAS = prom.REGISTRY.gauge(
    names.FLEET_REPLICAS,
    "replicas the fleet currently runs (actuated, not desired)",
    ("service",),
)


@dataclasses.dataclass
class Replica:
    index: int
    url: str
    stop: Callable[[], None]


class ReplicaFleet:
    """``launch(index) -> (url, stop)`` creates one serving replica and
    returns once it is accepting HTTP (the launcher owns readiness);
    ``stop()`` ends it. ``model`` names the engine model whose prefix
    cache rides the transfers; None (or ``transfer_prefix_kv=False``)
    disables them."""

    def __init__(
        self,
        service: str,
        launch: Callable[[int], tuple[str, Callable[[], None]]],
        *,
        pool: Any = None,
        model: str | None = None,
        role: str = "both",
        transfer_prefix_kv: bool = True,
        prefix_tokens: int = 16,
        drain_timeout_s: float = 30.0,
    ):
        self.service = service
        self.launch = launch
        self.pool = pool
        self.model = model
        #: every replica this fleet launches joins the pool with this
        #: disagg role ("both" | "prefill" | "decode") — a prefill pool
        #: and a decode pool are two fleets over the same service
        self.role = role
        self.transfer_prefix_kv = transfer_prefix_kv and model is not None
        self.prefix_tokens = prefix_tokens
        self.drain_timeout_s = drain_timeout_s
        self._replicas: list[Replica] = []
        self._next_index = 0
        #: serializes scale operations (the autoscaler already serializes
        #: per-service ticks, but kicks and direct calls may interleave)
        self._lock = threading.Lock()
        self.stats = {"launched": 0, "stopped": 0, "kv_entries_moved": 0}
        #: read-only scale timeline for reporters (loadgen/reporter.py):
        #: one entry per actuated membership change, monotonic-stamped —
        #: {"t": time.monotonic(), "replicas": n, "direction": "up"|"down"}
        self.events: list[dict] = []

    # -- actuator protocol ----------------------------------------------- #

    def current(self) -> int:
        return len(self._replicas)

    def urls(self) -> list[str]:
        return [r.url for r in self._replicas]

    def scale_to(self, n: int) -> None:
        with self._lock:
            while len(self._replicas) < n:
                self._add_one()
            while len(self._replicas) > n:
                self._remove_one()

    def close(self) -> None:
        self.scale_to(0)

    # -- membership ------------------------------------------------------- #

    def _add_one(self) -> None:
        index = self._next_index
        self._next_index += 1
        url, stop = self.launch(index)
        url = url.rstrip("/")
        replica = Replica(index=index, url=url, stop=stop)
        self._replicas.append(replica)
        self.stats["launched"] += 1
        # warm the newcomer BEFORE it takes traffic: pull the prefix
        # entries the post-add ring maps to it from their current holders
        if self.transfer_prefix_kv and len(self._replicas) > 1:
            self._rebalance(
                urls=self.urls(),
                index_urls=[r.url for r in self._replicas if r is not replica],
            )
        if self.pool is not None:
            # ready → activator flush (prefill-role replicas never become
            # traffic-selectable; they only serve kv_span:prefill pulls)
            self.pool.add(self.service, url, role=self.role)
        self.events.append({
            "t": time.monotonic(),
            "replicas": len(self._replicas),
            "direction": "up",
        })
        REPLICAS.labels(service=self.service).set(len(self._replicas))
        logger.warning(
            "fleet %s: replica #%d up at %s (%d total)",
            self.service, index, url, len(self._replicas),
        )

    def _remove_one(self) -> None:
        replica = self._replicas.pop()  # LIFO: newest first, oldest stays
        # evacuate its prefix entries to the survivors that now own them —
        # the ring over the remaining urls decides the destinations
        if self.transfer_prefix_kv and self._replicas:
            self._rebalance(urls=self.urls(), index_urls=[replica.url])
        if self.pool is not None:
            self.pool.drain(replica.url)
            deadline = time.monotonic() + self.drain_timeout_s
            while (
                self.pool.find(replica.url) is not None
                and time.monotonic() < deadline
            ):
                time.sleep(0.02)
        replica.stop()
        self.stats["stopped"] += 1
        self.events.append({
            "t": time.monotonic(),
            "replicas": len(self._replicas),
            "direction": "down",
        })
        REPLICAS.labels(service=self.service).set(len(self._replicas))
        logger.warning(
            "fleet %s: replica #%d at %s drained and stopped (%d left)",
            self.service, replica.index, replica.url, len(self._replicas),
        )

    def _rebalance(self, *, urls: list[str], index_urls: list[str]) -> None:
        try:
            moved = kv_transfer.rebalance(
                self.model,
                urls,
                index_urls=index_urls,
                prefix_tokens=self.prefix_tokens,
            )
        except Exception:  # noqa: BLE001 — a failed transfer costs one
            logger.exception(  # re-prefill, never availability
                "fleet %s: prefix-KV rebalance failed", self.service
            )
            return
        if moved:
            self.stats["kv_entries_moved"] += moved
            KV_TRANSFERS.labels(service=self.service).inc(moved)
