"""Autoscaler input signals: scrape and fold replica + gateway metrics. A
copy of ``kubeflow_tpu/autoscale/signals.py`` with the gateway's signal
source on the standard library (``http.client`` on a thread pool in
place of an aiohttp session).

The recommender (autoscale/kpa.py) wants ONE number per service — the
observed concurrency — but that number lives in three places:

- each replica's ``/metrics``: ``kft_server_inflight{model}`` (requests
  executing in the dataplane, SSE streams included) and
  ``kft_server_queue_depth{model}`` (batcher backlog);
- the gateway's activator: requests parked because zero backends are
  ready — demand that MUST count, or scale-from-zero never triggers;
- the replica's engine: ``kft_engine_decode_gap_ms`` (chunk cadence),
  scraped alongside for operator visibility.

``parse_prom_text`` is a minimal Prometheus text-format reader for the
first-party expositions this package emits (no exemplars, no escapes
beyond the ones ``obs/prom.py`` writes)."""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import http.client
import re
import time
import urllib.parse
from collections import deque
from typing import Any, Mapping

from kubeflow_tpu_torch.obs import names

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom_text(
    text: str,
) -> dict[str, list[tuple[dict[str, str], float]]]:
    """→ ``{metric_name: [(labels, value), ...]}``. Unparseable lines and
    comments are skipped (a scrape must degrade, not raise)."""
    out: dict[str, list[tuple[dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            k: v.replace('\\"', '"').replace("\\\\", "\\")
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def metric_sum(
    parsed: Mapping[str, list[tuple[dict[str, str], float]]],
    name: str,
    **match: str,
) -> float:
    """Sum of every sample of ``name`` whose labels include ``match``."""
    total = 0.0
    for labels, value in parsed.get(name, ()):
        if all(labels.get(k) == v for k, v in match.items()):
            total += value
    return total


def metric_max(
    parsed: Mapping[str, list[tuple[dict[str, str], float]]],
    name: str,
    **match: str,
) -> float:
    best = 0.0
    for labels, value in parsed.get(name, ()):
        if all(labels.get(k) == v for k, v in match.items()):
            best = max(best, value)
    return best


@dataclasses.dataclass
class ServiceSignals:
    """One tick's folded view of a service's load."""

    #: sum of kft_server_inflight across reporting replicas
    inflight: float = 0.0
    #: sum of kft_server_queue_depth across reporting replicas
    queue_depth: float = 0.0
    #: requests parked in the gateway activator right now
    activator_depth: float = 0.0
    #: max kft_engine_decode_gap_ms across replicas (cadence telemetry)
    decode_gap_ms: float = 0.0
    #: replicas whose /metrics answered this tick
    replicas_reporting: int = 0

    @property
    def concurrency(self) -> float:
        """The KPA input: demand anywhere in the path counts."""
        return self.inflight + self.queue_depth + self.activator_depth


def fold_replica_metrics(
    signals: ServiceSignals,
    parsed: Mapping[str, list[tuple[dict[str, str], float]]],
) -> None:
    """Fold one replica's parsed ``/metrics`` into the tick's signals.
    The names are the obs/names.py constants — the single definition
    site, so a rename cannot silently blind the autoscaler."""
    signals.inflight += metric_sum(parsed, names.SERVER_INFLIGHT)
    signals.queue_depth += metric_sum(parsed, names.SERVER_QUEUE_DEPTH)
    signals.decode_gap_ms = max(
        signals.decode_gap_ms, metric_max(parsed, names.ENGINE_DECODE_GAP_MS)
    )
    signals.replicas_reporting += 1


def http_call(url: str, *, timeout_s: float, body: bytes | None = None,
              headers: Mapping[str, str] | None = None) -> tuple[int, bytes]:
    """One request over ``http.client`` — a GET, or a POST of ``body`` —
    read to its end: ``(status, body)``. Raises ``OSError``
    (``TimeoutError`` and ``ConnectionError`` included) or
    ``http.client.HTTPException`` when the peer cannot answer."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout_s)
    try:
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        conn.request("GET" if body is None else "POST", path, body=body,
                     headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class GatewaySignalSource:
    """Signal source for an autoscaler colocated with the gateway: scrapes
    every active backend's ``/metrics`` over HTTP, in parallel on a small
    thread pool, each with ``timeout_s``, and reads the activator queue
    depth in-process. Unreachable replicas contribute nothing (a dead
    replica must not freeze the signal at its last value — the probe loop
    will eject it). ``scrape_ms`` keeps the wall time of the last 4096
    calls, the scrape's cost on the host."""

    def __init__(self, gateway: Any, service: str, *, timeout_s: float = 5.0):
        self.gateway = gateway
        self.service = service
        self.timeout_s = timeout_s
        self._pool: cf.ThreadPoolExecutor | None = None
        self.scrape_ms: deque[float] = deque(maxlen=4096)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _scrape(self, url: str) -> str | None:
        try:
            status, body = http_call(f"{url}/metrics", timeout_s=self.timeout_s)
        except (OSError, http.client.HTTPException):
            return None  # unreachable replica: contributes nothing
        return body.decode(errors="replace") if status == 200 else None

    def __call__(self) -> ServiceSignals:
        t0 = time.perf_counter()
        signals = ServiceSignals(
            activator_depth=float(self.gateway.activator.depth(self.service))
        )
        urls = [
            b.url
            for b in self.gateway.pool.backends_of(self.service)
            if b.state == "active"
        ]
        if urls:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=8,
                    thread_name_prefix=f"kpa-scrape-{self.service}",
                )
            for text in self._pool.map(self._scrape, urls):
                if text is not None:
                    fold_replica_metrics(signals, parse_prom_text(text))
        self.scrape_ms.append((time.perf_counter() - t0) * 1e3)
        return signals
