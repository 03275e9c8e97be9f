"""Prometheus-style process metrics: counters, gauges, histograms.

A copy of ``kubeflow_tpu/obs/prom.py`` (the port imports nothing of the
JAX package): an in-process registry with the standard instrument types
and the text exposition format (``# HELP``/``# TYPE`` + ``name{labels}
value`` lines), identical line for line to the JAX package's, so a
scraper reads a torch replica as it reads a JAX one.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Iterable, Mapping

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
)

#: millisecond-scale buckets for latency histograms recorded in ms
#: (TTFT/TPOT): the seconds-scale defaults would collapse every
#: observation into the +Inf bucket
MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


def _label_key(labels: Mapping[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared machinery: one child per label-set, locked mutation."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[tuple[str, str], ...], object] = {}

    def labels(self, **labels: str):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(f"{self.name} has labels; use .labels(...)")
        return self.labels()

    def _make_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def expose(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            lines.extend(self._expose_child(key, child))
        return lines

    def _expose_child(self, key, child) -> list[str]:  # pragma: no cover
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def _expose_child(self, key, child) -> list[str]:
        return [f"{self.name}{_fmt_labels(key)} {_fmt_value(child.value)}"]


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def _expose_child(self, key, child) -> list[str]:
        return [f"{self.name}{_fmt_labels(key)} {_fmt_value(child.value)}"]


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)  # cumulative on exposition
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            if i < len(self.counts):
                self.counts[i] += 1
            self.total += value
            self.count += 1


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Iterable[str] = (),
        buckets: Iterable[float] = _DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def time(self):
        """Context manager observing the elapsed wall time."""
        return _Timer(self._default_child())

    def _expose_child(self, key, child) -> list[str]:
        lines = []
        cum = 0
        with child._lock:
            counts = list(child.counts)
            total, count = child.total, child.count
        for le, n in zip(child.buckets, counts):
            cum += n
            le_label = 'le="%s"' % _fmt_value(le)
            lines.append(
                f"{self.name}_bucket{_fmt_labels(key, le_label)} {cum}"
            )
        inf_label = 'le="+Inf"'
        lines.append(
            f"{self.name}_bucket{_fmt_labels(key, inf_label)} {count}"
        )
        lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
        lines.append(f"{self.name}_count{_fmt_labels(key)} {count}")
        return lines


class _Timer:
    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._child.observe(time.perf_counter() - self._t0)


class Registry:
    """Holds metrics; renders the exposition document.

    ``add_collector`` registers an on-scrape callback that refreshes gauges
    from live objects (e.g. a batcher's running stats) right before every
    exposition — the pull-model analog of client_golang's Collector
    interface, so instrumented objects never need their own publish loop.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: dict[object, object] = {}

    def add_collector(self, fn, key: object | None = None) -> None:
        """Call ``fn()`` before each exposition; ``key`` enables removal."""
        with self._lock:
            self._collectors[key if key is not None else fn] = fn

    def remove_collector(self, key: object) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (
                    type(existing) is not type(metric)
                    or existing.label_names != metric.label_names
                    or getattr(existing, "buckets", None)
                    != getattr(metric, "buckets", None)
                ):
                    raise ValueError(
                        f"metric {metric.name} re-registered with a "
                        "different type, labels, or buckets"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str, labels: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help: str, labels: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labels))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str,
        labels: Iterable[str] = (),
        buckets: Iterable[float] = _DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(name, help, labels, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — one bad collector must not
                pass  # take down the whole /metrics endpoint
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


#: Process-wide default registry: the serving and training metrics of the
#: port register here.
REGISTRY = Registry()
