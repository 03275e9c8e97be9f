"""End-to-end request tracing: one trace id from the gateway edge to the
decode chunk. A copy of ``kubeflow_tpu/obs/trace.py`` (the port imports
nothing of the JAX package), with the same span names, statuses,
retention pools and export shapes, so a trace from a torch replica reads
like one from a JAX replica.

A W3C ``traceparent``-style context minted at the gateway (or accepted
from the client) rides the ``x-kft-trace`` header through every hop
alongside the deadline/priority contract, and each hop records nested
spans into a bounded per-process buffer.

Design constraints, in order:

1. **Lock-light recorder.** Spans are recorded from the engine loop
   thread between device dispatches; ``start``/``end``/``record_span``
   are O(1) dict/list operations under one uncontended lock and NEVER
   touch a tensor (a ``.item()`` here would stall the pipelined loop).
2. **Bounded memory.** Live traces, spans per trace, and every retention
   pool are capped; an abandoned trace (leaked span) is evicted, not
   accumulated.
3. **Tail-based sampling.** A finished trace is always kept when any
   span ended non-ok (error / shed / deadline / watchdog-poisoned) or
   when its duration reaches the rolling p99 of recent traces; the
   healthy fast majority is 1-in-N sampled.
4. **Zero cost when disabled.** ``Tracer.enabled = False`` (or
   ``KFT_TRACE=0`` in the environment) returns a falsy no-op span from
   every call — instrumentation sites guard with ``if span:`` so no
   header is stamped, no timestamp taken, and responses are
   byte-identical.

Clocks: span timestamps are ``time.monotonic()`` (interval arithmetic
only); one wall-clock timestamp is stamped per finished trace for humans.

Export: ``Tracer.snapshot()`` feeds ``GET /debug/traces`` (``ModelServer``
and ``InferenceGateway``), and ``to_perfetto()`` converts a snapshot to
Chrome/Perfetto ``trace_event`` JSON.

TTFT/TPOT: :func:`observe_request_latency` feeds the server-side
histograms, and the engine calls it only when it closes a request's
``engine`` span, so warmup and untraced callers never reach them.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextvars import ContextVar
from typing import Any, Mapping

from kubeflow_tpu_torch.obs import names, prom
from kubeflow_tpu_torch.serve.headers import TRACE_HEADER

__all__ = [
    "TRACE_HEADER",
    "debug_traces",
    "Span",
    "TraceContext",
    "Tracer",
    "TRACER",
    "ctx_from_headers",
    "current_ids",
    "observe_request_latency",
    "to_perfetto",
]

#: span end-statuses that force a trace into the always-keep pool
_KEEP_STATUSES = frozenset({"error", "shed", "deadline", "poisoned"})

SAMPLER_DECISIONS = prom.REGISTRY.counter(
    names.TRACE_SAMPLER_DECISIONS_TOTAL,
    "tail-sampler verdicts on finished traces",
    ("decision",),
)

#: per-model server-side TTFT/TPOT, derived from the engine span stream
#: (first pushed token / steady-state inter-token gap of traced requests;
#: warmup never carries a trace context so it never pollutes these)
TTFT_MS = prom.REGISTRY.histogram(
    names.SERVER_TTFT_MS,
    "server-side time-to-first-token of traced requests (ms)",
    ("model",),
    buckets=prom.MS_BUCKETS,
)
TPOT_MS = prom.REGISTRY.histogram(
    names.SERVER_TPOT_MS,
    "server-side mean time-per-output-token after the first (ms)",
    ("model",),
    buckets=prom.MS_BUCKETS,
)


def observe_request_latency(
    model: str, *, ttft_ms: float | None = None, tpot_ms: float | None = None
) -> None:
    """Record the latency split of one completed traced request."""
    if ttft_ms is not None:
        TTFT_MS.labels(model=model).observe(ttft_ms)
    if tpot_ms is not None:
        TPOT_MS.labels(model=model).observe(tpot_ms)


# --------------------------------------------------------------- context


class TraceContext:
    """The wire-portable half of a span: ids + sampled flag.

    Header shape is W3C traceparent's: ``00-<trace32>-<span16>-<flags>``.
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @staticmethod
    def parse(value: str | None) -> "TraceContext | None":
        """Strictly parse a traceparent-shaped header; anything malformed
        is treated as absent (a hostile header must not break routing)."""
        if not value:
            return None
        parts = value.strip().split("-")
        if len(parts) != 4 or parts[0] != "00":
            return None
        trace_id, span_id, flags = parts[1], parts[2], parts[3]
        if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
            return None
        try:
            int(trace_id, 16), int(span_id, 16), int(flags, 16)
        except ValueError:
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return TraceContext(trace_id, span_id, int(flags, 16) & 1 == 1)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.header()})"


def ctx_from_headers(headers: Mapping[str, str] | None) -> TraceContext | None:
    """Trace context carried by ``headers`` (a plain dict: probe the
    lower-case name and its ``.title()`` spelling, the deadline.py
    idiom)."""
    if not headers:
        return None
    raw = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.title())
    return TraceContext.parse(raw)


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


# ----------------------------------------------------------------- spans


class Span:
    """One timed operation. Mutated only by the hop that owns it."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_span_id",
        "name",
        "start",
        "end_time",
        "attrs",
        "events",
        "status",
        "_tracer",
    )

    def __init__(
        self,
        tracer: "Tracer",
        trace_id: str,
        span_id: str,
        parent_span_id: str | None,
        name: str,
        start: float,
    ):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.start = start
        self.end_time: float | None = None
        self.attrs: dict[str, Any] = {}
        self.events: list[tuple[str, float, dict[str, Any]]] = []
        self.status = "ok"

    def __bool__(self) -> bool:
        return True

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def header(self) -> str:
        """The ``x-kft-trace`` value propagating THIS span as parent."""
        return self.ctx.header()

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def event(self, name: str, **attrs: Any) -> None:
        self.events.append((name, time.monotonic(), attrs))

    def end(self, status: str | None = None) -> None:
        if self.end_time is not None:  # idempotent: first end wins
            return
        if status is not None:
            self.status = status
        self.end_time = time.monotonic()
        self._tracer._on_end(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.end_time is None:
            self.set_attr("error", f"{exc_type.__name__}: {exc}")
            self.end("error")
        else:
            self.end()


class _NoopSpan:
    """Falsy stand-in when tracing is disabled — every method a no-op, so
    instrumentation sites stay branch-free beyond ``if span:``."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    @property
    def ctx(self) -> None:
        return None

    def header(self) -> str:
        return ""

    def set_attr(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self, status: str | None = None) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _TraceRec:
    """Accumulates a trace's spans until every locally-open span ended."""

    __slots__ = ("trace_id", "spans", "open", "dropped", "t_created")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.open = 0
        self.dropped = 0
        self.t_created = time.monotonic()


# ---------------------------------------------------------------- tracer


class Tracer:
    """Process-global span recorder with tail-based retention.

    A trace finishes when its locally-open span count returns to zero
    (the refcount survives retries and hedges: the gateway's ``route``
    span stays open across attempts, a cancelled hedge loser holds the
    trace live until its span unwinds). Finished traces are classified
    once and filed into bounded ring buffers:

    - ``errors``  — any span ended error/shed/deadline/poisoned (kept
      100%, the acceptance bar for explaining failures under load);
    - ``slow``    — root duration ≥ the rolling p99 of a bounded
      duration reservoir (recomputed every 64 finishes);
    - ``sampled`` — 1-in-``sample_every`` of the healthy remainder.
    """

    def __init__(
        self,
        *,
        enabled: bool | None = None,
        max_live: int = 2048,
        max_spans_per_trace: int = 512,
        keep_errors: int = 256,
        keep_slow: int = 64,
        keep_sampled: int = 64,
        sample_every: int = 16,
        p99_window: int = 512,
    ):
        if enabled is None:
            enabled = os.environ.get("KFT_TRACE", "1").lower() not in (
                "0", "false", "off",
            )
        self.enabled = enabled
        self.sample_every = max(1, int(sample_every))
        self._max_live = max_live
        self._max_spans = max_spans_per_trace
        self._lock = threading.Lock()
        self._live: dict[str, _TraceRec] = {}
        self._errors: collections.deque = collections.deque(maxlen=keep_errors)
        self._slow: collections.deque = collections.deque(maxlen=keep_slow)
        self._sampled: collections.deque = collections.deque(maxlen=keep_sampled)
        self._durations: collections.deque = collections.deque(maxlen=p99_window)
        self._p99_ms = float("inf")
        self._finished = 0

    # -- recording ----------------------------------------------------- #

    def span(
        self,
        name: str,
        *,
        parent: "Span | None" = None,
        ctx: TraceContext | None = None,
        start: float | None = None,
    ) -> "Span | _NoopSpan":
        """Open a span: child of ``parent`` (local span) or of ``ctx``
        (remote parent off the wire); with neither, mint a new trace."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is not None and parent:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            trace_id, parent_id = _new_trace_id(), None
        s = Span(
            self, trace_id, _new_span_id(), parent_id, name,
            time.monotonic() if start is None else start,
        )
        with self._lock:
            rec = self._rec_locked(trace_id)
            rec.open += 1
            if len(rec.spans) < self._max_spans:
                rec.spans.append(s)
            else:
                rec.dropped += 1
        return s

    def record_span(
        self,
        name: str,
        *,
        parent: "Span | None" = None,
        ctx: TraceContext | None = None,
        start: float = 0.0,
        end: float = 0.0,
        attrs: dict[str, Any] | None = None,
        status: str = "ok",
    ) -> None:
        """Record an already-completed span retroactively — the decode
        path stamps chunk boundaries and reports them at drain time so
        the engine loop never holds an open span per chunk."""
        if not self.enabled:
            return
        if parent is not None and parent:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            return
        s = Span(self, trace_id, _new_span_id(), parent_id, name, start)
        s.end_time = end
        s.status = status
        if attrs:
            s.attrs.update(attrs)
        with self._lock:
            rec = self._live.get(trace_id)
            if rec is None:
                # late fragment (trace already finalized): drop rather
                # than resurrect a second partial trace under the same id
                return
            if len(rec.spans) < self._max_spans:
                rec.spans.append(s)
            else:
                rec.dropped += 1

    def _rec_locked(self, trace_id: str) -> _TraceRec:
        rec = self._live.get(trace_id)
        if rec is None:
            while len(self._live) >= self._max_live:  # evict oldest live
                stale_id = next(iter(self._live))
                self._finalize_locked(self._live.pop(stale_id), evicted=True)
            rec = _TraceRec(trace_id)
            self._live[trace_id] = rec
        return rec

    def _on_end(self, span: Span) -> None:
        with self._lock:
            rec = self._live.get(span.trace_id)
            if rec is None:
                return
            rec.open -= 1
            if rec.open <= 0:
                del self._live[span.trace_id]
                self._finalize_locked(rec)

    # -- tail sampling ------------------------------------------------- #

    def _finalize_locked(self, rec: _TraceRec, evicted: bool = False) -> None:
        spans = [s for s in rec.spans if s.end_time is not None] or rec.spans
        if not spans:
            return
        t0 = min(s.start for s in spans)
        t1 = max(s.end_time if s.end_time is not None else s.start for s in spans)
        duration_ms = (t1 - t0) * 1e3
        keep = None
        for s in spans:
            if s.status in _KEEP_STATUSES:
                keep = s.status
                break
        self._finished += 1
        self._durations.append(duration_ms)
        if self._finished % 64 == 0 and self._durations:
            ordered = sorted(self._durations)
            self._p99_ms = ordered[min(len(ordered) - 1,
                                       int(0.99 * len(ordered)))]
        doc = self._render_locked(rec, spans, t0, duration_ms, evicted)
        if keep is not None:
            doc["kept"] = keep
            self._errors.append(doc)
            SAMPLER_DECISIONS.labels(decision="error").inc()
        elif len(self._durations) >= 64 and duration_ms >= self._p99_ms:
            doc["kept"] = "slow_p99"
            self._slow.append(doc)
            SAMPLER_DECISIONS.labels(decision="slow").inc()
        elif self._finished % self.sample_every == 0:
            doc["kept"] = "sampled"
            self._sampled.append(doc)
            SAMPLER_DECISIONS.labels(decision="sampled").inc()
        else:
            SAMPLER_DECISIONS.labels(decision="dropped").inc()

    @staticmethod
    def _render_locked(
        rec: _TraceRec, spans: list[Span], t0: float,
        duration_ms: float, evicted: bool,
    ) -> dict[str, Any]:
        def ms(t: float | None) -> float:
            return round(((t if t is not None else t0) - t0) * 1e3, 3)

        return {
            "trace_id": rec.trace_id,
            "kept": "",
            "duration_ms": round(duration_ms, 3),
            # wall-clock stamp for humans reading the export; every
            # interval in the trace is monotonic-derived
            "wall_time": time.time(),  # display only, never in interval arithmetic
            "evicted": evicted,
            "dropped_spans": rec.dropped,
            "spans": [
                {
                    "span_id": s.span_id,
                    "parent_span_id": s.parent_span_id,
                    "name": s.name,
                    "start_ms": ms(s.start),
                    "end_ms": ms(s.end_time),
                    "status": s.status,
                    "attrs": dict(s.attrs),
                    "events": [
                        {"name": n, "ts_ms": ms(t), "attrs": dict(a)}
                        for n, t, a in s.events
                    ],
                }
                for s in sorted(spans, key=lambda s: s.start)
            ],
        }

    # -- export -------------------------------------------------------- #

    def snapshot(self, limit: int = 64) -> dict[str, Any]:
        """Retained traces, newest first, errors before slow before
        sampled — what ``/debug/traces`` serves."""
        with self._lock:
            pools = (
                list(self._errors), list(self._slow), list(self._sampled),
            )
            live = len(self._live)
            p99 = self._p99_ms
            finished = self._finished
        seen: set[str] = set()
        out: list[dict[str, Any]] = []
        for pool in pools:
            for doc in reversed(pool):
                if doc["trace_id"] in seen:
                    continue
                seen.add(doc["trace_id"])
                out.append(doc)
                if len(out) >= limit:
                    break
            if len(out) >= limit:
                break
        return {
            "traces": out,
            "live": live,
            "finished": finished,
            "p99_ms": None if p99 == float("inf") else round(p99, 3),
        }

    def clear(self) -> None:
        """Drop all retained and live traces (test isolation)."""
        with self._lock:
            self._live.clear()
            self._errors.clear()
            self._slow.clear()
            self._sampled.clear()
            self._durations.clear()
            self._p99_ms = float("inf")
            self._finished = 0


#: Process-wide default tracer — every hop records here, the way REGISTRY
#: is the process-wide default metric registry.
TRACER = Tracer()


# ----------------------------------------------------- log correlation

_CURRENT: ContextVar["Span | None"] = ContextVar("kft-current-span", default=None)


def set_current(span: "Span | _NoopSpan"):
    """Bind ``span`` as the ambient span for log correlation; returns a
    token for :func:`reset_current`."""
    return _CURRENT.set(span if span else None)


def reset_current(token) -> None:
    _CURRENT.reset(token)


def current_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the ambient span, for log records."""
    span = _CURRENT.get()
    if span is None:
        return None
    return span.trace_id, span.span_id


# ------------------------------------------------------ perfetto export


def to_perfetto(snapshot: dict[str, Any] | list[dict[str, Any]]) -> dict[str, Any]:
    """Convert a :meth:`Tracer.snapshot` document (or its ``traces``
    list) to Chrome/Perfetto ``trace_event`` JSON: one process per
    trace, complete ("X") events for spans, instant ("i") events for
    span events — load the result straight into ``ui.perfetto.dev``."""
    traces = snapshot["traces"] if isinstance(snapshot, dict) else snapshot
    events: list[dict[str, Any]] = []
    for pidx, tr in enumerate(traces):
        pid = pidx + 1
        label = f"trace {tr['trace_id'][:8]}"
        if tr.get("kept"):
            label += f" [{tr['kept']}]"
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        for s in tr.get("spans", ()):
            ts = round(s["start_ms"] * 1e3, 3)
            dur = round(max(s["end_ms"] - s["start_ms"], 0.0) * 1e3, 3)
            args = dict(s.get("attrs", {}))
            args["span_id"] = s["span_id"]
            if s.get("parent_span_id"):
                args["parent_span_id"] = s["parent_span_id"]
            if s.get("status", "ok") != "ok":
                args["status"] = s["status"]
            events.append({
                "ph": "X", "name": s["name"], "cat": "kft",
                "pid": pid, "tid": 1, "ts": ts, "dur": dur, "args": args,
            })
            for ev in s.get("events", ()):
                events.append({
                    "ph": "i", "s": "t", "name": ev["name"], "cat": "kft",
                    "pid": pid, "tid": 1,
                    "ts": round(ev["ts_ms"] * 1e3, 3),
                    "args": dict(ev.get("attrs", {})),
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def debug_traces(query: str, tracer: Tracer | None = None) -> dict[str, Any]:
    """The ``GET /debug/traces`` answer for a URL query string: the newest
    ``limit`` retained traces (1–256, default 64), or with
    ``format=perfetto`` their ``trace_event`` JSON. A ``limit`` that is
    not an integer raises ``ValueError``."""
    import urllib.parse

    args = urllib.parse.parse_qs(query)
    try:
        limit = int(args.get("limit", ["64"])[0])
    except ValueError:
        raise ValueError("limit must be an integer") from None
    snap = (tracer or TRACER).snapshot(limit=max(1, min(limit, 256)))
    if args.get("format", [""])[0] == "perfetto":
        return to_perfetto(snap)
    return snap
