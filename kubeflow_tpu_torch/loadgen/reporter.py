"""Report builder: server metrics + client truth → one machine-readable
goodput report. A copy of ``kubeflow_tpu/loadgen/reporter.py`` with
:func:`scrape_metrics` on ``http.client``.

The report is the deliverable of a load run, in the schema of the JAX
harness's report. Latency comes from the server-side
histograms (``kft_server_ttft_ms``/``kft_server_tpot_ms``), quantiles
estimated with the standard Prometheus ``histogram_quantile`` bucket
interpolation; goodput comes from the CLIENT's outcome record (server
counters can't see a response that died on the wire); autoscale timing
comes from the fleet's read-only scale-event log; stream-resume and
prefix counters come straight off ``/metrics``. When a chaos overlay ran,
the report splits goodput inside vs outside the injected window, so the
dip is *attributed*, not merely present.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from kubeflow_tpu_torch.autoscale.signals import http_call, metric_sum, parse_prom_text
from kubeflow_tpu_torch.loadgen.client import RequestResult, summarize_outcomes
from kubeflow_tpu_torch.obs import names

__all__ = [
    "histogram_quantile",
    "goodput",
    "build_report",
    "scrape_metrics",
]


def _matches(labels: Mapping[str, str], match: Mapping[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in match.items())


def histogram_quantile(
    parsed: Mapping[str, list], name: str, q: float, **match: str
) -> float | None:
    """Prometheus-idiom quantile estimate from ``<name>_bucket`` samples:
    find the bucket the q-th observation falls in, interpolate linearly
    inside it (the +Inf bucket clamps to the last finite bound). Buckets
    with matching labels are summed first, so a per-model quantile and an
    all-models quantile use the same code path."""
    buckets: dict[float, float] = {}
    for labels, value in parsed.get(f"{name}_bucket", ()):
        rest = {k: v for k, v in labels.items() if k != "le"}
        if not _matches(rest, match):
            continue
        le = labels.get("le", "+Inf")
        bound = float("inf") if le == "+Inf" else float(le)
        buckets[bound] = buckets.get(bound, 0.0) + value
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound in bounds:
        count = buckets[bound]
        if count >= rank:
            if bound == float("inf"):
                # can't interpolate into +Inf: clamp to last finite bound
                finite = [b for b in bounds if b != float("inf")]
                return finite[-1] if finite else None
            if count == prev_count:
                return bound
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_count = bound, count
    return bounds[-1]


def _hist_summary(
    parsed: Mapping[str, list], name: str, **match: str
) -> dict[str, Any]:
    count = metric_sum(parsed, f"{name}_count", **match)
    out = {
        "count": int(count),
        "p50": histogram_quantile(parsed, name, 0.50, **match),
        "p99": histogram_quantile(parsed, name, 0.99, **match),
    }
    if count:
        out["mean"] = metric_sum(parsed, f"{name}_sum", **match) / count
    return out


def _pct(xs: Sequence[float], q: float) -> float | None:
    if not xs:
        return None
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def goodput(results: Sequence[RequestResult]) -> dict[str, Any]:
    """Knative-style SLO goodput over one result set: the fraction of
    OFFERED load completed within its SLO. Sheds and late completions
    both count against goodput (the platform either refused the work or
    broke the promise); only ``error`` counts as a failure."""
    outcomes = summarize_outcomes(results)
    n = len(results)
    return {
        "offered": n,
        **outcomes,
        "goodput": (outcomes["completed_in_slo"] / n) if n else None,
    }


def _grouped(results: Sequence[RequestResult], key) -> dict[str, Any]:
    groups: dict[str, list[RequestResult]] = {}
    for r in results:
        groups.setdefault(str(key(r)), []).append(r)
    return {k: goodput(v) for k, v in sorted(groups.items())}


def _scale_up_latency(
    events: Sequence[Mapping[str, Any]], t0: float
) -> dict[str, Any]:
    """1→N scale-up timing from the fleet's event log: offset (from run
    start ``t0``, monotonic) at which each replica count was FIRST
    reached, plus the latency from run start to the peak. Events before
    ``t0`` (initial provisioning, warmup) appear in the timeline but do
    not count as scale-up — the latency measured is the autoscaler's
    reaction to the run's load, not the harness's setup."""
    first_reach: dict[int, float] = {}
    peak = 0
    for ev in events:
        n = int(ev["replicas"])
        t = ev["t"] - t0
        if t < 0:
            continue
        peak = max(peak, n)
        if n not in first_reach and ev["direction"] == "up":
            first_reach[n] = t
    return {
        "replicas_peak": peak,
        "first_reached_s": {
            str(n): round(t, 3) for n, t in sorted(first_reach.items())
        },
        "scale_up_latency_s": (
            round(first_reach[peak], 3) if peak in first_reach else None
        ),
        "events": [
            {
                "t_s": round(ev["t"] - t0, 3),
                "replicas": ev["replicas"],
                "direction": ev["direction"],
            }
            for ev in events
        ],
    }


def build_report(
    *,
    results: Sequence[RequestResult],
    run: Mapping[str, Any],
    gateway_metrics: str | None = None,
    replica_metrics: Sequence[str] = (),
    baseline_metrics: str | None = None,
    traces: Mapping[str, Any] | None = None,
    fleet_events: Sequence[Mapping[str, Any]] = (),
    run_t0: float | None = None,
    chaos_window: tuple[float, float] | None = None,
    chaos_faults: Sequence[str] = (),
    extra: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """Pure function from scraped text + client results to the report.

    ``gateway_metrics``/``replica_metrics`` are raw ``/metrics`` bodies
    (in-process harnesses share one registry, so the gateway body alone
    already carries the engine histograms; remote replicas add theirs).
    ``baseline_metrics`` is a pre-run scrape: counter-like samples
    (``*_total``/``_bucket``/``_sum``/``_count``) have their baseline
    value subtracted, so warmup traffic and prior runs in the same
    process drop out of the report. ``chaos_window`` is
    ``(start_s, end_s)`` offsets into the run.
    """
    merged: dict[str, list] = {}
    for text in ([gateway_metrics] if gateway_metrics else []) + list(
        replica_metrics
    ):
        for name, samples in parse_prom_text(text).items():
            # in-process replicas share the gateway registry: identical
            # (labels, value) samples are the SAME child scraped twice,
            # not two replicas — keep one copy
            seen = merged.setdefault(name, [])
            for s in samples:
                if s not in seen:
                    seen.append(s)
    if baseline_metrics:
        base: dict[tuple[str, frozenset], float] = {}
        for name, samples in parse_prom_text(baseline_metrics).items():
            for labels, value in samples:
                base[(name, frozenset(labels.items()))] = value
        counterish = ("_total", "_bucket", "_sum", "_count")
        for name, samples in merged.items():
            if not name.endswith(counterish):
                continue  # gauges carry state, not accumulation
            merged[name] = [
                (labels, max(
                    0.0,
                    value - base.get(
                        (name, frozenset(labels.items())), 0.0
                    ),
                ))
                for labels, value in samples
            ]

    ttft_client = [r.ttft_ms for r in results if r.ttft_ms is not None]
    latency = {
        "ttft_ms": _hist_summary(merged, names.SERVER_TTFT_MS),
        "tpot_ms": _hist_summary(merged, names.SERVER_TPOT_MS),
        "client_ttft_ms": {
            "count": len(ttft_client),
            "p50": _pct(ttft_client, 0.50),
            "p99": _pct(ttft_client, 0.99),
        },
        "client_e2e_ms": {
            "p50": _pct([r.e2e_ms for r in results], 0.50),
            "p99": _pct([r.e2e_ms for r in results], 0.99),
        },
    }

    report: dict[str, Any] = {
        "run": dict(run),
        "latency": latency,
        "goodput": {
            "overall": goodput(results),
            "per_tenant": _grouped(results, lambda r: r.tenant),
            "per_priority": _grouped(
                results,
                lambda r: r.priority if r.priority is not None else "none",
            ),
        },
        "server": {
            "requests_total": metric_sum(
                merged, names.GATEWAY_REQUESTS_TOTAL
            ),
            "shed_total": metric_sum(merged, names.GATEWAY_SHED_TOTAL),
            "retries_total": metric_sum(
                merged, names.GATEWAY_RETRIES_TOTAL
            ),
            "stream_resumes_ok": metric_sum(
                merged, names.GATEWAY_STREAM_RESUMES_TOTAL, outcome="ok"
            ),
            "stream_resumes_failed": metric_sum(
                merged, names.GATEWAY_STREAM_RESUMES_TOTAL,
                outcome="failed",
            ),
            "engine_deadline_expired": metric_sum(
                merged, names.ENGINE_DEADLINE_EXPIRED_TOTAL
            ),
            "engine_admission_shed": metric_sum(
                merged, names.ENGINE_ADMISSION_SHED_TOTAL
            ),
            "prefix_hits_total": metric_sum(
                merged, names.ENGINE_PREFIX_HITS_TOTAL
            ),
            "kv_transfers_total": metric_sum(
                merged, names.AUTOSCALER_KV_TRANSFERS_TOTAL
            ),
            "chaos_injected_total": metric_sum(
                merged, names.CHAOS_INJECTED_TOTAL
            ),
        },
    }
    if fleet_events and run_t0 is not None:
        report["autoscale"] = _scale_up_latency(fleet_events, run_t0)
    if traces is not None:
        report["traces"] = {
            "finished": traces.get("finished"),
            "kept": len(traces.get("traces", ())),
            "p99_ms": traces.get("p99_ms"),
        }
    if chaos_window is not None:
        a, b = chaos_window
        inside = [r for r in results if a <= r.offset_s < b]
        outside = [r for r in results if not (a <= r.offset_s < b)]
        gin, gout = goodput(inside), goodput(outside)
        report["chaos"] = {
            "faults": list(chaos_faults),
            "window_s": [round(a, 3), round(b, 3)],
            "in_window": gin,
            "outside_window": gout,
            # the attribution headline: how much goodput the injected
            # window cost relative to the rest of the run
            "goodput_dip": (
                round(gout["goodput"] - gin["goodput"], 4)
                if gin["goodput"] is not None
                and gout["goodput"] is not None else None
            ),
            "client_visible_failures": sum(r.failed for r in results),
        }
    if extra:
        report.update(extra)
    return report


def scrape_metrics(url: str, *, timeout_s: float = 30.0) -> str:
    """GET one ``/metrics`` (or ``/debug/traces``) body; a status other
    than 200 raises."""
    status, body = http_call(url, timeout_s=timeout_s)
    if status != 200:
        raise RuntimeError(f"GET {url}: HTTP {status}")
    return body.decode()
