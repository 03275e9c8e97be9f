"""Serving load harness: open-loop traffic, SLO goodput, chaos overlays —
the port of ``kubeflow_tpu/loadgen`` on threads and the standard library.

Seeded open-loop arrival processes (Poisson, bursty on-off, trace replay)
drive the port's :class:`~kubeflow_tpu_torch.gateway.server.InferenceGateway`
and an autoscaled :class:`~kubeflow_tpu_torch.autoscale.fleet.ReplicaFleet`
over HTTP/SSE; a reporter folds server metrics and client truth into one
machine-readable goodput report, and chaos overlays compose serving
fault plans with the run timeline so every goodput dip is attributed to
its injected window.

- :mod:`arrivals` — seeded schedules: same seed, same offsets, always;
- :mod:`workload` — prompt/output-length mixtures + per-tenant
  deadline/priority/adapter header mixes;
- :mod:`client` — the open-loop HTTP/SSE driver (gateway's own frame
  splitter; client-side outcome taxonomy);
- :mod:`reporter` — ``/metrics`` + ``/debug/traces`` → the report;
- :mod:`chaos` — FaultPlan overlays armed at run offsets;
- :mod:`harness` — the end-to-end assembly, ``run_serving_load``.
"""

from kubeflow_tpu_torch.loadgen.arrivals import (
    OnOffArrivals,
    PoissonArrivals,
    ReplayArrivals,
    ReplayRequest,
)
from kubeflow_tpu_torch.loadgen.chaos import ChaosOverlay, apply_overlay
from kubeflow_tpu_torch.loadgen.client import (
    LoadClient,
    RequestResult,
    summarize_outcomes,
)
from kubeflow_tpu_torch.loadgen.harness import (
    HarnessConfig,
    default_mix,
    run_serving_load,
)
from kubeflow_tpu_torch.loadgen.reporter import (
    build_report,
    goodput,
    histogram_quantile,
    scrape_metrics,
)
from kubeflow_tpu_torch.loadgen.workload import RequestSpec, TenantSpec, WorkloadMix

__all__ = [
    "ChaosOverlay",
    "HarnessConfig",
    "LoadClient",
    "OnOffArrivals",
    "PoissonArrivals",
    "ReplayArrivals",
    "ReplayRequest",
    "RequestResult",
    "RequestSpec",
    "TenantSpec",
    "WorkloadMix",
    "apply_overlay",
    "build_report",
    "default_mix",
    "goodput",
    "histogram_quantile",
    "run_serving_load",
    "scrape_metrics",
    "summarize_outcomes",
]
