"""The serving-load harness: the REAL stack, in one process. The port of
``kubeflow_tpu/loadgen/harness.py`` on threads: ``run_serving_load(cfg)``
is a blocking call that returns the goodput report.

Assembles the serving plane — the port's ``InferenceGateway`` edge
(policy, retries, SSE failover), ``ServingAutoscaler`` +
``GatewaySignalSource`` + ``ReplicaFleet``, and in-process
``ModelServer`` replicas running ``LMEngineModel`` — drives a seeded
open-loop schedule through it over HTTP/SSE, and returns the report.
Every request crosses the wire twice and every metric the reporter reads
is scraped off ``/metrics`` like any Prometheus would.

The defaults are the JAX harness's: its tiny model, four rows, two-step
chunks, one 32-token prefill bucket, a 32-entry prefix cache, a 0.1 s
watchdog with a 60 s wedge floor, and identical weights in every
replica. Four fields go beyond it: the model config, a state dict, the
engine's keyword arguments (``kv_pool_tokens``, ``page_size``, ...) and
the device, which is CUDA unless the caller asks for the CPU, as at
every entry point of the port.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Mapping

from kubeflow_tpu_torch.autoscale.signals import http_call
from kubeflow_tpu_torch.loadgen.arrivals import OnOffArrivals, PoissonArrivals
from kubeflow_tpu_torch.loadgen.chaos import ChaosOverlay, apply_overlay
from kubeflow_tpu_torch.loadgen.client import LoadClient
from kubeflow_tpu_torch.loadgen.reporter import build_report, scrape_metrics
from kubeflow_tpu_torch.loadgen.workload import TenantSpec, WorkloadMix

__all__ = ["HarnessConfig", "run_serving_load", "default_mix"]


def default_mix(seed: int = 0) -> WorkloadMix:
    """The bench's standard two-class tenant population: an interactive
    tenant with a deadline and priority riding next to best-effort batch
    traffic pinned to an adapter — the mix the SLO-goodput story is
    about."""
    return WorkloadMix(
        prompt_lens=(6, 10, 16),
        output_lens=(4, 6, 8),
        tenants=(
            TenantSpec(
                "interactive", weight=2.0, priority=2,
                deadline_ms=30_000.0, slo_ms=30_000.0,
            ),
            TenantSpec(
                "batch", weight=1.0, priority=0, adapter="batch-v1",
            ),
        ),
        vocab=80,
        seed=seed,
    )


@dataclasses.dataclass
class HarnessConfig:
    seed: int = 0
    process: str = "poisson"          # poisson | onoff
    rate_rps: float = 6.0
    burst_rps: float = 12.0           # onoff only
    period_s: float = 4.0             # onoff only
    duration_s: float = 10.0
    mix: WorkloadMix | None = None
    model_name: str = "m"
    initial_replicas: int = 1
    max_replicas: int = 2
    min_replicas: int = 1
    kpa_target: float = 2.0
    scale_to_zero_grace_s: float = 1.2
    #: after the measured window: let the fleet drain to zero, then time
    #: one cold request through the activator (needs min_replicas=0)
    measure_cold_recovery: bool = False
    chaos: ChaosOverlay | None = None
    request_timeout_s: float = 180.0
    max_new_tokens_cap: int = 12      # model-level engine cap
    #: the replicas' ``TransformerConfig``; None is the JAX harness's tiny
    #: f32 model (vocab 89, d_model 32, 2 layers, 4 heads, d_ff 64)
    model_config: Any = None
    #: weights for every replica; None is ``init_weights`` from seed 0,
    #: the same in every replica
    state_dict: Mapping[str, Any] | None = None
    #: extra ``LMEngineModel`` engine knobs, e.g. ``kv_pool_tokens``,
    #: ``page_size``, ``paged_attn_impl`` (the JAX harness runs the dense
    #: cache)
    engine_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    #: the replicas' device; None means CUDA
    device: Any = None


def _schedule(cfg: HarnessConfig):
    if cfg.process == "poisson":
        return PoissonArrivals(
            rate_rps=cfg.rate_rps, duration_s=cfg.duration_s,
            seed=cfg.seed,
        ).schedule()
    if cfg.process == "onoff":
        return OnOffArrivals(
            base_rps=cfg.rate_rps, burst_rps=cfg.burst_rps,
            period_s=cfg.period_s, duration_s=cfg.duration_s,
            seed=cfg.seed,
        ).schedule()
    raise ValueError(f"unknown arrival process {cfg.process!r}")


def run_serving_load(
    cfg: HarnessConfig, *, harness_stats: dict | None = None
) -> dict[str, Any]:
    """One load run; returns the report. ``harness_stats``, when given,
    is filled with what the run measures of itself and the report has no
    key for: ``results`` (the client's ``RequestResult`` a request, in
    schedule order), ``client_lag_ms`` (per request, how late its thread
    started against the schedule) and ``scrape_ms`` (per autoscaler tick
    of the measured window, the signal source's scrape of every
    replica's ``/metrics``)."""
    import torch

    from kubeflow_tpu_torch.autoscale import (
        GatewaySignalSource,
        KPAConfig,
        ReplicaFleet,
        ServingAutoscaler,
    )
    from kubeflow_tpu_torch.gateway.router import ServiceRoute
    from kubeflow_tpu_torch.gateway.server import GatewayConfig, InferenceGateway
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.headers import SEED_HEADER
    from kubeflow_tpu_torch.serve.model import BucketSpec
    from kubeflow_tpu_torch.serve.server import ModelServer

    mix = cfg.mix or default_mix(cfg.seed)
    tcfg = cfg.model_config or TransformerConfig(
        vocab_size=89, d_model=32, n_layers=2, n_heads=4, d_ff=64,
        causal=True, max_seq_len=256, attn_impl="reference",
        dtype=torch.float32,
    )

    replicas: dict[str, LMEngineModel] = {}

    def launch(index: int):
        m = LMEngineModel(
            cfg.model_name, config=tcfg, state_dict=cfg.state_dict,
            device=cfg.device, max_batch=4, chunk_steps=2,
            buckets=BucketSpec(batch_sizes=(1,), seq_lens=(32,)),
            max_new_tokens=cfg.max_new_tokens_cap, eos_id=tcfg.vocab_size + 1,
            # min_wedge must exceed worst-case stalls (a replica launched
            # beside a busy one) or the watchdog false-trips; a
            # chaos-wedged engine recovers via the injector's hold_s
            # expiring + gateway retries/breaker
            watchdog_interval_s=0.1, watchdog_min_wedge_s=60.0,
            prefix_cache_entries=32, **dict(cfg.engine_kwargs),
        )
        ms = ModelServer([m], http_port=0).start()  # loads the model first
        url = f"http://127.0.0.1:{ms.port}"
        replicas[url] = m

        def stop():
            replicas.pop(url, None)
            ms.stop()  # drains, closes the listener, unloads the model

        return url, stop

    asc = ServingAutoscaler(tick_interval_s=0.15)
    gw = InferenceGateway(GatewayConfig(
        probe_interval_s=0.25, failure_threshold=2, recovery_s=1.0,
        activation_timeout_s=60.0, retry_budget_floor=100,
        routes=[ServiceRoute(name=cfg.model_name, max_attempts=4)],
    ), http_port=0, scale_up=asc.kick)
    fleet = ReplicaFleet(
        cfg.model_name, launch, pool=gw.pool, model=cfg.model_name,
    )
    source = GatewaySignalSource(gw, cfg.model_name)
    asc.add_service(cfg.model_name, KPAConfig(
        target=cfg.kpa_target, min_replicas=cfg.min_replicas,
        max_replicas=cfg.max_replicas, stable_window_s=3.0,
        panic_window_s=0.6, panic_threshold=1.5, max_scale_down_rate=2.0,
        scale_to_zero_grace_s=cfg.scale_to_zero_grace_s,
    ), source, fleet)

    schedule = _schedule(cfg)
    specs = mix.plan(len(schedule))
    client = LoadClient(
        "http://127.0.0.1:0", cfg.model_name,
        request_timeout_s=cfg.request_timeout_s,
    )

    try:
        fleet.scale_to(cfg.initial_replicas)
        gw.start()
        client.base_url = f"http://127.0.0.1:{gw.http_port}"

        # warm EVERY initial replica OUTSIDE the measured window, over the
        # real streaming path and WITH a seed header (the gateway stamps
        # x-kft-seed on every generate request, so the seeded sampling
        # path is the one traffic takes). Requests go to the replica
        # DIRECTLY, with no trace header — untraced requests record
        # nothing in the TTFT/TPOT histograms. One request per distinct
        # (prompt_len, budget) shape in the plan; replicas the autoscaler
        # launches mid-run stay cold on purpose (their first requests are
        # part of the scale-up latency).
        shapes: dict[tuple[int, int], Any] = {}
        for spec in specs:
            shapes.setdefault(
                (len(spec.prompt_ids), spec.max_new_tokens), spec
            )
        for url in list(replicas):
            for spec in shapes.values():
                http_call(
                    f"{url}/v2/models/{cfg.model_name}/generate_stream",
                    body=json.dumps({
                        "input_ids": list(spec.prompt_ids),
                        "max_new_tokens": min(
                            spec.max_new_tokens, cfg.max_new_tokens_cap,
                        ),
                    }).encode(),
                    headers={SEED_HEADER: "1"},
                    timeout_s=cfg.request_timeout_s,
                )

        def engines(model: str):
            live = set(fleet.urls())
            return [
                m.engine for url, m in list(replicas.items())
                if url in live and m.name == model and m.engine is not None
            ]

        # baseline scrape: warmup traffic (and any earlier run in this
        # process) is subtracted out of the report's counters/histograms
        baseline = scrape_metrics(client.base_url + "/metrics")

        source.scrape_ms.clear()
        asc.start()
        t0 = time.monotonic()
        fired: list[str] = []
        chaos_thread = None
        if cfg.chaos is not None:
            chaos_thread = threading.Thread(
                target=lambda: fired.extend(
                    apply_overlay(cfg.chaos, engines, t0=t0)),
                name="loadgen-chaos", daemon=True,
            )
            chaos_thread.start()
        results = client.run(schedule, specs)
        if chaos_thread is not None:
            chaos_thread.join(cfg.chaos.at_s + 60.0)
        asc.stop()
        if harness_stats is not None:
            harness_stats["results"] = results
            harness_stats["client_lag_ms"] = [
                s * 1e3 for s in client.dispatch_lag_s]
            harness_stats["scrape_ms"] = list(source.scrape_ms)

        gw_metrics = scrape_metrics(client.base_url + "/metrics")
        # /debug/traces lives on the replica ModelServer; any live
        # replica sees the whole in-process trace pool
        traces = None
        if fleet.urls():
            traces = json.loads(scrape_metrics(
                fleet.urls()[0] + "/debug/traces?limit=256"
            ))

        extra: dict[str, Any] = {}
        if cfg.measure_cold_recovery and cfg.min_replicas == 0:
            # drain: stable window empties, grace expires, replicas -> 0
            asc.start()
            deadline = time.monotonic() + 60
            while fleet.current() > 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            asc.stop()
            if fleet.current() == 0:
                # one cold request parks in the activator, kicks the
                # autoscaler, and times the 0->1 relaunch end to end
                asc.start()
                cold0 = time.monotonic()
                one = client.run(
                    (0.0,), (dataclasses.replace(specs[0], index=0),)
                )
                asc.stop()
                extra["cold_recovery"] = {
                    "recovery_s": round(time.monotonic() - cold0, 3),
                    "outcome": one[0].outcome,
                }

        return build_report(
            results=results,
            run={
                "bench": "serving_load",
                "seed": cfg.seed,
                "process": cfg.process,
                "rate_rps": cfg.rate_rps,
                "duration_s": cfg.duration_s,
                "offered_requests": len(schedule),
                "model": cfg.model_name,
                "replicas_initial": cfg.initial_replicas,
                "replicas_max": cfg.max_replicas,
                "tenants": [t.name for t in mix.tenants],
            },
            gateway_metrics=gw_metrics,
            baseline_metrics=baseline,
            traces=traces,
            fleet_events=list(fleet.events),
            run_t0=t0,
            chaos_window=(
                cfg.chaos.window if cfg.chaos is not None else None
            ),
            chaos_faults=fired,
            extra=extra,
        )
    finally:
        asc.stop()
        source.close()
        fleet.close()
        gw.stop()
