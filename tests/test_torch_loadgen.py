"""The load harness in ``kubeflow_tpu_torch`` (``loadgen/``, on threads and
the standard library) against the JAX package's (``kubeflow_tpu/loadgen``,
asyncio and aiohttp), on the CPU.

(a) The pure modules on the same seeded inputs, compared for equality:
    Poisson, on/off and replay schedules (float for float), workload
    plans with their headers (the adapter header included), the
    reporter's quantiles, goodput and whole report, and the chaos
    overlay's victim draw and fired kinds.
(b) Both ``LoadClient``s against one scripted stdlib backend: a whole
    stream, a torn first frame, a late stream, EOF before the terminal
    frame, an error frame, a connection cut mid-chunk, 429, 503 with and
    without ``Retry-After``, and the unary route: the same outcome,
    status and token count a request.
(c) The slice as a whole: the JAX ``run_serving_load`` (through
    ``asyncio.run``) and the port's on one steady configuration (seed 7,
    ``bench_serving_load``'s mix, 2 pinned replicas, 3 s of Poisson
    traffic), the JAX init bridged into the port's replicas: the same run
    section, offered count, outcome and token count a request, and the
    same report key tree, goodput 1.0 on both; then the port's chaos run
    (an engine wedged mid-run) with no client-visible failure.

Every wait is bounded: the scripted backend's pauses are short and fixed,
threads are joined with a timeout, and the harness runs end on their own
schedule.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import pytest

from kubeflow_tpu.chaos import plan as j_plan
from kubeflow_tpu.loadgen import arrivals as j_arr
from kubeflow_tpu.loadgen import chaos as j_chaos
from kubeflow_tpu.loadgen import client as j_client
from kubeflow_tpu.loadgen import harness as j_harness
from kubeflow_tpu.loadgen import reporter as j_rep
from kubeflow_tpu.loadgen import workload as j_wl
from kubeflow_tpu.obs import headers as j_headers
from kubeflow_tpu_torch.chaos import plan as t_plan
from kubeflow_tpu_torch.chaos.injectors import CHAOS_INJECTED
from kubeflow_tpu_torch.loadgen import arrivals as t_arr
from kubeflow_tpu_torch.loadgen import chaos as t_chaos
from kubeflow_tpu_torch.loadgen import client as t_client
from kubeflow_tpu_torch.loadgen import harness as t_harness
from kubeflow_tpu_torch.loadgen import reporter as t_rep
from kubeflow_tpu_torch.loadgen import workload as t_wl
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.serve import headers as t_headers

SIDES = {"jax": (j_arr, j_wl, j_rep, j_client, j_chaos, j_plan),
         "torch": (t_arr, t_wl, t_rep, t_client, t_chaos, t_plan)}


def _both(fn):
    """``fn(arrivals, workload, reporter, client, chaos, plan)`` on each
    side: ``{"jax": ..., "torch": ...}``."""
    return {k: fn(*mods) for k, mods in SIDES.items()}


def _bench_mix(wl):
    """``bench_serving_load``'s mix (``bench.py:627-642``)."""
    return wl.WorkloadMix(
        prompt_lens=(6, 10), output_lens=(4, 8),
        tenants=(wl.TenantSpec("interactive", weight=2.0, priority=2,
                               deadline_ms=30_000.0, slo_ms=2_000.0),
                 wl.TenantSpec("batch", weight=1.0, priority=0,
                               adapter="batch-v1", slo_ms=2_000.0)),
        vocab=80, seed=7)


# ============================================================ (a) pure parts


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 12345])
def test_poisson_schedules_match_jax(seed):
    for rate, dur in ((0.5, 10.0), (4.0, 8.0), (50.0, 2.0), (0.0, 5.0)):
        got = _both(lambda a, *_: a.PoissonArrivals(
            rate_rps=rate, duration_s=dur, seed=seed).schedule())
        assert got["torch"] == got["jax"]  # float for float
        assert all(type(x) is float for x in got["torch"])


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 12345])
def test_onoff_schedules_match_jax(seed):
    for kw in (dict(base_rps=1.0, burst_rps=30.0, period_s=4.0, duration_s=8.0),
               dict(base_rps=5.0, burst_rps=80.0, period_s=1.0, duration_s=4.0,
                    on_fraction=0.25),
               dict(base_rps=12.0, burst_rps=2.0, period_s=3.0, duration_s=9.0)):
        procs = _both(lambda a, *_: a.OnOffArrivals(seed=seed, **kw))
        assert procs["torch"].schedule() == procs["jax"].schedule()
        for t in (0.0, 0.3, 1.9, 2.0, 3.99, 7.5):
            assert procs["torch"].rate_at(t) == procs["jax"].rate_at(t)


def _snapshot(seed):
    rng = random.Random(seed)
    traces = []
    for i in range(12):
        spans = [{"name": "route", "attrs": {}}]
        if rng.random() < 0.8:
            attrs = {"prompt_tokens": rng.randrange(1, 64),
                     "max_new_tokens": rng.randrange(0, 32), "model": "lm"}
            if rng.random() < 0.5:
                attrs["priority"] = rng.randrange(0, 3)
            spans.append({"name": "engine", "attrs": attrs})
        traces.append({"trace_id": f"{i:032x}",
                       "wall_time": 1000.0 + rng.uniform(0, 30),
                       "duration_ms": rng.uniform(1, 900), "spans": spans})
    return {"traces": traces}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_arrivals_and_plan_match_jax(seed, tmp_path):
    snap = _snapshot(seed)
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(snap))
    rep = _both(lambda a, *_: a.ReplayArrivals.from_snapshot(snap))
    got = {k: [dataclasses.astuple(r) for r in v.requests] for k, v in rep.items()}
    assert got["torch"] == got["jax"] and got["torch"]
    assert rep["torch"].schedule() == rep["jax"].schedule()
    files = _both(lambda a, *_: a.ReplayArrivals.from_file(str(path)).schedule())
    assert files["torch"] == files["jax"] == rep["jax"].schedule()
    plans = {k: [dataclasses.astuple(s) for s in
                 _bench_mix(SIDES[k][1]).plan_for_replay(rep[k].requests,
                                                         cap_new_tokens=12)]
             for k in SIDES}
    assert plans["torch"] == plans["jax"]


@pytest.mark.parametrize("mix", ["bench", "default", "weighted"])
def test_workload_plans_match_jax(mix):
    def make(wl, seed):
        if mix == "bench":
            return _bench_mix(wl)
        if mix == "default":
            return (j_harness if wl is j_wl else t_harness).default_mix(seed)
        return wl.WorkloadMix(
            prompt_lens=(4, 8, 33), prompt_weights=(1.0, 3.0, 0.5),
            output_lens=(2, 6), output_weights=(2.0, 1.0),
            tenants=(wl.TenantSpec("a", weight=1.0, deadline_ms=1500.0),
                     wl.TenantSpec("b", weight=2.5, priority=1, adapter="lora-x"),
                     wl.TenantSpec("c", weight=0.5, slo_ms=900.0)),
            vocab=40, seed=seed)

    assert t_headers.ADAPTER_HEADER == j_headers.ADAPTER_HEADER
    for seed in (0, 5, 9):
        plans = {k: make(SIDES[k][1], seed).plan(40) for k in SIDES}
        got = {k: [dataclasses.astuple(s) for s in v] for k, v in plans.items()}
        assert got["torch"] == got["jax"]
        adapters = [dict(s.headers).get(t_headers.ADAPTER_HEADER)
                    for s in plans["torch"]]
        if mix != "default" or seed == 0:
            assert any(adapters), "the adapter header rides the plan"
        # a longer plan extends a shorter one
        assert plans["torch"][:9] == make(t_wl, seed).plan(9)


def _prom(requests, b10, b100, binf, model="m"):
    return "\n".join([
        f'kft_gateway_requests_total{{service="m",code="200"}} {requests}',
        f'kft_server_ttft_ms_bucket{{model="{model}",le="10.0"}} {b10}',
        f'kft_server_ttft_ms_bucket{{model="{model}",le="100.0"}} {b100}',
        f'kft_server_ttft_ms_bucket{{model="{model}",le="+Inf"}} {binf}',
        f'kft_server_ttft_ms_count{{model="{model}"}} {binf}',
        f'kft_server_ttft_ms_sum{{model="{model}"}} {binf * 8.0}',
        f'kft_server_tpot_ms_bucket{{model="{model}",le="5.0"}} {b10}',
        f'kft_server_tpot_ms_bucket{{model="{model}",le="+Inf"}} {binf}',
        f'kft_server_tpot_ms_count{{model="{model}"}} {binf}',
        f'kft_server_tpot_ms_sum{{model="{model}"}} {binf * 2.5}',
        f'kft_gateway_stream_resumes_total{{service="m",outcome="ok"}} {b10 % 3}',
        'kft_engine_prefix_hits_total{model="m"} 4',
        'kft_chaos_injected_total{kind="wedge_engine"} 1',
        'kft_autoscaler_kv_transfers_total{service="m"} 2',
        '# HELP ignored comment', 'garbage line {',
    ]) + "\n"


QUANTILE_CASES = {
    "interpolate": (_prom(13, 11, 13, 13), {}),
    "labelled": (_prom(5, 1, 4, 5, model="x") + _prom(9, 2, 8, 9), {"model": "m"}),
    "inf_only": ('h_bucket{le="5.0"} 0\nh_bucket{le="+Inf"} 4\n', {}),
    "empty": ("", {}),
}


@pytest.mark.parametrize("case", sorted(QUANTILE_CASES))
def test_histogram_quantile_matches_jax(case):
    text, match = QUANTILE_CASES[case]
    for name in ("kft_server_ttft_ms", "kft_server_tpot_ms", "h"):
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            got = _both(lambda a, wl, rep, *_: rep.histogram_quantile(
                rep.parse_prom_text(text), name, q, **match))
            assert got["torch"] == got["jax"]


def _results(client, seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        outcome = rng.choice(["completed_in_slo", "completed_in_slo",
                              "completed_late", "shed", "error"])
        out.append(client.RequestResult(
            index=i, tenant=rng.choice(["interactive", "batch"]),
            priority=rng.choice([None, 0, 2]), offset_s=rng.uniform(0, 8),
            outcome=outcome, status=rng.choice([200, 429, 503]),
            ttft_ms=rng.choice([None, rng.uniform(1, 90)]),
            e2e_ms=rng.uniform(5, 3000), tokens=rng.randrange(0, 9),
            slo_ms=rng.choice([None, 2000.0])))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_goodput_and_build_report_match_jax(seed):
    events = [{"t": 90.0, "replicas": 1, "direction": "up"},
              {"t": 101.0, "replicas": 2, "direction": "up"},
              {"t": 103.5, "replicas": 1, "direction": "down"},
              {"t": 104.0, "replicas": 0, "direction": "down"},
              {"t": 106.25, "replicas": 1, "direction": "up"}]
    traces = {"finished": 40, "traces": [{}, {}], "p99_ms": 12.5}

    def report(arr, wl, rep, client, *_):
        results = _results(client, seed)
        return (client.summarize_outcomes(results), rep.goodput(results),
                rep.goodput([]),
                rep.build_report(
                    results=results, run={"bench": "t", "seed": seed},
                    gateway_metrics=_prom(13, 11, 13, 13),
                    replica_metrics=[_prom(13, 11, 13, 13), _prom(2, 1, 2, 2, "x")],
                    baseline_metrics=_prom(3, 3, 3, 3), traces=traces,
                    fleet_events=events, run_t0=100.0, chaos_window=(2.0, 5.0),
                    chaos_faults=["WedgeEngine"], extra={"cold_recovery": {
                        "recovery_s": 1.5, "outcome": "completed_in_slo"}}),
                rep.build_report(results=[], run={"bench": "empty"}))

    got = _both(report)
    assert got["torch"] == got["jax"]
    assert got["torch"][3]["autoscale"]["scale_up_latency_s"] == pytest.approx(1.0)


class _FakeEngine:
    """What the overlay's injectors touch: the fault-hook seam and the
    prefix-cache wipe."""

    def __init__(self, name):
        self.name, self._fault_hooks, self.dropped = name, {}, 0

    def drop_prefix_cache(self):
        self.dropped += 1
        return 3


OVERLAY_PLANS = {
    "wedge": lambda p: (p.WedgeEngine(model="m", hold_s=0.01),),
    "mixed": lambda p: (p.SlowDecode(model="m", delay_s=0.0),
                        p.DropPrefixCache(model="m"),
                        p.DropKVShip(model="m", count=2),
                        p.KillMidStream(model="m", after_tokens=3),
                        p.WedgeEngine(model="other", hold_s=0.01),
                        p.DropPrefixCache(model="m")),
}


@pytest.mark.parametrize("plan", sorted(OVERLAY_PLANS))
@pytest.mark.parametrize("seed", [0, 7, 8])
def test_overlay_victims_and_fired_kinds_match_jax(plan, seed):
    def run(arr, wl, rep, client, chaos, p):
        pool = {"m": [_FakeEngine(f"e{i}") for i in range(5)], "other": []}
        overlay = chaos.ChaosOverlay(
            plan=p.FaultPlan(faults=OVERLAY_PLANS[plan](p), seed=seed),
            at_s=0.0, window_s=2.5)
        fired = chaos.apply_overlay(overlay, pool, t0=time.monotonic())
        if asyncio.iscoroutine(fired):
            fired = asyncio.run(fired)
        touched = [(e.name, sorted(e._fault_hooks), e.dropped) for e in pool["m"]]
        return (fired, touched, overlay.window, overlay.fault_kinds,
                overlay.plan.to_dict())

    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]  # something fired
    with pytest.raises(ValueError, match="not a serving fault"):
        t_chaos.ChaosOverlay(plan=t_plan.FaultPlan(
            faults=(t_plan.Fault(),)), at_s=0.0)
    d = got["torch"][4]
    assert t_plan.FaultPlan.from_dict(d).to_dict() == j_plan.FaultPlan.from_dict(d).to_dict()
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_plan.FaultPlan.from_dict({"faults": [{"kind": "CrashWorker"}]})


# =============================================== (b) the client over the wire


def _chunk(handler, data: bytes) -> None:
    handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
    handler.wfile.flush()


class _Scripted(BaseHTTPRequestHandler):
    """Answers by the request's tenant header; SSE bodies go out in
    chunked encoding, a frame (or half of one) a chunk."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        return

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        mode = self.headers.get("x-kft-tenant", "ok")
        seen = self.server.seen
        seen.append((mode, self.headers.get("x-request-id")))
        if self.path.endswith("/generate"):
            if mode == "shed429":
                return self._plain(429, b"rate limited")
            return self._plain(200, json.dumps({"token_ids": [5, 6, 7]}).encode())
        if mode in ("shed503", "err503", "shed429", "err500"):
            code = {"shed503": 503, "err503": 503, "shed429": 429, "err500": 500}[mode]
            return self._plain(code, b"no", retry=mode == "shed503")
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        frame1 = b'data: {"token_ids": [5, 6]}\n\n'
        _chunk(self, frame1[:9])  # torn across two writes
        time.sleep(0.02)
        _chunk(self, frame1[9:])
        if mode == "late":
            time.sleep(0.08)
        _chunk(self, b": keep-alive comment\n\n")
        _chunk(self, b'data: {"token_ids": [7]}\n\n')
        if mode == "cut":  # the connection dies mid-chunk
            self.wfile.write(b"40\r\ndata: {\"tok")
            self.wfile.flush()
            self.close_connection = True
            return
        if mode == "errframe":
            _chunk(self, b'data: {"error": "engine failed"}\n\n')
        elif mode != "torn":  # torn: EOF with no terminal frame
            _chunk(self, b'data: {"done": true, "n_tokens": 3}\n\n')
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _plain(self, code, body, retry=False):
        self.send_response(code)
        if retry:
            self.send_header("Retry-After", "1")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def scripted():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    srv.daemon_threads = True
    srv.seen = []
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    th.join(10)


CLIENT_MODES = [("ok", 5_000.0), ("late", 50.0), ("shed503", None),
                ("err503", None), ("shed429", None), ("err500", None),
                ("torn", None), ("errframe", None), ("cut", None)]


@pytest.mark.parametrize("stream", [True, False])
def test_load_clients_match_jax_on_a_scripted_backend(scripted, stream):
    base = f"http://127.0.0.1:{scripted.server_address[1]}"

    def run(arr, wl, rep, client, *_):
        specs = tuple(wl.RequestSpec(
            index=i, tenant=mode, prompt_ids=(2, 3, 4), max_new_tokens=4,
            headers=(("x-kft-tenant", mode),), slo_ms=slo, priority=None)
            for i, (mode, slo) in enumerate(CLIENT_MODES))
        c = client.LoadClient(base, "m", stream=stream, request_timeout_s=10.0)
        sched = tuple(0.01 * i for i in range(len(specs)))
        out = c.run(sched, specs)
        if asyncio.iscoroutine(out):
            out = asyncio.run(out)
        return out, rep.goodput(out)

    got = _both(run)
    rows = {k: [(r.index, r.tenant, r.outcome, r.status, r.tokens, r.offset_s,
                 r.ttft_ms is not None, r.error is not None) for r in v[0]]
            for k, v in got.items()}
    assert rows["torch"] == rows["jax"]
    assert got["torch"][1] == got["jax"][1]
    by = {r.tenant: r for r in got["torch"][0]}
    if stream:
        assert [by[m].outcome for m, _ in CLIENT_MODES] == [
            "completed_in_slo", "completed_late", "shed", "error", "shed",
            "error", "error", "error", "error"]
        assert by["ok"].tokens == 3 and by["ok"].ttft_ms >= 15.0
        assert "terminal frame" in by["torn"].error
        assert by["errframe"].error == "engine failed"
    ids = {rid for _, rid in scripted.seen}
    assert ids == {f"loadgen-{i}" for i in range(len(CLIENT_MODES))}
    assert len(got["torch"][0]) == len(CLIENT_MODES)


def test_open_loop_client_fires_on_schedule_not_on_replies(scripted):
    """Request 1 fires at its offset while request 0 is still streaming
    (``late`` holds its stream open): an open-loop client."""
    base = f"http://127.0.0.1:{scripted.server_address[1]}"
    specs = tuple(t_wl.RequestSpec(
        index=i, tenant="late", prompt_ids=(2,), max_new_tokens=2,
        headers=(("x-kft-tenant", "late"),), slo_ms=None, priority=None)
        for i in range(4))
    seen = []
    c = t_client.LoadClient(base, "m", request_timeout_s=10.0, connector_limit=2)
    out = c.run((0.0, 0.01, 0.02, 0.03), specs,
                on_dispatch=lambda i, t: seen.append((i, t)))
    assert [r.outcome for r in out] == ["completed_in_slo"] * 4
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert all(t < 0.09 for _, t in seen)  # before any stream ended
    assert len(c.dispatch_lag_s) == 4 and all(x >= 0 for x in c.dispatch_lag_s)
    # the connector limit of 2 queued the last two behind the first two,
    # and their clocks started before the wait
    assert max(r.e2e_ms for r in out[2:]) > min(r.e2e_ms for r in out[:2])


# ========================================================== (c) the whole slice


def _key_tree(x):
    """The report's keys, nested; every value a leaf (a quantile is None
    until its histogram or the tracer's pool has samples)."""
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_key_tree(v) for v in x]
    return "leaf"


def test_steady_run_matches_jax_harness(monkeypatch):
    """One steady configuration through both harnesses: the same run
    section, offered count, per-request outcomes and token counts, the
    same report key tree, goodput 1.0 on both."""
    kept = {}

    class Recording(j_client.LoadClient):
        async def run(self, schedule, specs, **kw):
            kept["jax"] = await super().run(schedule, specs, **kw)
            return kept["jax"]

    monkeypatch.setattr(j_harness, "LoadClient", Recording)
    jcfg = j_harness.HarnessConfig(
        seed=7, process="poisson", rate_rps=4.0, duration_s=3.0,
        mix=_bench_mix(j_wl), initial_replicas=2, max_replicas=2,
        min_replicas=2)
    jrep = asyncio.run(j_harness.run_serving_load(jcfg))

    # the JAX harness's weights (PRNGKey(0)) bridged into every replica
    from kubeflow_tpu.models.transformer import TransformerConfig as JCfg
    from kubeflow_tpu.models.transformer import TransformerLM

    jtcfg = JCfg(vocab_size=89, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 causal=True, max_seq_len=256, attn_impl="reference",
                 dtype=jnp.float32)
    params = TransformerLM(jtcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    stats = {}
    tcfg = t_harness.HarnessConfig(
        seed=7, process="poisson", rate_rps=4.0, duration_s=3.0,
        mix=_bench_mix(t_wl), initial_replicas=2, max_replicas=2,
        min_replicas=2, state_dict=params_to_state_dict(params), device="cpu")
    trep = t_harness.run_serving_load(tcfg, harness_stats=stats)

    assert trep["run"] == jrep["run"]
    assert trep["run"]["offered_requests"] == len(kept["jax"]) == len(
        stats["results"]) > 0
    per = {k: [(r.index, r.tenant, r.priority, r.offset_s, r.outcome, r.tokens,
                r.slo_ms) for r in v]
           for k, v in (("jax", kept["jax"]), ("torch", stats["results"]))}
    assert per["torch"] == per["jax"]
    assert _key_tree(trep) == _key_tree(jrep)
    for rep in (trep, jrep):
        assert rep["goodput"]["overall"]["goodput"] == 1.0
    assert trep["goodput"] == jrep["goodput"]
    assert trep["server"]["requests_total"] == jrep["server"]["requests_total"]
    assert len(stats["client_lag_ms"]) == len(stats["results"])
    assert stats["scrape_ms"] and all(ms > 0 for ms in stats["scrape_ms"])


def test_chaos_run_has_no_client_visible_failures():
    """An engine wedged mid-run (``WedgeEngine`` through the overlay on a
    timer thread): the wedge fires inside the window, every request
    still completes, none fails where the client sees it."""
    w0 = CHAOS_INJECTED.labels(kind="wedge_engine").value
    cfg = t_harness.HarnessConfig(
        seed=7, process="poisson", rate_rps=4.0, duration_s=4.0,
        mix=_bench_mix(t_wl), initial_replicas=2, max_replicas=2,
        min_replicas=2, device="cpu",
        chaos=t_chaos.ChaosOverlay(
            plan=t_plan.FaultPlan(
                faults=(t_plan.WedgeEngine(model="m", hold_s=1.5),), seed=7),
            at_s=1.0, window_s=2.5))
    rep = t_harness.run_serving_load(cfg)
    chaos = rep["chaos"]
    assert chaos["faults"] == ["WedgeEngine"]
    assert chaos["window_s"] == [1.0, 3.5]
    assert chaos["client_visible_failures"] == 0
    assert rep["goodput"]["overall"]["error"] == 0
    assert chaos["in_window"]["offered"] > 0
    assert CHAOS_INJECTED.labels(kind="wedge_engine").value == w0 + 1
    assert rep["server"]["chaos_injected_total"] >= 1


def test_harness_replicas_default_to_cuda():
    """``device=None`` means CUDA: on a host without a card the first
    replica's launch raises, and the harness tears down what it built."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would run there")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        t_harness.run_serving_load(t_harness.HarnessConfig(duration_s=0.5))
