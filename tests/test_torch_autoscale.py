"""The serving autoscaler in ``kubeflow_tpu_torch`` (``autoscale/``, on
threads and the standard library) against the JAX package's
(``kubeflow_tpu/autoscale``, asyncio and aiohttp), on the CPU.

(a) The pure parts on the same seeded inputs, compared for equality: the
    KPA window and recommender over seeded ``(now, concurrency)`` series
    (panic entry and exit, rate limits, scale-to-zero grace, activator
    kicks), ``KPAConfig`` validation and manifests, ``parse_prom_text``
    and the signal fold over the port's own ``/metrics`` pages, the ring
    owner and ``plan_rebalance`` over seeded indexes and membership
    changes, and ``ServingAutoscaler`` ticks on an injected clock with a
    scripted signal source (the same ``TickResult``s, ``scale_to`` calls,
    view and gauges); the port's tick thread and non-blocking kick.
(b) Both ``GatewaySignalSource``s over the port's gateway in front of CPU
    torch replicas (one holding a stream in flight, one unreachable): the
    same folded signals.
(c) The chaos injectors the load harness fires, on both sides' seams and
    on a CPU torch engine: the wedge (on an Event, released by hand), the
    prefix-cache wipe, the slowed chunk, the dropped KV ship.
(d) The fleet: a scale-up remaps the ring and the new replica pulls the
    prefix entries it now owns, so a remapped prompt hits on it with an
    identical stream (the mirror of ``tests/test_autoscale.py:802``); a
    scale-down leaves the pool first and waits for the streams in flight
    on the leaver, which finish clean; and the port's scale run
    (``min_replicas=0``, on/off bursts) scales up, drains to 0 and serves
    the cold request through the activator.

Every wait is bounded (``Event.wait``, ``join`` with a timeout, polls
with a deadline). Registries are process-global: tests read deltas.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import socket
import threading
import time

import pytest

from kubeflow_tpu.autoscale import autoscaler as j_asc
from kubeflow_tpu.autoscale import kpa as j_kpa
from kubeflow_tpu.autoscale import kv_transfer as j_kv
from kubeflow_tpu.autoscale import signals as j_sig
from kubeflow_tpu.chaos import injectors as j_inj
from kubeflow_tpu.gateway import router as j_rt
from kubeflow_tpu.obs import prom as j_prom
from kubeflow_tpu_torch.autoscale import autoscaler as t_asc
from kubeflow_tpu_torch.autoscale import kpa as t_kpa
from kubeflow_tpu_torch.autoscale import kv_transfer as t_kv
from kubeflow_tpu_torch.autoscale import signals as t_sig
from kubeflow_tpu_torch.autoscale.fleet import ReplicaFleet
from kubeflow_tpu_torch.chaos import injectors as t_inj
from kubeflow_tpu_torch.gateway import GatewayConfig, InferenceGateway, ServiceRoute
from kubeflow_tpu_torch.gateway import router as t_rt
from kubeflow_tpu_torch.gateway.activator import ACTIVATIONS
from kubeflow_tpu_torch.loadgen import harness as t_harness
from kubeflow_tpu_torch.loadgen import workload as t_wl
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.obs import prom as t_prom
from kubeflow_tpu_torch.serve.engine import LMEngineModel, fetch_kv_span
from kubeflow_tpu_torch.serve.model import BucketSpec
from kubeflow_tpu_torch.serve.server import ModelServer

LM = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128)
WAIT_S = 60.0


def _metric(prom, name, **labels):
    m = prom.REGISTRY._metrics.get(name)
    if m is None:
        return 0.0
    child = m._children.get(tuple(sorted(labels.items())))
    return child.value if child else 0.0


def _until(pred, timeout_s=WAIT_S, what="condition"):
    """Poll ``pred`` every 10 ms until it holds; fail after ``timeout_s``."""
    ev = threading.Event()
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        ev.wait(0.01)


def _lm_model(name="m", **kw):
    return LMEngineModel(
        name, config=TransformerConfig(**LM), device="cpu", max_batch=4,
        chunk_steps=2, buckets=BucketSpec(batch_sizes=(1,), seq_lens=(32,)),
        max_new_tokens=4, eos_id=LM["vocab_size"] + 1, watchdog=False,
        prefix_cache_entries=32, **kw)


def _post(url, path, doc, headers=None):
    return t_sig.http_call(f"{url}{path}", body=json.dumps(doc).encode(),
                           headers={"content-type": "application/json",
                                    **(headers or {})}, timeout_s=WAIT_S)


def _predict(url, ids):
    status, body = _post(url, "/v1/models/m:predict",
                         {"instances": [{"input_ids": ids}]})
    assert status == 200, body
    return json.loads(body)["predictions"][0]


def _stream_tokens(port, ids, headers=None):
    status, body = _post(f"http://127.0.0.1:{port}",
                         "/v2/models/m/generate_stream",
                         {"input_ids": ids, "max_new_tokens": 4}, headers)
    frames = [json.loads(line[6:]) for line in body.decode().splitlines()
              if line.startswith("data: ")]
    return status, frames


# ============================================================ (a) pure parts


def test_window_matches_jax():
    ws = {k: m._Window(10.0) for k, m in (("jax", j_kpa), ("torch", t_kpa))}
    rng = random.Random(3)
    t = 0.0
    for _ in range(200):
        t += rng.choice([0.1, 0.5, 2.0, 7.0])
        v = rng.choice([0.0, 1.0, 2.5, 9.0])
        out = {}
        for k, w in ws.items():
            w.observe(t, v)
            out[k] = [w.average(t + d, s) for d in (0.0, 1.0, 12.0)
                      for s in (0.5, 3.0, 10.0)]
        assert out["torch"] == out["jax"]


KPA_CASES = {
    "panic": dict(target=1.0, min_replicas=1, max_replicas=10,
                  stable_window_s=20.0, panic_window_s=2.0, panic_threshold=2.0),
    "rate_limited": dict(target=2.0, min_replicas=1, max_replicas=10,
                         stable_window_s=10.0, panic_window_s=2.0,
                         panic_threshold=10.0, max_scale_up_rate=2.0,
                         max_scale_down_rate=2.0),
    "to_zero": dict(target=1.0, min_replicas=0, max_replicas=4,
                    stable_window_s=10.0, panic_window_s=2.0,
                    scale_to_zero_grace_s=5.0),
    "harness": dict(target=0.3, min_replicas=0, max_replicas=2,
                    stable_window_s=3.0, panic_window_s=0.6, panic_threshold=1.5,
                    max_scale_down_rate=2.0, scale_to_zero_grace_s=1.2),
}


def _kpa_series(mod, cfg, seed):
    """A seeded burst/idle series against one recommender, with the
    actuator following every recommendation and random activator
    kicks: every ``Recommendation`` as a tuple."""
    rng = random.Random(seed)
    rec = mod.KPARecommender(mod.KPAConfig(**cfg), clock=lambda: 0.0)
    t, ready, out = 0.0, 1, []
    for i in range(160):
        t += rng.choice([0.05, 0.15, 0.5, 1.0, 3.0])
        phase = (i // 20) % 4
        conc = (rng.uniform(0, 12) if phase == 1 else
                rng.uniform(0, 2) if phase == 2 else 0.0)
        if rng.random() < 0.05:
            rec.activity(now=t)
        rec.observe(conc, now=t)
        r = rec.recommend(ready, now=t)
        out.append((t, ready, dataclasses.astuple(r), rec.panicking))
        ready = r.desired
    return out


@pytest.mark.parametrize("case", sorted(KPA_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kpa_recommendations_match_jax(case, seed):
    got = {k: _kpa_series(m, KPA_CASES[case], seed)
           for k, m in (("jax", j_kpa), ("torch", t_kpa))}
    assert got["torch"] == got["jax"]
    recs = [r for _, _, r, _ in got["torch"]]
    if case in ("panic", "harness"):
        assert any(r[3] for r in recs) and not recs[-1][3]  # entry and exit
    if case in ("to_zero", "harness"):
        assert any(r[0] == 0 for r in recs) and any(r[0] > 0 for r in recs)


KPA_MANIFESTS = [
    {},
    {"target": 4, "minReplicas": 0, "maxReplicas": 6, "stableWindowS": 30,
     "panicWindowS": 3, "panicThreshold": 1.5, "scaleToZeroGraceS": 10},
    {"minReplicas": 3},
    {"minReplicas": 3, "maxReplicas": 2},
    {"target": 0},
    {"panicWindowS": 70, "stableWindowS": 60},
    {"panicThreshold": 0.5},
    {"maxScaleUpRate": 0.5},
]


@pytest.mark.parametrize("i", range(len(KPA_MANIFESTS)))
def test_kpa_config_manifests_match_jax(i):
    def load(mod):
        try:
            return dataclasses.astuple(mod.KPAConfig.from_manifest(KPA_MANIFESTS[i]))
        except ValueError as e:
            return ("ValueError", str(e))
    assert load(t_kpa) == load(j_kpa)


@pytest.fixture
def replica():
    """One CPU torch replica that has served a stream, a predict and a
    prefix-cache store, so its ``/metrics`` page is populated."""
    ms = ModelServer([_lm_model()], http_port=0).start()
    url = f"http://127.0.0.1:{ms.port}"
    _predict(url, list(range(2, 20)))
    assert _stream_tokens(ms.port, [5, 6, 7])[0] == 200
    yield ms, url
    ms.stop()


def test_parse_prom_text_of_port_pages_matches_jax(replica):
    ms, url = replica
    pages = [t_sig.http_call(f"{url}/metrics", timeout_s=10)[1].decode(),
             t_prom.REGISTRY.expose()]
    for text in pages:
        parsed = {k: m.parse_prom_text(text) for k, m in
                  (("jax", j_sig), ("torch", t_sig))}
        assert parsed["torch"] == parsed["jax"] and parsed["torch"]
        for name in ("kft_server_inflight", "kft_engine_decode_gap_ms",
                     "kubeflow_tpu_requests_total", "kft_gateway_requests_total"):
            for m in (j_sig, t_sig):
                assert m.metric_sum(parsed["torch"], name) == t_sig.metric_sum(
                    parsed["jax"], name)
                assert m.metric_max(parsed["torch"], name, model="m") == \
                    t_sig.metric_max(parsed["jax"], name, model="m")
        sigs = {}
        for k, m in (("jax", j_sig), ("torch", t_sig)):
            s = m.ServiceSignals(activator_depth=2.0)
            m.fold_replica_metrics(s, parsed[k])
            m.fold_replica_metrics(s, parsed[k])
            sigs[k] = (dataclasses.asdict(s), s.concurrency)
        assert sigs["torch"] == sigs["jax"]
    assert "kubeflow_tpu_requests_total" in t_sig.parse_prom_text(pages[0])


def _index(seed, urls, n=60):
    rng = random.Random(seed)
    keys = [tuple(rng.randrange(2, 60) for _ in range(rng.choice([16, 16, 24])))
            for _ in range(n)]
    index = {u: [] for u in urls}
    for k in keys:
        for u in rng.sample(urls, min(len(urls), rng.choice([1, 1, 2]))):
            index[u].append(k)
    return index


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_rebalance_and_owner_match_jax(seed):
    a, b, c, d = (f"http://10.0.0.{i}:8080" for i in range(1, 5))
    cases = [
        (_index(seed, [a, b]), [a, b, c]),         # scale-up
        (_index(seed, [a, b, c]), [a, b]),         # scale-down, c leaves
        (_index(seed, [a, b, c, d]), [a, c]),      # two leave
        (_index(seed, [a]), [a]),                  # nothing moves
        (_index(seed, [a, b]), []),                # no membership
    ]
    for index, urls in cases:
        for tokens in (16, 8):
            plans = {k: [dataclasses.astuple(t) for t in
                         m.plan_rebalance(index, urls, prefix_tokens=tokens)]
                     for k, m in (("jax", j_kv), ("torch", t_kv))}
            assert plans["torch"] == plans["jax"]
        if urls:
            rings = (j_rt.HashRing(tuple(urls)), t_rt.HashRing(tuple(urls)))
            for keys in index.values():
                for k in keys:
                    assert t_kv.owner_of(k, rings[1]) == j_kv.owner_of(k, rings[0])
    index, urls = cases[0]
    ring = t_rt.HashRing(tuple(urls))
    plan = t_kv.plan_rebalance(index, urls)
    assert plan
    for t in plan:  # each key moves to its new owner from a replica holding it
        for k in t.keys:
            assert t_kv.owner_of(k, ring) == t.dest
            assert k in index[t.source] and k not in index.get(t.dest, ())


class _Script:
    """A scripted signal source and actuator for one service; the JAX
    side's are coroutines."""

    def __init__(self, sigmod, script, fail_at=(), refuse_at=()):
        self.sigmod, self.script = sigmod, script
        self.i, self.n, self.calls = 0, 1, []
        self.fail_at, self.refuse_at = fail_at, refuse_at

    def signals(self):
        i, self.i = self.i, self.i + 1
        if i in self.fail_at:
            raise OSError("scrape failed")
        return self.sigmod.ServiceSignals(**self.script[min(i, len(self.script) - 1)])

    def current(self):
        return self.n

    def scale_to(self, n):
        self.calls.append(n)
        if len(self.calls) in self.refuse_at:
            raise RuntimeError("launch failed")
        self.n = n


class _AsyncScript(_Script):
    async def signals(self):  # noqa: D102 — the JAX protocol is async
        return _Script.signals(self)

    async def scale_to(self, n):  # noqa: D102
        _Script.scale_to(self, n)


def test_autoscaler_ticks_match_jax():
    rng = random.Random(5)
    script = []
    for i in range(80):
        phase = (i // 10) % 4
        script.append(dict(
            inflight=rng.uniform(0, 6) if phase == 1 else 0.0,
            queue_depth=rng.choice([0.0, 1.0]) if phase == 1 else 0.0,
            activator_depth=1.0 if phase == 3 and i % 10 < 2 else 0.0,
            decode_gap_ms=rng.uniform(0, 20), replicas_reporting=1))
    cfg = dict(target=1.0, min_replicas=0, max_replicas=5, stable_window_s=4.0,
               panic_window_s=1.0, scale_to_zero_grace_s=2.0)
    times = [0.5 * (i + 1) for i in range(80)]
    out = {}
    for side, asc_mod, kpa_mod, sig_mod, prom, cls in (
            ("jax", j_asc, j_kpa, j_sig, j_prom, _AsyncScript),
            ("torch", t_asc, t_kpa, t_sig, t_prom, _Script)):
        svc = f"svc-{side}"
        clock = [0.0]
        act = cls(sig_mod, script, fail_at=(7,), refuse_at=(2,))
        asc = asc_mod.ServingAutoscaler(clock=lambda: clock[0])
        asc.add_service(svc, kpa_mod.KPAConfig(**cfg), act.signals, act)
        ups0 = _metric(prom, "kft_autoscaler_scale_events_total", service=svc,
                       direction="up")
        ticks = []
        for t in times:
            clock[0] = t
            r = asc.tick(now=t) if side == "torch" else asyncio.run(asc.tick(now=t))
            ticks.append([dataclasses.asdict(x) | {"service": "svc"} for x in r])
            if t == times[40] and side == "torch":
                assert asc.tick_service("nope") is None
        view = asc.view()[svc]
        out[side] = (ticks, act.calls, act.n, view, asc.services() == [svc],
                     _metric(prom, "kft_autoscaler_desired_replicas", service=svc),
                     _metric(prom, "kft_autoscaler_scale_events_total", service=svc,
                             direction="up") - ups0)
    assert out["torch"] == out["jax"]
    ticks, calls = out["torch"][0], out["torch"][1]
    assert [] in ticks  # the failed scrape returned no result
    assert 0 in calls and max(calls) >= 3


def test_autoscaler_thread_and_kick_never_block():
    """``start()`` ticks on its own thread until ``stop()``; ``kick`` from
    another thread returns at once and ticks out of band, even with the
    actuator stalled."""
    release = threading.Event()
    entered = threading.Event()

    class Slow(_Script):
        def scale_to(self, n):
            entered.set()
            release.wait(WAIT_S)
            _Script.scale_to(self, n)

    act = Slow(t_sig, [dict(activator_depth=1.0)])
    act.n = 0
    asc = t_asc.ServingAutoscaler(tick_interval_s=0.05)
    asc.add_service("k", t_kpa.KPAConfig(min_replicas=0, max_replicas=2,
                                         stable_window_s=2.0, panic_window_s=1.0),
                    act.signals, act)
    t0 = time.monotonic()
    asc.kick("k")
    asc.kick("unknown")  # the activator may front services it does not scale
    assert time.monotonic() - t0 < 1.0
    assert entered.wait(WAIT_S)
    asc.start()
    assert asc._thread.is_alive()
    release.set()
    _until(lambda: act.i >= 3, what="interval ticks")
    asc.stop()
    assert asc._thread is None and act.n >= 1 and act.calls[0] >= 1
    n = act.i
    time.sleep(0.2)  # stopped: no tick runs any more
    assert act.i == n


# ===================================================== (b) the signal source


def test_signal_sources_match_jax_over_port_replicas():
    """Both sources over the port's gateway (the JAX one duck-typed onto
    it): a replica holding one stream in flight, an idle one, and one
    that no longer answers — the same folded signals."""
    models = [_lm_model(), _lm_model()]
    servers = [ModelServer([m], http_port=0).start() for m in models]
    with socket.socket() as s:  # a port nothing listens on any more
        s.bind(("127.0.0.1", 0))
        dead_url = f"http://127.0.0.1:{s.getsockname()[1]}"
    urls = [f"http://127.0.0.1:{s.port}" for s in servers] + [dead_url]
    gw = InferenceGateway(GatewayConfig(
        probe_interval_s=60.0, routes=[ServiceRoute(name="m")],
        backends=[("m", u, "default", "both") for u in urls]))
    eng = models[0].engine
    entered, release = threading.Event(), threading.Event()

    def hook(e):
        entered.set()
        release.wait(WAIT_S)
        e._fault_hooks.pop("pre_chunk", None)

    eng._fault_hooks["pre_chunk"] = hook
    held = threading.Thread(target=_stream_tokens, args=(servers[0].port, [4, 5]))
    held.start()
    try:
        assert entered.wait(WAIT_S)
        src = t_sig.GatewaySignalSource(gw, "m", timeout_s=2.0)
        got_t = src()

        async def jax_side():
            js = j_sig.GatewaySignalSource(gw, "m", timeout_s=2.0)
            try:
                return await js()
            finally:
                await js.close()

        got_j = asyncio.run(jax_side())
        assert dataclasses.asdict(got_t) == dataclasses.asdict(got_j)
        assert got_t.replicas_reporting == 2 and got_t.inflight == 1.0
        assert len(src.scrape_ms) == 1 and src.scrape_ms[0] > 0
        src.close()
    finally:
        release.set()
        held.join(WAIT_S)
        for s in servers:
            s.stop()
    assert not held.is_alive()


# ============================================================ (c) injectors


class _Fake:
    def __init__(self):
        self._fault_hooks, self.drops = {}, 0

    def drop_prefix_cache(self):
        self.drops += 1
        return 2


def test_injector_seams_match_jax():
    """Each injector on each side against a stand-in engine: the hook it
    installs, what a fire does, its one-shot rules, what ``stop`` does
    and the ``kft_chaos_injected_total`` tick."""
    def drive(inj, prom):
        out, e = [], _Fake()
        c0 = {k: _metric(prom, "kft_chaos_injected_total", kind=k) for k in (
            "wedge_engine", "drop_prefix_cache", "slow_decode", "drop_kv_ship")}
        release = inj.wedge_engine(e, hold_s=5.0)
        release()  # released before it fires: the stall returns at once
        hook = e._fault_hooks["pre_chunk"]
        hook(e)
        out.append(("wedge", sorted(e._fault_hooks)))
        hook(e)  # one-shot
        out.append(("drop", inj.drop_prefix_cache(e), e.drops))
        stop = inj.slow_decode(e, delay_s=0.0)
        e._fault_hooks["pre_chunk"](e)
        out.append(("slow", sorted(e._fault_hooks)))
        stop()
        out.append(("slow_stopped", sorted(e._fault_hooks)))
        stop = inj.drop_kv_ship(e, count=2)
        errs = []
        for _ in range(3):
            h = e._fault_hooks.get("kv_ship")
            try:
                if h is not None:
                    h(e)
                errs.append(None)
            except OSError as err:
                errs.append(str(err))
        out.append(("ship", errs, sorted(e._fault_hooks)))
        stop()
        out.append({k: _metric(prom, "kft_chaos_injected_total", kind=k) - v
                    for k, v in c0.items()})
        return out

    assert drive(t_inj, t_prom) == drive(j_inj, j_prom)


def test_injectors_on_a_cpu_engine():
    m = _lm_model()
    m.load()
    eng = m.engine
    try:
        prompt = [5, 9, 13, 7] * 5
        want = eng.submit(prompt, max_new_tokens=4)
        assert eng.prefix_cache_stats()["entries"] == 1

        # the wedge: the next chunk stalls until released (an Event)
        w0 = _metric(t_prom, "kft_chaos_injected_total", kind="wedge_engine")
        release = t_inj.wedge_engine(eng, hold_s=WAIT_S)
        box = {}
        th = threading.Thread(target=lambda: box.update(
            out=eng.submit([3, 4, 5], max_new_tokens=4)))
        th.start()
        _until(lambda: _metric(t_prom, "kft_chaos_injected_total",
                               kind="wedge_engine") == w0 + 1, what="the wedge")
        th.join(0.2)
        assert th.is_alive() and "out" not in box  # stalled inside the hook
        release()
        th.join(WAIT_S)
        assert box["out"] == eng.submit([3, 4, 5], max_new_tokens=4)
        assert "pre_chunk" not in eng._fault_hooks  # one-shot

        # the prefix-cache wipe: the next request re-prefills, same tokens
        h0 = eng.prefix_cache_stats()["hits"]
        assert t_inj.drop_prefix_cache(eng) == 1
        assert eng.prefix_cache_stats()["entries"] == 0
        assert eng.prefix_cache_stats()["tokens_stored"] == 0
        assert eng.submit(prompt, max_new_tokens=4) == want
        assert eng.prefix_cache_stats()["hits"] == h0  # a miss, stored again
        assert eng.submit(prompt, max_new_tokens=4) == want
        assert eng.prefix_cache_stats()["hits"] == h0 + 1

        # the slowed chunk: same tokens, the hook gone after stop()
        stop = t_inj.slow_decode(eng, delay_s=0.001)
        assert eng.submit([8, 8, 2], max_new_tokens=4) == eng.submit(
            [8, 8, 2], max_new_tokens=4)
        stop()
        assert "pre_chunk" not in eng._fault_hooks
    finally:
        m.unload()


def test_drop_kv_ship_falls_back_then_ships():
    prefill = ModelServer([_lm_model()], http_port=0, role="prefill").start()
    decode = _lm_model()
    decode.load()
    eng = decode.engine
    peer = f"http://127.0.0.1:{prefill.port}"
    try:
        f0 = eng.stats["kv_ship_fallbacks"]
        t_inj.drop_kv_ship(eng, count=1)
        assert fetch_kv_span(eng, peer, "m", [5, 6, 7], 0.0) is None
        assert eng.stats["kv_ship_fallbacks"] == f0 + 1
        assert "kv_ship" not in eng._fault_hooks  # spent after one
        assert fetch_kv_span(eng, peer, "m", [5, 6, 7], 0.0) is not None
        assert eng.stats["kv_ship_fallbacks"] == f0 + 1
    finally:
        decode.unload()
        prefill.stop()


# ================================================================ (d) fleet


def test_fleet_scale_up_pulls_prefix_kv_and_scale_down_evacuates():
    """After a scale-up remaps the ring, the new replica has already pulled
    the prefix entries it now owns from the previous owner: a remapped
    prompt hits on it with 16 prompt tokens reused and the same tokens."""
    stops = []

    def launch(index):
        ms = ModelServer([_lm_model()], http_port=0).start()
        stops.append(index)
        return f"http://127.0.0.1:{ms.port}", ms.stop

    fleet = ReplicaFleet("m", launch, model="m")
    t0 = _metric(t_prom, "kft_autoscaler_kv_transfers_total", service="m")
    try:
        fleet.scale_to(1)
        (url_a,) = fleet.urls()
        prompts = [[2 + (7 * i + j) % 60 for j in range(17)] for i in range(12)]
        outs_a = [_predict(url_a, p) for p in prompts]
        m_a = t_sig.parse_prom_text(t_sig.http_call(f"{url_a}/metrics",
                                                   timeout_s=10)[1].decode())
        assert t_sig.metric_sum(m_a, "kft_engine_prefix_entries") == 12

        fleet.scale_to(2)
        url_b = next(u for u in fleet.urls() if u != url_a)
        ring = t_rt.HashRing(tuple(sorted((url_a, url_b))))
        owned = [i for i, p in enumerate(prompts)
                 if ring.pick(t_rt.prefix_affinity_key(p[:16])) == url_b]
        assert owned, "no prompt remapped to B"
        assert fleet.stats["kv_entries_moved"] == len(owned)
        assert _metric(t_prom, "kft_autoscaler_kv_transfers_total",
                       service="m") == t0 + len(owned)
        for i in owned:
            assert _predict(url_b, prompts[i]) == outs_a[i]
        m_b = t_sig.parse_prom_text(t_sig.http_call(f"{url_b}/metrics",
                                                   timeout_s=10)[1].decode())
        assert t_sig.metric_sum(m_b, "kft_engine_prefix_imported_total") == len(owned)
        assert t_sig.metric_sum(m_b, "kft_engine_prefix_hits_total") == len(owned)
        assert t_sig.metric_sum(
            m_b, "kft_engine_prefix_tokens_reused_total") == 16 * len(owned)

        fleet.scale_to(1)  # B evacuates its entries to A and stops
        assert fleet.urls() == [url_a] and fleet.stats["stopped"] == 1
        assert [e["direction"] for e in fleet.events] == ["up", "up", "down"]
    finally:
        fleet.close()
    assert fleet.current() == 0 and stops == [0, 1]


def test_fleet_scale_down_waits_for_streams_in_flight():
    """A scale-down takes the leaver out of the pool at once, waits for
    its stream in flight, and stops it only then: the stream finishes
    clean on the replica it started on."""
    servers = {}

    def launch(index):
        ms = ModelServer([_lm_model()], http_port=0).start()
        url = f"http://127.0.0.1:{ms.port}"
        servers[url] = ms
        return url, ms.stop

    gw = InferenceGateway(GatewayConfig(
        probe_interval_s=60.0, routes=[ServiceRoute(name="m")])).start()
    fleet = ReplicaFleet("m", launch, pool=gw.pool, drain_timeout_s=WAIT_S)
    try:
        fleet.scale_to(2)
        url_b = fleet.urls()[1]
        release = threading.Event()
        entered = {}
        for url, ms in servers.items():  # both wedge at their first chunk
            entered[url] = threading.Event()

            def hook(e, ev=entered[url]):
                ev.set()
                release.wait(WAIT_S)
                e._fault_hooks.pop("pre_chunk", None)

            ms.models["m"].engine._fault_hooks["pre_chunk"] = hook
        # two streams: the first holds its replica, so least-outstanding
        # puts the second on the other one
        res = [None, None]
        ths = [threading.Thread(target=lambda i=i: res.__setitem__(
            i, _stream_tokens(gw.http_port, [3 + i, 4, 5]))) for i in range(2)]
        ths[0].start()
        _until(lambda: any(ev.is_set() for ev in entered.values()),
               what="the first stream's chunk")
        ths[1].start()
        assert all(ev.wait(WAIT_S) for ev in entered.values())
        down = threading.Thread(target=fleet.scale_to, args=(1,))
        down.start()
        _until(lambda: gw.pool.find(url_b).state == "draining", what="drain")
        assert all(b.url != url_b for b in gw.pool.selectable("m"))
        down.join(0.3)
        assert down.is_alive() and fleet.stats["stopped"] == 0
        release.set()
        down.join(WAIT_S)
        for t in ths:
            t.join(WAIT_S)
        assert not down.is_alive() and fleet.stats["stopped"] == 1
        for status, frames in res:
            assert status == 200 and frames[-1].get("done")
            assert not any("error" in f for f in frames)
        assert gw.pool.find(url_b) is None
    finally:
        fleet.close()
        gw.stop()


def test_scale_run_scales_up_drains_to_zero_and_serves_cold():
    """The port's scale run: on/off bursts from 1 replica with
    ``min_replicas=0`` scale the fleet to 2; after the window it drains
    to 0, and one cold request parks in the activator, kicks the
    autoscaler and completes (the mirror of
    ``tests/test_autoscale.py:676``)."""
    mix = t_wl.WorkloadMix(
        prompt_lens=(6, 10), output_lens=(4, 8),
        tenants=(t_wl.TenantSpec("interactive", weight=2.0, priority=2,
                                 deadline_ms=30_000.0, slo_ms=2_000.0),
                 t_wl.TenantSpec("batch", weight=1.0, priority=0,
                                 adapter="batch-v1", slo_ms=2_000.0)),
        vocab=80, seed=7)
    cfg = t_harness.HarnessConfig(
        seed=7, process="onoff", rate_rps=1.0, burst_rps=30.0, period_s=4.0,
        duration_s=4.0, mix=mix, initial_replicas=1, max_replicas=2,
        min_replicas=0, kpa_target=0.3, measure_cold_recovery=True,
        device="cpu")
    a0 = ACTIVATIONS.labels(service="m").value
    rep = t_harness.run_serving_load(cfg)
    auto = rep["autoscale"]
    assert auto["replicas_peak"] == 2
    assert auto["scale_up_latency_s"] is not None
    reached = [e["replicas"] for e in auto["events"]]
    assert 0 in reached and reached.index(0) > reached.index(2)
    assert rep["cold_recovery"]["outcome"] == "completed_in_slo"
    assert ACTIVATIONS.labels(service="m").value == a0 + 1
    assert rep["goodput"]["overall"]["error"] == 0
