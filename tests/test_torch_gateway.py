"""The inference gateway in ``kubeflow_tpu_torch`` (``gateway/``, on the
standard library) against the JAX package's (``kubeflow_tpu/gateway``,
aiohttp), on the CPU, in three parts.

(a) The pure parts on the same inputs: the canary split and its slot
    boundaries, the route table, the hash ring's stickiness and motion,
    affinity keys, the breaker under an injected clock, least-outstanding
    selection with rotation, probe ejection and drain, the token bucket and
    tenant policy, the retry budget, SSE frame splitting and
    ``GatewayConfig.from_manifest``; and the port's threaded activator.
(b) Both gateways (the JAX one on an event-loop thread of its own) in
    front of torch ``ModelServer`` replicas: probe ejection and recovery,
    a backend killed mid-burst, a stream killed mid-way and resumed on the
    peer token-identical in f32, and a replica wedged mid-stream that its
    watchdog restarts while the stream resumes elsewhere.
(c) Both gateways on the rest of the reference's gateway cases, each
    case held to one expectation on both sides: their own routes,
    activator overflow and timeout, the cold-start park, tenant rate
    limit, hedging (with a loser slow to answer or slow to accept),
    torn-frame alignment, resume splicing and budget exhaustion, client
    disconnect, shed passthrough, the deadline rewrite, tenant priority,
    the retry's trace and the authoritative headers; and, on the port's
    alone, its own ``/debug/traces``.
(d) The controller feed: both route tables fed by their own
    ``InferenceServiceController`` after the same rollout, and the port's
    gateway fed by the port's controller in front of the service's
    ``ModelServer``, its table refreshed on every probe pass.

Every wait is bounded (``Event.wait``, ``join``, polls with a deadline);
no test sleeps out a deadline. A wedge is the engine's ``pre_chunk``
fault hook blocking on an Event; the watchdog runs on an injected clock.
Tracers and registries are process-global: tests read deltas, and
compare span names, parents and statuses, never ids or times.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import http.client
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from kubeflow_tpu.gateway import activator as j_act
from kubeflow_tpu.gateway import backends as j_be
from kubeflow_tpu.gateway import policy as j_pol
from kubeflow_tpu.gateway import router as j_rt
from kubeflow_tpu.gateway import server as j_srv
from kubeflow_tpu.gateway import sse as j_sse
from kubeflow_tpu.obs import prom as j_prom
from kubeflow_tpu.obs import trace as j_trace
from kubeflow_tpu_torch.chaos.injectors import CHAOS_INJECTED, kill_mid_stream
from kubeflow_tpu_torch.gateway import activator as t_act
from kubeflow_tpu_torch.gateway import backends as t_be
from kubeflow_tpu_torch.gateway import policy as t_pol
from kubeflow_tpu_torch.gateway import router as t_rt
from kubeflow_tpu_torch.gateway import server as t_srv
from kubeflow_tpu_torch.gateway import sse as t_sse
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.obs import prom as t_prom
from kubeflow_tpu_torch.obs import trace as t_trace
from kubeflow_tpu_torch.serve import watchdog as t_wd
from kubeflow_tpu_torch.serve.engine import LMEngineModel
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer

SIDES = {
    "jax": SimpleNamespace(act=j_act, be=j_be, pol=j_pol, rt=j_rt, srv=j_srv,
                           sse=j_sse, prom=j_prom, trace=j_trace),
    "torch": SimpleNamespace(act=t_act, be=t_be, pol=t_pol, rt=t_rt, srv=t_srv,
                             sse=t_sse, prom=t_prom, trace=t_trace),
}
LM_KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128)
MAX_NEW = 8
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _clean_tracers():
    for s in SIDES.values():
        s.trace.TRACER.clear()
        s.trace.TRACER.sample_every = 1
    yield
    for s in SIDES.values():
        s.trace.TRACER.sample_every = 16
        s.trace.TRACER.clear()


def _metric(side, name, **labels):
    m = SIDES[side].prom.REGISTRY._metrics.get(name)
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


# ============================================================ (a) pure parts


@pytest.mark.parametrize("salt", ["kft-canary", "edge", "other-salt"])
@pytest.mark.parametrize("pct", [0, 30, 100])
def test_canary_split_matches_jax(salt, pct):
    ids = [f"req-{i}" for i in range(1000)]
    got = {k: [s.rt.pick_revision(i, pct, salt) for i in ids]
           for k, s in SIDES.items()}
    assert got["torch"] == got["jax"]
    slots = {k: [s.rt.canary_slot(i, salt) for i in ids[:200]]
             for k, s in SIDES.items()}
    assert slots["torch"] == slots["jax"]
    assert all(0.0 <= v < 100.0 for v in slots["torch"])
    frac = 100.0 * sum(p == "canary" for p in got["torch"]) / len(ids)
    assert abs(frac - pct) <= 3.0


ROUTE_QUERIES = [
    ("echo.default:8081", "/v1/models/m:predict"),
    ("echo.default.example.com", "/v1/models/m:predict"),
    (None, "/edge/echo/v1/models/m:predict"),
    (None, "/edge/echo"),
    ("localhost", "/v2/models/lm/infer"),
    ("localhost", "/v2/models/lm/generate_stream"),
    ("localhost", "/v1/models/unknown:predict"),
    ("lm.default", "/anything"),
    ("other", "/edge/echoes/x"),
]


@pytest.mark.parametrize("host,path", ROUTE_QUERIES)
def test_route_table_resolution_matches_jax(host, path):
    got = {}
    for k, s in SIDES.items():
        t = s.rt.RouteTable()
        t.upsert(s.rt.ServiceRoute(name="echo", hosts=("echo.default",),
                                   path_prefixes=("/edge/echo",)))
        t.upsert(s.rt.ServiceRoute(name="lm"))
        r = t.resolve(host, path)
        got[k] = None if r is None else (r[0].name, r[1])
    assert got["torch"] == got["jax"]


def test_hash_ring_matches_jax_sticky_with_minimal_motion():
    urls = tuple(f"http://b{i}" for i in range(4))
    keys = [f"prefix:{i}" for i in range(300)]
    picks = {k: [s.rt.HashRing(urls).pick(x) for x in keys]
             for k, s in SIDES.items()}
    assert picks["torch"] == picks["jax"]
    assert len(set(picks["torch"])) == 4
    ring3 = t_rt.HashRing(urls[:3])
    moved = [x for x, b in zip(keys, picks["torch"])
             if b != "http://b3" and ring3.pick(x) != b]
    assert moved == [] and t_rt.HashRing(()).pick("k") is None


AFFINITY_CASES = {
    "prefix_ids": ("prefix", 4, {}, {"instances": [{"ids": [1, 2, 3, 4, 9]}]}),
    "prefix_same": ("prefix", 4, {}, {"instances": [{"ids": [1, 2, 3, 4, 77]}]}),
    "prefix_input_ids": ("prefix", 4, {}, {"input_ids": ["3", 4.0, 5]}),
    "prefix_text": ("prefix", 4, {}, {"instances": [{"prompt": "hello world"}]}),
    "prefix_bare_row": ("prefix", 16, {}, {"instances": [[5, 6, 7]]}),
    "prefix_session_wins": ("prefix", 4, {"x-session-id": "s1"},
                            {"instances": [[1, 2]]}),
    "prefix_nothing": ("prefix", 4, {}, {"instances": [{"other": 1}]}),
    "session": ("session", 16, {"x-session-id": "s9"}, {"instances": [[1]]}),
    "session_missing": ("session", 16, {}, {"instances": [[1]]}),
    "none": ("none", 16, {"x-session-id": "s9"}, {"instances": [[1]]}),
}


@pytest.mark.parametrize("case", sorted(AFFINITY_CASES))
def test_affinity_keys_match_jax(case):
    affinity, n, headers, body = AFFINITY_CASES[case]
    got = {k: s.rt.affinity_key_of(
        s.rt.ServiceRoute(name="lm", affinity=affinity, affinity_prefix_tokens=n),
        headers, body) for k, s in SIDES.items()}
    assert got["torch"] == got["jax"]


def test_breaker_open_half_open_close_matches_jax():
    seq = {}
    for k, s in SIDES.items():
        clk = [0.0]
        br = s.be.CircuitBreaker(s.be.BreakerConfig(failure_threshold=2,
                                                    recovery_s=5.0),
                                 clock=lambda: clk[0])
        out = [br.allow(), br.record_failure(), br.record_failure(), br.state,
               br.allow()]
        clk[0] = 5.1
        out += [br.allow(), br.allow(), br.current_state()]
        br.record_success()
        out += [br.state, br.allow(), br.record_failure(), br.record_failure()]
        clk[0] = 11.0
        out += [br.allow(), br.record_failure(), br.state]
        seq[k] = out
    assert seq["torch"] == seq["jax"]
    assert seq["torch"][:5] == [True, False, True, "open", False]


def _pool_run(s):
    pool = s.be.BackendPool()
    b1 = pool.add("svc", "http://a")
    b2 = pool.add("svc", "http://b")
    pool.add("svc", "http://c", revision="canary")
    pool.add("svc", "http://p", role="prefill")
    out = []
    b1.outstanding = 2
    out.append(pool.pick("svc", "default").url)
    b2.outstanding = 2
    out += [pool.pick("svc", "default").url for _ in range(4)]
    out.append(pool.pick("svc", "canary").url)
    out.append(pool.pick_prefill("svc").url)
    out.append(pool.pick("svc", None, exclude=b1).url)
    out.append([b.url for b in pool.selectable("svc")])
    return out


def test_pool_least_outstanding_rotation_and_roles_match_jax():
    got = {k: _pool_run(s) for k, s in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert set(got["torch"][1:5]) == {"http://a", "http://b"}


def test_pool_breaker_drives_selection_and_half_open_trial():
    seq = {}
    for k, s in SIDES.items():
        clk = [0.0]
        pool = s.be.BackendPool(breaker=s.be.BreakerConfig(failure_threshold=1,
                                                           recovery_s=2.0),
                                clock=lambda: clk[0])
        b1 = pool.add("svc", "http://ta")
        b2 = pool.add("svc", "http://tb")
        opens0 = _metric(k, "kft_gateway_breaker_opens_total", backend="http://ta")
        pool.record(b1, ok=False)
        out = [_metric(k, "kft_gateway_breaker_opens_total",
                       backend="http://ta") - opens0,
               _metric(k, "kft_gateway_breaker_open", backend="http://ta"),
               [pool.pick("svc").url for _ in range(3)]]
        pool.record(b2, ok=False)
        out.append(pool.pick("svc"))
        clk[0] = 2.5
        trial = pool.pick("svc")
        pool.record(trial, ok=True)
        out += [trial.url, trial.breaker.state,
                _metric(k, "kft_gateway_breaker_open", backend=trial.url)]
        seq[k] = out
    assert seq["torch"] == seq["jax"]
    assert seq["torch"][:2] == [1, 1] and seq["torch"][3] is None


def test_pool_probe_ejection_recovery_and_drain_match_jax():
    got = {}
    for k, s in SIDES.items():
        events = []
        pool = s.be.BackendPool(eject_threshold=2, on_ready=events.append)
        b = pool.add("svc", "http://a")
        out = []
        pool.observe_probe(b, False)
        out.append(b.probe_ok)
        pool.observe_probe(b, False)
        out += [b.probe_ok, pool.selectable("svc")]
        pool.observe_probe(b, True)
        out += [b.probe_ok, pool.ready_count("svc"), events.count("svc")]
        pool.acquire(b)
        pool.drain("http://a")
        out += [pool.selectable("svc"), len(pool.backends_of("svc"))]
        pool.release(b)
        out.append(pool.backends_of("svc"))
        got[k] = out
    assert got["torch"] == got["jax"]
    assert got["torch"] == [True, False, [], True, 1, 2, [], 1, []]


def test_token_bucket_and_policy_from_profiles_match_jax():
    profiles = SimpleNamespace(list=lambda: [
        SimpleNamespace(name="team-a", quota=SimpleNamespace(
            max_rps=2.0, burst=2, max_concurrent_requests=1, priority=5)),
        SimpleNamespace(name="team-b", quota=SimpleNamespace(max_chips=8)),
    ])
    got = {}
    for k, s in SIDES.items():
        clk = [0.0]
        tb = s.pol.TokenBucket(2.0, 2, clock=lambda: clk[0])
        out = [tb.allow(), tb.allow(), tb.allow()]
        clk[0] = 0.5
        out += [tb.allow(), tb.allow()]
        eng = s.pol.PolicyEngine.from_profiles(profiles, clock=lambda: clk[0])

        def outcome(fn):
            try:
                fn()
                return "ok"
            except Exception as e:  # noqa: BLE001 — the class is compared
                return type(e).__name__

        out.append(outcome(lambda: eng.acquire("team-a")))
        out.append(outcome(lambda: eng.acquire("team-a")))  # cap: no token burnt
        eng.release("team-a")
        out.append(outcome(lambda: eng.acquire("team-a")))
        eng.release("team-a")
        out.append(outcome(lambda: eng.acquire("team-a")))  # burst drained
        out += [outcome(lambda: eng.acquire("team-b")),
                outcome(lambda: eng.acquire("unknown")),
                eng.priority_of("team-a"), eng.priority_of("team-b"),
                eng.view()]
        got[k] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][5:9] == ["ok", "TooManyInFlight", "ok", "RateLimited"]
    with pytest.raises(ValueError):
        t_pol.TokenBucket(0.0)


@pytest.mark.parametrize("ratio,floor,requests", [
    (0.5, 2, 4), (0.2, 3, 10), (0.0, 0, 5), (1.0, 1, 3)])
def test_retry_budget_matches_jax(ratio, floor, requests):
    got = {}
    for k, s in SIDES.items():
        rb = s.pol.RetryBudget(ratio=ratio, floor=floor)
        out = [rb.try_spend() for _ in range(floor + 1)]
        for _ in range(requests):
            rb.on_request()
        out += [rb.try_spend() for _ in range(requests + 1)]
        got[k] = (out, rb.retries)
    assert got["torch"] == got["jax"]


SSE_STREAM = (b'data: {"token_ids": [1]}\n\n: comment\n\ndata: {"token_ids": [2, 3]}'
              b'\n\ndata: {"done": true, "n_tokens": 3}\n\ndata: {"token_')


@pytest.mark.parametrize("step", [1, 3, 7, 16, 64, len(SSE_STREAM)])
def test_sse_frame_splitting_matches_jax(step):
    got = {}
    for k, s in SIDES.items():
        split = s.sse.SSEFrameSplitter()
        frames = []
        for i in range(0, len(SSE_STREAM), step):
            frames += split.feed(SSE_STREAM[i:i + step])
        got[k] = (frames, split.pending, [s.sse.sse_payload(f) for f in frames])
    assert got["torch"] == got["jax"]
    frames, pending, payloads = got["torch"]
    assert len(frames) == 4 and pending == b'data: {"token_'
    assert payloads[1] is None and payloads[2] == {"token_ids": [2, 3]}


@pytest.mark.parametrize("frame", [
    b'data: {"a": 1}', b"data:[1, 2]", b"data: not json", b": keepalive",
    b'event: x\ndata: {"a": 1}', b"data:"])
def test_sse_payload_matches_jax(frame):
    assert t_sse.sse_payload(frame) == j_sse.sse_payload(frame)


MANIFEST = {
    "kind": "InferenceGateway",
    "metadata": {"name": "edge"},
    "spec": {
        "salt": "s1", "failureThreshold": 2, "queueLimit": 7,
        "upstreamTimeoutS": 30, "streamResume": False,
        "services": [{
            "name": "lm", "hosts": ["lm.default"], "canaryPercent": 25,
            "affinity": "prefix", "hedgeMs": 15, "maxAttempts": 4,
            "backends": [
                "http://127.0.0.1:9001",
                {"url": "http://127.0.0.1:9002", "revision": "canary"},
                {"url": "http://127.0.0.1:9003", "role": "prefill"},
            ],
            "autoscaling": {"minReplicas": 1, "replicaCommand": ["serve"]},
        }],
        "policy": {"tenants": {"team-a": {"maxRps": 5, "burst": 10,
                                          "maxInFlight": 3, "priority": 2}}},
    },
}


def test_gateway_config_from_manifest_matches_jax():
    got = {}
    for k, s in SIDES.items():
        cfg = s.srv.GatewayConfig.from_manifest(MANIFEST)
        d = dataclasses.asdict(cfg)
        d["routes"] = [dataclasses.asdict(r) for r in cfg.routes]
        got[k] = d
    assert got["torch"] == got["jax"]
    cfg = t_srv.GatewayConfig.from_manifest(MANIFEST)
    assert cfg.backends[2] == ("lm", "http://127.0.0.1:9003", "default", "prefill")
    assert cfg.autoscaling["lm"]["minReplicas"] == 1 and not cfg.stream_resume
    for bad in ({"kind": "Deployment"},
                {"spec": {"services": [{"name": "x", "autoscaling": {
                    "replicaCommand": "serve --port 1"}}]}}):
        for s in SIDES.values():
            with pytest.raises(ValueError):
                s.srv.GatewayConfig.from_manifest(bad)


def test_activator_flushes_in_admission_order_and_kicks_once():
    kicks = []
    act = t_act.Activator(queue_limit=8, timeout_s=WAIT_S, scale_up=kicks.append)
    tracer = t_trace.Tracer(sample_every=1)
    spans = [tracer.span("activator.park") for _ in range(4)]
    threads = []
    for i in range(4):
        t = threading.Thread(target=act.wait, args=("svc",),
                             kwargs={"span": spans[i]})
        t.start()
        _until(lambda: act.depth("svc") == i + 1, what="a parked waiter")
        threads.append(t)
    assert kicks == ["svc"]  # one kick for the cold episode, not per request
    act.notify("svc")
    for t in threads:
        t.join(WAIT_S)
    assert act.depth("svc") == 0
    # each waiter's "activated" event is stamped as it leaves, under the
    # activator's lock: they left in admission order
    stamps = [next(ts for n, ts, _ in s.events if n == "activated") for s in spans]
    assert stamps == sorted(stamps)
    assert [s.attrs["parked_depth"] for s in spans] == [1, 2, 3, 4]
    # the next cold episode kicks again
    t = threading.Thread(target=act.wait, args=("svc",))
    t.start()
    _until(lambda: act.depth("svc") == 1, what="a parked waiter")
    assert kicks == ["svc", "svc"]
    act.notify("svc")
    t.join(WAIT_S)
    assert act.view() == {"queue_depth": {}, "pending_scale_ups": []}


def test_activator_overflow_and_timeout_envelopes():
    act = t_act.Activator(queue_limit=1, timeout_s=WAIT_S)
    out = {}

    def first():
        try:
            act.wait("svc", timeout_s=0.2)
        except t_act.ActivationTimeout as e:
            out["first"] = e

    t = threading.Thread(target=first)
    t.start()
    _until(lambda: act.depth("svc") == 1, what="a parked waiter")
    with pytest.raises(t_act.QueueOverflow):  # bounded FIFO → the 429 path
        act.wait("svc")
    t.join(WAIT_S)
    assert isinstance(out.get("first"), t_act.ActivationTimeout)  # → the 503
    assert act.depth("svc") == 0  # the expired waiter left no residue


# ======================================================= replicas and gateways


class _Tagged(Model):
    """Answers with its replica's tag, so a test sees WHICH replica did."""

    def __init__(self, tag, name="m"):
        super().__init__(name)
        self.tag = tag
        self.ready = True

    def predict(self, inputs, headers=None):
        return {"predictions": [self.tag for _ in inputs["instances"]]}


def _lm(name="m", **kw):
    """A tiny f32 engine replica; every one has the same weights (seed 0)."""
    return LMEngineModel(
        name, config=TransformerConfig(**LM_KW), device="cpu", seed=0,
        max_new_tokens=MAX_NEW, prefill_buckets=(16,), max_batch=2,
        chunk_steps=2, eos_id=97, watchdog=False, kv_pool_tokens=256,
        page_size=16, **kw)


class _JaxGateway:
    """The JAX gateway on an ephemeral port, its loop on its own thread."""

    def __init__(self, config, **kw):
        self.gw = j_srv.InferenceGateway(config, **kw)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.gw.start_async(), self.loop).result(60)
        self.port = self.gw.http_port

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(self.gw.stop_async(), self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


class _PortGateway:
    def __init__(self, config, **kw):
        self.gw = t_srv.InferenceGateway(config, **kw).start()
        self.port = self.gw.http_port

    def close(self):
        self.gw.stop()


def _gateway(side, backends, routes=(), *, policy=None, scale_up=None, **cfg):
    """``side``'s gateway for service ``m`` in front of ``backends``: urls,
    or (url, role) pairs."""
    s = SIDES[side]
    entries = [(b, "both") if isinstance(b, str) else b for b in backends]
    config = s.srv.GatewayConfig(
        routes=[s.rt.ServiceRoute(**r) for r in routes],
        backends=[("m", url, "default", role) for url, role in entries],
        **{"probe_interval_s": 30.0, **cfg})
    return (_JaxGateway if side == "jax" else _PortGateway)(
        config, policy=policy, scale_up=scale_up)


def _call(port, method, path, body=None, headers=None, timeout=WAIT_S):
    """``(status, headers, body text)`` over ``http.client``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def _frames(port, body=None, headers=None, path="/v2/models/m/generate_stream"):
    status, _, text = _call(port, "POST", path, body or {"input_ids": [3, 4, 5]},
                            headers)
    assert status == 200, text
    return [json.loads(line[6:]) for line in text.splitlines()
            if line.startswith("data: ")]


def _tokens(frames):
    return [t for f in frames for t in f.get("token_ids", [])]


class _Fleet:
    """Torch replicas, each behind its own ``ModelServer``."""

    def __init__(self, models, **server_kw):
        self.models = models
        self.servers = [ModelServer([m], http_port=0, **server_kw).start()
                        for m in models]
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.servers]

    def close(self):
        for s in self.servers:
            if s._httpd is not None:
                s.stop()
            else:  # killed: unload what it served
                for m in s.models.values():
                    m.unload()


# ============================================== (b) and (c): both gateways


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_probe_ejection_and_recovery_behind_the_gateway(side):
    fleet = _Fleet([_Tagged("a"), _Tagged("b")])
    gw = _gateway(side, fleet.urls, probe_interval_s=0.05, probe_timeout_s=2.0,
                  eject_threshold=2)
    try:
        pool = gw.gw.pool
        b_a = pool.find(fleet.urls[0])
        fleet.models[0].ready = False  # /v2/health/ready answers ready: false
        _until(lambda: not b_a.probe_ok, what="the probe ejection")
        tags = {json.loads(_call(gw.port, "POST", "/v1/models/m:predict",
                                 {"instances": [[1]]})[2])["predictions"][0]
                for _ in range(6)}
        assert tags == {"b"}  # the ejected replica gets no traffic
        fleet.models[0].ready = True
        _until(lambda: b_a.probe_ok, what="the probe recovery")
        tags = {json.loads(_call(gw.port, "POST", "/v1/models/m:predict",
                                 {"instances": [[1]]})[2])["predictions"][0]
                for _ in range(6)}
        assert tags == {"a", "b"}
    finally:
        gw.close()
        fleet.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_backend_killed_mid_burst_is_invisible_to_clients(side):
    fleet = _Fleet([_Tagged("a"), _Tagged("b")])
    gw = _gateway(side, fleet.urls, failure_threshold=2, recovery_s=60.0,
                  retry_budget_floor=50)
    try:
        for _ in range(4):  # both replicas serve
            assert _call(gw.port, "POST", "/v1/models/m:predict",
                         {"instances": [[1]]})[0] == 200
        retries0 = _metric(side, "kft_gateway_retries_total", service="m")
        fleet.servers[1].kill()  # replica b dies with the burst coming
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(lambda i: _call(
                gw.port, "POST", "/v1/models/m:predict", {"instances": [[i]]}),
                range(20)))
        assert [r[0] for r in results] == [200] * 20, results
        assert all(json.loads(r[2])["predictions"] == ["a"] for r in results)
        assert _metric(side, "kft_gateway_retries_total", service="m") > retries0
        assert _metric(side, "kft_gateway_breaker_open", backend=fleet.urls[1]) == 1
    finally:
        gw.close()
        fleet.close()


def _trace_with(tracer, name, timeout_s=WAIT_S):
    """The retained trace holding a span called ``name``: its spans
    as (name, parent's name, status)."""
    box = {}

    def find():
        for t in tracer.snapshot(limit=64)["traces"]:
            if any(s["name"] == name for s in t["spans"]):
                ids = {s["span_id"]: s["name"] for s in t["spans"]}
                box["t"] = t
                box["rows"] = [(s["name"], ids.get(s["parent_span_id"]),
                                s["status"]) for s in t["spans"]]
                return True
        return False

    _until(find, timeout_s, what=f"a trace with {name}")
    return box["t"], box["rows"]


@pytest.mark.parametrize("action", ["kill", "poison"])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_mid_stream_kill_resumes_on_the_peer_token_identical(side, action):
    """The replica serving a stream dies after committing tokens (its
    server killed, or its engine poisoned as a dying watchdog would): the
    gateway resumes the stream on the peer with the committed prefix, and
    the client reads the uninterrupted f32 stream with no error frame."""
    fleet = _Fleet([_lm(), _lm()])
    route = dict(name="m", affinity="session", max_attempts=4)
    gw = _gateway(side, fleet.urls, [route], failure_threshold=2,
                  recovery_s=60.0, retry_budget_floor=100)
    hdrs = {"x-session-id": "chaos-s1"}
    try:
        base = _frames(gw.port, headers={**hdrs, "x-request-id": "base-run"})
        assert all("error" not in f for f in base)
        base_toks = _tokens(base)
        assert base[-1] == {"done": True, "n_tokens": MAX_NEW}
        s = SIDES[side]
        victim_b = gw.gw._affine_pick(s.rt.ServiceRoute(**route), "default",
                                      "session:chaos-s1")
        vi = fleet.urls.index(victim_b.url)
        victim, peer = fleet.models[vi], fleet.models[1 - vi]
        inj0 = CHAOS_INJECTED.labels(kind="kill_mid_stream").value
        ok0 = _metric(side, "kft_gateway_stream_resumes_total", service="m",
                      outcome="ok")
        admits0 = peer.engine.stats["resume_admits"]
        if action == "kill":
            act = lambda eng: fleet.servers[vi].kill()  # noqa: E731
        else:
            act = lambda eng: eng.poison(  # noqa: E731
                t_wd.EngineRestarting("chaos: replica killed mid-stream"))
        kill_mid_stream(victim.engine, after_tokens=2, action=act)
        frames = _frames(gw.port, headers={**hdrs, "x-request-id": "failover"})
        assert all("error" not in f for f in frames), frames
        assert _tokens(frames) == base_toks
        assert frames[-1] == {"done": True, "n_tokens": len(base_toks)}
        assert CHAOS_INJECTED.labels(kind="kill_mid_stream").value == inj0 + 1
        assert _metric(side, "kft_gateway_stream_resumes_total", service="m",
                       outcome="ok") == ok0 + 1
        assert peer.engine.stats["resume_admits"] == admits0 + 1
        # one trace id holds the failed proxy span AND the stream.resume
        # span that continued the request
        tr, rows = _trace_with(s.trace.TRACER, "stream.resume")
        assert tr["kept"] == "error"
        assert ("proxy", "route", "error") in rows
        assert ("stream.resume", "route", "ok") in rows
        assert any(ev["name"] == "mid_stream_failure"
                   for sp in tr["spans"] if sp["name"] == "proxy"
                   for ev in sp["events"])
        # the replicas' spans join the gateway's trace (behind the JAX
        # gateway, in the port's tracer under the same trace id)
        need = {("dataplane.stream", "stream.resume", "ok"),
                ("engine", "dataplane.stream", "ok"),
                ("queue.wait", "engine", "ok"), ("prefill", "engine", "ok"),
                ("decode.chunk", "engine", "ok")}
        if action == "poison":  # the victim's engine span says why
            need.add(("engine", "dataplane.stream", "poisoned"))
        _tree(tr["trace_id"], need)
    finally:
        gw.close()
        fleet.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_wedged_replica_watchdog_restart_and_stream_resume(side):
    """A replica wedged mid-stream (its scheduler blocked in the
    ``pre_chunk`` hook) is tripped by its watchdog on an injected clock;
    the poisoned stream resumes on the peer, token-identical, while the
    watchdog rebuilds the engine and readiness comes back."""
    fleet = _Fleet([_lm(), _lm()])
    route = dict(name="m", affinity="session", max_attempts=4)
    gw = _gateway(side, fleet.urls, [route], failure_threshold=2,
                  recovery_s=60.0, retry_budget_floor=100)
    hdrs = {"x-session-id": "wedge-s1"}
    release = threading.Event()
    try:
        base_toks = _tokens(_frames(gw.port, headers=hdrs))
        victim_b = gw.gw._affine_pick(SIDES[side].rt.ServiceRoute(**route),
                                      "default", "session:wedge-s1")
        victim = fleet.models[fleet.urls.index(victim_b.url)]
        now = [0.0]
        wd = t_wd.EngineWatchdog(
            lambda: victim.engine, victim.restart_engine,
            on_ready=victim._set_ready,
            config=t_wd.WatchdogConfig(min_wedge_s=5.0),
            clock=lambda: now[0], model_name=f"gw-wedge-{side}")
        entered = threading.Event()

        def wedge(eng):  # one-shot, once a row has committed tokens
            if not any(r is not None and len(r.tokens) >= 2 for r in eng._slots):
                return
            eng._fault_hooks.pop("pre_chunk", None)
            entered.set()
            release.wait(WAIT_S)

        old = victim.engine
        old._fault_hooks["pre_chunk"] = wedge
        out = {}
        client = threading.Thread(target=lambda: out.setdefault(
            "frames", _frames(gw.port, headers=hdrs)))
        client.start()
        assert entered.wait(WAIT_S)
        now[0] = old.heartbeat() + 10.0
        assert wd.tick() == "wedged"
        client.join(WAIT_S)
        frames = out["frames"]
        assert all("error" not in f for f in frames), frames
        assert _tokens(frames) == base_toks
        assert frames[-1]["n_tokens"] == len(base_toks)
        assert victim.ready and victim.engine is not old
        assert wd.stats == {"trips": {"wedged": 1}, "restarts": 1}
        assert victim.engine.submit([5, 6], max_new_tokens=3)  # the new one serves
    finally:
        release.set()
        gw.close()
        fleet.close()


# ============================= (c) both gateways on the reference's cases
#
# Each case drives the JAX gateway and the port's in front of the same
# backends (scripted stdlib servers, ``_Raw``, or torch replicas,
# ``_Fleet``) with the same requests, and holds both to one expectation:
# the same statuses, frames, span rows (name, parent's name, status) and
# metric deltas. Behind the JAX gateway a torch replica's spans are in the
# port's tracer under the JAX gateway's trace id; ``_tree`` joins the two
# tracers by trace id, so both sides give one tree.


class _Raw:
    """A scripted stdlib backend: ``routes[(method, path)](handler, body)``
    writes the whole answer; readiness answers ready."""

    def __init__(self, routes):
        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                return

            def _go(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if self.path == "/v2/health/ready":
                    return _send(self, 200, {"ready": True})
                fn = routes.get((self.command, self.path))
                if fn is None:
                    return _send(self, 404, {"error": "no route"})
                fn(self, body)

            do_GET = do_POST = _go

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _Unaccepting:
    """A backend whose listen queue is full: a connect to it waits until
    its timeout (the kernel drops the SYN), as to a host that is slow to
    accept."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(0)
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        # one connection fills a backlog of 0; it is never accepted
        self.filler = socket.create_connection(self.sock.getsockname(), timeout=5)

    def close(self):
        self.filler.close()
        self.sock.close()


def _send(h, status, doc, headers=None):
    data = json.dumps(doc).encode()
    h.send_response(status)
    h.send_header("Content-Type", "application/json")
    h.send_header("Content-Length", str(len(data)))
    for k, v in (headers or {}).items():
        h.send_header(k, v)
    h.end_headers()
    h.wfile.write(data)


def _sse_start(h):
    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Transfer-Encoding", "chunked")
    h.end_headers()


def _sse_chunk(h, data: bytes):
    h.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
    h.wfile.flush()


def _die(h):
    """The process "died": the socket closes with no terminal chunk."""
    h.close_connection = True
    h.connection.shutdown(2)


def _spans_of(trace_id):
    """Every retained span of ``trace_id`` in both process-global tracers.
    The retention pools are read whole: ``snapshot`` serves one record a
    trace id, and behind the JAX gateway each replica a stream crossed
    finishes its own record of the trace in the port's tracer."""
    spans = {}
    for tracer in (j_trace.TRACER, t_trace.TRACER):
        with tracer._lock:
            docs = [*tracer._errors, *tracer._slow, *tracer._sampled]
        for t in docs:
            if t["trace_id"] == trace_id:
                spans.update((s["span_id"], s) for s in t["spans"])
    return list(spans.values())


def _tree(trace_id, need=()):
    """``trace_id``'s spans as sorted (name, parent's name, status) rows,
    once every row in ``need`` is retained."""
    box = {}

    def have():
        spans = _spans_of(trace_id)
        names = {s["span_id"]: s["name"] for s in spans}
        box["rows"] = sorted((s["name"], names.get(s["parent_span_id"]), s["status"])
                             for s in spans)
        return set(need) <= set(box["rows"])

    try:
        _until(have, what=f"spans {sorted(need)} of trace {trace_id}")
    except AssertionError as e:
        raise AssertionError(f"{e}; retained: {box['rows']}") from None
    return box["rows"]


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_serves_its_own_routes(side):
    fleet = _Fleet([_Tagged("a")])
    gw = _gateway(side, fleet.urls, [dict(name="m", canary_percent=10.0)])
    try:
        assert _call(gw.port, "POST", "/v1/models/m:predict",
                     {"instances": [[1]]})[0] == 200
        status, _, text = _call(gw.port, "GET", "/gateway/healthz")
        assert status == 200 and json.loads(text) == {"ok": True, "name": "gateway"}
        state = json.loads(_call(gw.port, "GET", "/gateway/state")[2])
        assert sorted(state) == ["activator", "name", "policy", "services"]
        (svc,) = state["services"]
        assert svc["name"] == "m" and svc["canary_percent"] == 10.0
        assert svc["ready_backends"] == 1 and svc["queue_depth"] == 0
        assert [b["url"] for b in svc["backends"]] == fleet.urls
        text = _call(gw.port, "GET", "/metrics")[2]
        assert 'kft_gateway_requests_total{code="200",service="m"}' in text
        assert _call(gw.port, "POST", "/v1/models/zzz:predict", {})[0] == 404
    finally:
        gw.close()
        fleet.close()


def test_port_gateway_refuses_a_controller_and_serves_its_traces():
    """Port only: the gateway takes a controller now (its table is fed at
    construction; ``test_gateway_fed_by_the_port_controller`` drives it),
    and the port's gateway answers ``GET /debug/traces`` itself (the
    reference's proxies it like any path; its traces are read in process)."""
    from kubeflow_tpu_torch.serve.controller import InferenceServiceController
    from kubeflow_tpu_torch.serve.spec import RuntimeRegistry

    empty = t_srv.InferenceGateway(controller=InferenceServiceController(
        RuntimeRegistry()))
    assert empty.table.routes() == []
    fleet = _Fleet([_Tagged("a")])
    gw = _gateway("torch", fleet.urls)
    try:
        assert _call(gw.port, "POST", "/v1/models/m:predict",
                     {"instances": [[1]]})[0] == 200
        snap = json.loads(_call(gw.port, "GET", "/debug/traces?limit=4")[2])
        assert any(s["name"] == "route" for t in snap["traces"] for s in t["spans"])
    finally:
        gw.close()
        fleet.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_activator_queue_full_429_and_timeout_503(side):
    gw = _gateway(side, [], [dict(name="m")], queue_limit=1,
                  activation_timeout_s=0.2)
    try:
        sheds0 = {r: _metric(side, "kft_gateway_shed_total", service="m", reason=r)
                  for r in ("queue_full", "activation_timeout")}
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("r1", _call(
            gw.port, "POST", "/v1/models/m:predict", {"instances": [[1]]})))
        t.start()
        _until(lambda: gw.gw.activator.depth("m") == 1, what="a parked request")
        status, headers, _ = _call(gw.port, "POST", "/v1/models/m:predict",
                                   {"instances": [[2]]})
        assert (status, headers.get("Retry-After")) == (429, None)  # FIFO full
        t.join(WAIT_S)
        # parked past the activation deadline
        assert (out["r1"][0], out["r1"][1].get("Retry-After")) == (503, None)
        assert {r: _metric(side, "kft_gateway_shed_total", service="m", reason=r)
                - v for r, v in sheds0.items()} == {"queue_full": 1,
                                                   "activation_timeout": 1}
        assert gw.gw.activator.depth("m") == 0
    finally:
        gw.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_cold_start_parks_and_records_the_park_span(side):
    """``scale_up`` starts a replica and adds it to the pool, which wakes
    the parked request: one trace holds the park, the proxy and the
    replica's dataplane span."""
    box = {}

    def scale_up(service):  # on the JAX gateway's loop, or a port thread
        box["fleet"] = _Fleet([_Tagged("cold")])
        box["gw"].gw.pool.add(service, box["fleet"].urls[0])  # ready: flush

    box["gw"] = gw = _gateway(side, [], [dict(name="m")], scale_up=scale_up,
                              activation_timeout_s=WAIT_S)
    try:
        acts0 = _metric(side, "kft_gateway_activations_total", service="m")
        ctx = SIDES[side].trace.TraceContext("7e" * 16, "33" * 8)
        status, _, text = _call(gw.port, "POST", "/v1/models/m:predict",
                                {"instances": [[1]]},
                                {"x-kft-trace": ctx.header()})
        assert status == 200 and json.loads(text)["predictions"] == ["cold"]
        assert _metric(side, "kft_gateway_activations_total",
                       service="m") == acts0 + 1
        want = [("activator.park", "route", "ok"), ("dataplane", "proxy", "ok"),
                ("proxy", "route", "ok"), ("route", None, "ok")]
        assert _tree(ctx.trace_id, want) == want
        tr, _ = _trace_with(SIDES[side].trace.TRACER, "activator.park")
        (park,) = [s for s in tr["spans"] if s["name"] == "activator.park"]
        assert park["attrs"]["parked_depth"] == 1
        assert [ev["name"] for ev in park["events"]] == ["activated"]
    finally:
        gw.close()
        if "fleet" in box:
            box["fleet"].close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_tenant_rate_limit_429(side):
    profiles = SimpleNamespace(list=lambda: [SimpleNamespace(
        name="team-x", quota=SimpleNamespace(max_rps=0.01, burst=2))])
    fleet = _Fleet([_Tagged("a")])
    gw = _gateway(side, fleet.urls,
                  policy=SIDES[side].pol.PolicyEngine.from_profiles(profiles))
    try:
        shed0 = _metric(side, "kft_gateway_shed_total", service="m",
                        reason="rate_limit")
        hdr = {"x-kft-tenant": "team-x"}
        got = [_call(gw.port, "POST", "/v1/models/m:predict",
                     {"instances": [[1]]}, hdr) for _ in range(3)]
        assert [(s, h.get("Retry-After")) for s, h, _ in got] == [
            (200, None), (200, None), (429, "1")]  # the burst, then the limit
        assert "rate" in got[2][2].lower()
        assert _call(gw.port, "POST", "/v1/models/m:predict",
                     {"instances": [[1]]})[0] == 200  # other tenants unmanaged
        assert _metric(side, "kft_gateway_shed_total", service="m",
                       reason="rate_limit") == shed0 + 1
    finally:
        gw.close()
        fleet.close()


@pytest.mark.parametrize("loser", ["slow_answer", "slow_accept"])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_hedge_races_a_second_backend_and_cancels_the_loser(side, loser):
    """The first pick is slow (it answers only when the test ends, or
    never accepts the connection); the hedge to the second wins, and the
    reply does not wait for the loser: its span ends "cancelled" at once."""
    release = threading.Event()

    def slow(h, body):
        release.wait(WAIT_S)  # answers only once the test is over
        try:
            _send(h, 200, {"predictions": ["slow"]})
        except OSError:
            pass  # the gateway shut the loser's socket

    slow_b = (_Raw({("POST", "/v1/models/m:predict"): slow})
              if loser == "slow_answer" else _Unaccepting())
    fast_b = _Raw({("POST", "/v1/models/m:predict"):
                   lambda h, body: _send(h, 200, {"predictions": ["fast"]})})
    # insertion order makes the SLOW backend the first pick; a connect or
    # a read that waited out its timeout would take WAIT_S
    gw = _gateway(side, [slow_b.url, fast_b.url], [dict(name="m", hedge_ms=40.0)],
                  connect_timeout_s=WAIT_S, upstream_timeout_s=WAIT_S)
    try:
        h0 = _metric(side, "kft_gateway_hedges_total", service="m")
        t0 = time.monotonic()
        status, _, text = _call(gw.port, "POST", "/v1/models/m:predict",
                                {"instances": [[1]]})
        assert time.monotonic() - t0 < WAIT_S / 4
        assert status == 200 and json.loads(text)["predictions"] == ["fast"]
        assert _metric(side, "kft_gateway_hedges_total", service="m") == h0 + 1
        tr, _ = _trace_with(SIDES[side].trace.TRACER, "proxy")
        assert _tree(tr["trace_id"]) == [("proxy", "route", "cancelled"),
                                         ("proxy", "route", "ok"),
                                         ("route", None, "ok")]
        proxies = [s for s in tr["spans"] if s["name"] == "proxy"]
        (lost,) = [p for p in proxies if p["status"] == "cancelled"]
        (won,) = [p for p in proxies if p["status"] == "ok"]
        assert lost["attrs"].get("hedge_loser") is True
        assert lost["attrs"]["backend"] == slow_b.url
        assert won["attrs"]["backend"] == fast_b.url
        assert won["attrs"].get("hedge") is True
        # a cancel is no verdict on the loser's backend
        assert gw.gw.pool.find(slow_b.url).breaker.current_state() == "closed"
    finally:
        release.set()
        gw.close()
        slow_b.close()
        fast_b.close()


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_stream_death_without_resume_ends_in_one_error_frame(side, torn):
    """With resume off, a backend that dies mid-stream leaves the client a
    clean terminal error frame; a torn half frame is never forwarded."""

    def stream(h, body):
        _sse_start(h)
        _sse_chunk(h, b'data: {"token_ids": [1]}\n\n')
        if torn:
            _sse_chunk(h, b'data: {"token_')  # half a frame, then death
        _die(h)

    be = _Raw({("POST", "/v2/models/m/generate_stream"): stream})
    gw = _gateway(side, [be.url], stream_resume=False)
    try:
        status, _, text = _call(gw.port, "POST", "/v2/models/m/generate_stream",
                                {"prompt": "x"})
        assert status == 200
        assert 'token_\n' not in text  # torn bytes dropped
        frames = [json.loads(line[6:]) for line in text.splitlines()
                  if line.startswith("data: ")]
        assert frames[0] == {"token_ids": [1]}
        assert len(frames) == 2 and sorted(frames[1]) == ["error"]
    finally:
        gw.close()
        be.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_resume_splices_scripted_backends(side):
    seen = []

    def dying(h, body):
        seen.append((h.headers.get("x-kft-resume-tokens"), h.headers.get("x-kft-seed")))
        _sse_start(h)
        _sse_chunk(h, b'data: {"token_ids": [1]}\n\n')
        _sse_chunk(h, b'data: {"token_ids": [2]}\n\n')
        _die(h)

    def resuming(h, body):
        seen.append((h.headers.get("x-kft-resume-tokens"), h.headers.get("x-kft-seed")))
        _sse_start(h)
        # a replica emits only tokens past the committed prefix, and
        # counts only its own segment
        _sse_chunk(h, b'data: {"token_ids": [3, 4]}\n\n')
        _sse_chunk(h, b'data: {"done": true, "n_tokens": 2}\n\n')
        _sse_chunk(h, b"")

    a = _Raw({("POST", "/v2/models/m/generate_stream"): dying})
    b = _Raw({("POST", "/v2/models/m/generate_stream"): resuming})
    gw = _gateway(side, [a.url, b.url], [dict(name="m", max_attempts=3)],
                  retry_budget_floor=50)
    try:
        ok0 = _metric(side, "kft_gateway_stream_resumes_total", service="m",
                      outcome="ok")
        retries0 = _metric(side, "kft_gateway_retries_total", service="m")
        frames = _frames(gw.port, {"prompt": "x"}, {"x-request-id": "resume-1",
                                                    "x-kft-resume-tokens": "9,9"})
        assert frames == [{"token_ids": [1]}, {"token_ids": [2]},
                          {"token_ids": [3, 4]}, {"done": True, "n_tokens": 4}]
        _until(lambda: _metric(side, "kft_gateway_stream_resumes_total",
                               service="m", outcome="ok") == ok0 + 1,
               what="the resume's count")
        assert _metric(side, "kft_gateway_retries_total", service="m") == retries0 + 1
        # the client's own resume header never crossed; the resume carried
        # the committed prefix and the same gateway-stamped seed
        want_seed = str(int.from_bytes(
            hashlib.sha256(b"resume-1").digest()[:4], "big") & 0x7FFFFFFF)
        assert seen == [(None, want_seed), ("1,2", want_seed)]
    finally:
        gw.close()
        a.close()
        b.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_resume_budget_exhausted_one_terminal_frame(side):
    calls = []

    def always_dies(h, body):
        calls.append(h.headers.get("x-kft-resume-tokens"))
        _sse_start(h)
        _sse_chunk(h, b'data: {"token_ids": [7]}\n\n')
        _die(h)

    be = _Raw({("POST", "/v2/models/m/generate_stream"): always_dies})
    gw = _gateway(side, [be.url], [dict(name="m", max_attempts=2)],
                  retry_budget_floor=50)
    try:
        ex0 = _metric(side, "kft_gateway_stream_resumes_total", service="m",
                      outcome="budget_exhausted")
        frames = _frames(gw.port, {"prompt": "x"})
        # max_attempts=2: the dispatch + ONE resume to the lone backend
        assert calls == [None, "7"]
        assert frames[:2] == [{"token_ids": [7]}, {"token_ids": [7]}]
        assert len(frames) == 3 and sorted(frames[2]) == ["error"]
        _until(lambda: _metric(side, "kft_gateway_stream_resumes_total",
                               service="m", outcome="budget_exhausted") == ex0 + 1,
               what="the exhausted resume's count")
    finally:
        gw.close()
        be.close()


class _Endless(Model):
    """A stream that never ends on its own; records when it is closed."""

    def __init__(self):
        super().__init__("m")
        self.ready = True
        self.closed = threading.Event()

    def preprocess(self, payload, headers=None):
        return list(payload["instances"])

    def stream_row_tokens(self, row, headers=None):
        model = self
        pace = threading.Event()

        def gen():
            try:
                for i in range(100_000):
                    yield [i]
                    pace.wait(0.005)
            finally:
                model.closed.set()  # the row is cancelled

        return gen()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_client_disconnect_cancels_the_replica_row(side):
    """The reference's event loop sees the client's socket close at once;
    the port's thread sees it at the next frame it writes (one every 5
    ms here). Either way the replica's row is cancelled."""
    model = _Endless()
    fleet = _Fleet([model])
    gw = _gateway(side, fleet.urls)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=WAIT_S)
        conn.request("POST", "/v2/models/m/generate_stream", json.dumps({"ids": [1]}),
                     {"content-type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.readline().startswith(b"data: ")
        conn.sock.shutdown(2)  # the client walks away mid-stream
        conn.close()
        assert model.closed.wait(WAIT_S), "the replica's row was not cancelled"
    finally:
        gw.close()
        fleet.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_shed_503_with_retry_after_is_not_retried(side):
    calls = {"shed": 0, "broken": 0, "ok": 0}

    def mk(kind):
        def predict(h, body):
            calls[kind] += 1
            if kind == "shed":
                return _send(h, 503, {"error": "deadline unmeetable"},
                             {"Retry-After": "7"})
            if kind == "broken":
                return _send(h, 503, {"error": "dying"})
            _send(h, 200, {"predictions": [kind]})
        return _Raw({("POST", "/v1/models/m:predict"): predict})

    shed = mk("shed")
    gw = _gateway(side, [shed.url], retry_budget_floor=50)
    try:
        r0 = _metric(side, "kft_gateway_retries_total", service="m")
        s0 = _metric(side, "kft_gateway_shed_total", service="m",
                     reason="upstream_shed")
        status, headers, text = _call(gw.port, "POST", "/v1/models/m:predict",
                                      {"instances": [[1]]})
        assert (status, headers.get("Retry-After")) == (503, "7")
        assert json.loads(text) == {"error": "deadline unmeetable"}
        assert calls["shed"] == 1  # one attempt: no retry
        assert _metric(side, "kft_gateway_retries_total", service="m") == r0
        assert _metric(side, "kft_gateway_shed_total", service="m",
                       reason="upstream_shed") == s0 + 1
        (b,) = gw.gw.pool.backends_of("m")
        assert b.breaker.current_state() == "closed"  # no breaker penalty
    finally:
        gw.close()
        shed.close()
    broken, ok = mk("broken"), mk("ok")
    gw = _gateway(side, [broken.url, ok.url], retry_budget_floor=50)
    try:
        got = [_call(gw.port, "POST", "/v1/models/m:predict",
                     {"instances": [[i]]}) for i in range(4)]
        # the bare 503 IS retried to the survivor
        assert [(s, json.loads(t)) for s, _, t in got] == [
            (200, {"predictions": ["ok"]})] * 4
        assert calls["ok"] == 4 and calls["broken"] >= 1
    finally:
        gw.close()
        broken.close()
        ok.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_deadline_shed_at_edge_and_budget_rewrite(side):
    seen = []

    def predict(h, body):
        seen.append((h.headers.get("x-kft-deadline-ms"),
                     h.headers.get("x-kft-deadline-abs")))
        _send(h, 200, {"predictions": ["ok"]})

    be = _Raw({("POST", "/v1/models/m:predict"): predict})
    gw = _gateway(side, [be.url])
    try:
        d0 = _metric(side, "kft_gateway_shed_total", service="m", reason="deadline")
        status, headers, _ = _call(gw.port, "POST", "/v1/models/m:predict",
                                   {"instances": [[1]]}, {"x-kft-deadline-ms": "0"})
        assert (status, headers.get("Retry-After")) == (503, "1")
        assert _metric(side, "kft_gateway_shed_total", service="m",
                       reason="deadline") == d0 + 1
        assert seen == []  # never dispatched
        status, _, _ = _call(gw.port, "POST", "/v1/models/m:predict",
                             {"instances": [[1]]},
                             {"x-kft-deadline-ms": "60000",
                              "x-kft-deadline-abs": "12345.0"})
        assert status == 200 and len(seen) == 1
        assert 0 < int(seen[0][0]) <= 60000 and seen[0][1] is None
    finally:
        gw.close()
        be.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_stamps_tenant_priority_for_managed_tenants(side):
    seen = []

    def predict(h, body):
        seen.append(h.headers.get("x-kft-priority"))
        _send(h, 200, {"predictions": ["ok"]})

    be = _Raw({("POST", "/v1/models/m:predict"): predict})
    gw = _gateway(side, [be.url])
    gw.gw.policy.set("gold", SIDES[side].pol.TenantPolicy(priority=9))
    try:
        for tenant, prio in (("gold", "99"), ("stranger", "3")):
            assert _call(gw.port, "POST", "/v1/models/m:predict",
                         {"instances": [[1]]},
                         {"x-kft-tenant": tenant, "x-kft-priority": prio})[0] == 200
        assert seen == ["9", "3"]  # managed: stamped; unmanaged: passed through
    finally:
        gw.close()
        be.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_retry_keeps_one_trace_with_distinct_attempt_spans(side):
    calls, seen = {"n": 0}, []

    def predict(h, body):
        calls["n"] += 1
        if calls["n"] == 1:
            return _send(h, 502, {"error": "boom"})
        seen.append(h.headers.get("x-kft-trace"))
        _send(h, 200, {"predictions": ["ok"]})

    be = _Raw({("POST", "/v1/models/m:predict"): predict})
    gw = _gateway(side, [be.url], retry_budget_floor=50)
    trace = SIDES[side].trace
    try:
        ctx = trace.TraceContext("5c" * 16, "ab" * 8)
        assert _call(gw.port, "POST", "/v1/models/m:predict", {"instances": [[1]]},
                     {"x-kft-trace": ctx.header()})[0] == 200
        tr, _ = _trace_with(trace.TRACER, "route")
        assert tr["trace_id"] == ctx.trace_id and tr["kept"] == "error"
        assert _tree(ctx.trace_id) == [("proxy", "route", "error"),
                                       ("proxy", "route", "ok"),
                                       ("route", None, "ok")]
        (route,) = [s for s in tr["spans"] if s["name"] == "route"]
        assert route["parent_span_id"] == ctx.span_id
        assert [ev["name"] for ev in route["events"]] == ["retry"]
        proxies = [s for s in tr["spans"] if s["name"] == "proxy"]
        assert len({p["span_id"] for p in proxies}) == 2
        # the wire header the backend saw names the winning attempt
        winner = next(p for p in proxies if p["status"] == "ok")
        got = trace.TraceContext.parse(seen[0])
        assert (got.trace_id, got.span_id) == (ctx.trace_id, winner["span_id"])
    finally:
        gw.close()
        be.close()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_gateway_strips_client_asserted_authoritative_headers(side):
    seen = []

    def stream(h, body):
        seen.append({k: h.headers.get(k) for k in (
            "x-kft-prefill-peer", "x-kft-resume-tokens", "x-kft-seed",
            "x-kft-trace", "x-request-id")})
        _sse_start(h)
        _sse_chunk(h, b'data: {"done": true, "n_tokens": 0}\n\n')
        _sse_chunk(h, b"")

    be = _Raw({("POST", "/v2/models/m/generate_stream"): stream})
    pre = _Raw({})
    gw = _gateway(side, [be.url, (pre.url, "prefill")])
    try:
        frames = _frames(gw.port, {"prompt": "x"}, {
            "x-kft-prefill-peer": "http://evil", "x-kft-resume-tokens": "1,2",
            "x-kft-seed": "12345", "x-request-id": "rid-1"})
        assert frames == [{"done": True, "n_tokens": 0}]
        (got,) = seen
        assert got["x-kft-prefill-peer"] == pre.url  # the gateway's pick
        assert got["x-kft-resume-tokens"] is None
        assert got["x-kft-seed"] == "12345" and got["x-request-id"] == "rid-1"
        assert SIDES[side].trace.TraceContext.parse(got["x-kft-trace"]) is not None
        frames = _frames(gw.port, {"prompt": "x"}, {"x-request-id": "rid-2"})
        # no client seed: sha256 of the request id
        want = int.from_bytes(hashlib.sha256(b"rid-2").digest()[:4], "big") & 0x7FFFFFFF
        assert seen[1]["x-kft-seed"] == str(want)
    finally:
        gw.close()
        be.close()
        pre.close()


# ======================================================= (d) controller feed


def _echo_controller(side, tmp_path, fmt="echo"):
    """``test_gateway.py``'s ``_canary_controller`` for ``side``: a service
    deployed, then a 30% canary of a changed spec."""
    if side == "jax":
        from kubeflow_tpu.serve import controller as ctl_mod
        from kubeflow_tpu.serve import spec as spec_mod
        from kubeflow_tpu.serve.model import EchoModel
    else:
        from kubeflow_tpu_torch.serve import controller as ctl_mod
        from kubeflow_tpu_torch.serve import spec as spec_mod

        class EchoModel(Model):
            def predict(self, inputs, headers=None):
                return inputs
    reg = spec_mod.RuntimeRegistry()
    reg.register(spec_mod.ServingRuntime(
        "echo", (fmt,), lambda name, path, **kw: EchoModel(name)))
    ctl = ctl_mod.InferenceServiceController(reg, model_dir=str(tmp_path))
    ctl.apply(spec_mod.InferenceServiceSpec(
        "svc", spec_mod.PredictorSpec(model_format=fmt)))
    ctl.apply(spec_mod.InferenceServiceSpec(
        "svc", spec_mod.PredictorSpec(model_format=fmt, canary_traffic_percent=30,
                                      extra={"rollout": 2})))
    return ctl


@pytest.mark.parametrize("fmt", ["echo", "causal-lm-engine", "vllm", "llm"])
def test_route_table_fed_from_controller_matches_jax(fmt, tmp_path):
    """Mirrors ``test_gateway.py``'s controller-fed table: one route per
    service with a ``{name}.{namespace}`` host, the live canary percent,
    prefix affinity for LM-engine formats, the split gone once promoted;
    a route's declared prefixes and hedge survive a refresh."""
    views = {}
    for side, s in SIDES.items():
        ctl = _echo_controller(side, tmp_path / side, fmt)
        t = s.rt.RouteTable()
        t.upsert(s.rt.ServiceRoute(name="svc", path_prefixes=("/edge",), hedge_ms=5.0))
        t.update_from_controller(ctl)
        fed = t.get("svc").view()
        ctl.promote_canary("svc")
        t.update_from_controller(ctl)
        views[side] = (fed, t.get("svc").view(), [r.name for r in t.routes()])
    assert views["torch"] == views["jax"]
    fed, promoted, _ = views["torch"]
    assert fed["hosts"] == ["svc.default"] and fed["canary_percent"] == 30.0
    assert fed["affinity"] == ("none" if fmt == "echo" else "prefix")
    assert fed["path_prefixes"] == ["/edge"] and fed["hedge_ms"] == 5.0
    assert promoted["canary_percent"] == 0.0


def test_gateway_fed_by_the_port_controller(tmp_path):
    """The port's gateway, given the port's controller, resolves the
    service's Knative host to its replica at construction, and picks up a
    service applied later on a probe pass."""
    from kubeflow_tpu_torch.serve.controller import InferenceServiceController
    from kubeflow_tpu_torch.serve.spec import (
        InferenceServiceSpec,
        PredictorSpec,
        RuntimeRegistry,
        ServingRuntime,
    )

    reg = RuntimeRegistry()
    reg.register(ServingRuntime("tag", ("tag",), lambda name, path, **kw: _Tagged(
        kw.get("tag", "stable"), name=name)))
    ctl = InferenceServiceController(reg, model_dir=str(tmp_path))
    ctl.apply(InferenceServiceSpec("svc", PredictorSpec(model_format="tag")))
    fleet = _Fleet([ctl.route("svc")])
    gw = t_srv.InferenceGateway(
        t_srv.GatewayConfig(backends=[("svc", fleet.urls[0], "default")],
                            probe_interval_s=0.05),
        controller=ctl).start()
    try:
        assert gw.table.get("svc").hosts == ("svc.default",)
        status, _, text = _call(gw.http_port, "POST", "/v1/models/svc:predict",
                                {"instances": [[1]]}, {"host": "svc.default"})
        assert status == 200 and json.loads(text)["predictions"] == ["stable"]
        ctl.apply(InferenceServiceSpec("late", PredictorSpec(
            model_format="tag", extra={"tag": "late"})))
        _until(lambda: gw.table.get("late") is not None, what="the probe pass")
        assert gw.table.get("late").hosts == ("late.default",)
    finally:
        gw.stop()
        fleet.close()
