"""Request tracing in ``kubeflow_tpu_torch`` (``obs/trace.py`` and its
spans through the server, the batcher and the engine) against the JAX
package's, on the CPU.

The tracer is held against ``kubeflow_tpu/obs/trace.py`` on the same
inputs: the ``x-kft-trace`` context round trip and the malformed headers
it refuses, the tail sampler's verdicts and its bounded pools on one span
sequence, the disabled tracer, and the Perfetto export's shape. Then one
traced request goes through a JAX replica (aiohttp, on an event-loop
thread of its own) and through a torch replica on the bridged weights:
the two ``/debug/traces`` trees have the same span names, parent links
and statuses. Last, the rule for TTFT/TPOT: both engines observe them
only under a request's ``engine`` span — a traced submit records, an
untraced one and any request under a disabled tracer do not.

Both tracers are process-global, so every test clears them, samples at
1-in-1, and compares names, parents and statuses, never ids or times;
the sampler's test runs both tracers on one injected clock, so its
durations are the sequence's own.
"""

from __future__ import annotations

import asyncio
import functools
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp import web

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.obs import trace as jtrace
from kubeflow_tpu.serve import engine as jeng
from kubeflow_tpu.serve import server as jserver
from kubeflow_tpu.serve.batcher import BatcherConfig as JaxBatcherConfig
from kubeflow_tpu.serve.model import BucketSpec
from kubeflow_tpu.serve.model import Model as JaxModel
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.obs import trace as ttrace
from kubeflow_tpu_torch.serve import engine as teng
from kubeflow_tpu_torch.serve.batcher import BatcherConfig
from kubeflow_tpu_torch.serve.headers import TRACE_HEADER
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
EOS = 97  # outside the vocab: rows never retire early
PAGED = dict(kv_pool_tokens=16 * 16, page_size=16)
MAX_NEW = 6
TRACERS = {"jax": jtrace, "torch": ttrace}


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Isolate each test from both process-global tracers and keep every
    healthy trace (1-in-1 sampling)."""
    old = {k: (m.TRACER.sample_every, m.TRACER.enabled) for k, m in TRACERS.items()}
    for m in TRACERS.values():
        m.TRACER.clear()
        m.TRACER.sample_every = 1
        m.TRACER.enabled = True
    yield
    for k, m in TRACERS.items():
        m.TRACER.sample_every, m.TRACER.enabled = old[k]
        m.TRACER.clear()


# ------------------------------------------------------------- context


CTX_CASES = {
    "sampled": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "not_sampled": "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "flags_other_bits": "00-" + "a" * 32 + "-" + "b" * 16 + "-03",
    "padded": "  00-" + "1f" * 16 + "-" + "2e" * 8 + "-01  ",
    "empty": "",
    "garbage": "garbage",
    "non_hex": "00-xyz-123-01",
    "short_trace_id": "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "zero_trace_id": "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "zero_span_id": "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "bad_version": " zz-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "five_parts": "00-" + "a" * 32 + "-" + "b" * 16 + "-01-00",
    "long_flags": "00-" + "a" * 32 + "-" + "b" * 16 + "-001",
}


def _parsed(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled)


@pytest.mark.parametrize("case", sorted(CTX_CASES))
def test_trace_context_parse_matches_jax(case):
    value = CTX_CASES[case]
    got = {k: _parsed(m.TraceContext.parse(value)) for k, m in TRACERS.items()}
    assert got["torch"] == got["jax"]
    if got["torch"] is not None:
        # the header a parsed context writes parses back to itself, and
        # both spellings of the header name resolve it
        ctx = ttrace.TraceContext.parse(value)
        assert _parsed(ttrace.TraceContext.parse(ctx.header())) == got["torch"]
        assert ctx.header() == jtrace.TraceContext.parse(value).header()
        for key in (TRACE_HEADER, TRACE_HEADER.title()):
            assert _parsed(ttrace.ctx_from_headers({key: value})) == got["torch"]
    assert ttrace.ctx_from_headers({}) is None
    assert ttrace.ctx_from_headers(None) is None


# ------------------------------------------------------------- sampler


class _Clock:
    """Stands in for a trace module's ``time``: ``monotonic`` reads a
    counter the test advances by whole ticks of 2**-10 s, so that equal
    durations are equal floats and the sampler's p99 class depends on the
    sequence alone; ``time`` stays the wall clock (display only)."""

    TICK = 2.0 ** -10

    def __init__(self):
        self.now = 1024.0

    def monotonic(self):
        return self.now

    def time(self):
        return time.time()

    def span(self, tracer, name, ticks, status=None):
        """A root span lasting ``ticks`` ticks."""
        sp = tracer.span(name)
        self.now += ticks * self.TICK
        sp.end(status)


# The healthy traces' lengths in ticks. The 64th finish (the 59th healthy
# one) sets the rolling p99 to the longest of the first 64 (59 ticks) and
# is itself kept as slow; after it, 80, 59 and 100 reach the p99 and
# the 5s do not.
HEALTHY_TICKS = list(range(1, 60)) + [5, 80, 5, 59, 5, 100]


def _span_sequence(clock, tracer):
    """One fixed sequence of 71 traces: each failure class, a run of
    healthy ones past the 64 finishes at which the p99 starts to
    classify, and a nested trace."""
    for status in ("error", "shed", "deadline", "poisoned", "cancelled"):
        clock.span(tracer, f"req-{status}", 10, status)
    for ticks in HEALTHY_TICKS:
        clock.span(tracer, "req-ok", ticks)
    root = tracer.span("route")
    child = tracer.span("proxy", parent=root)
    tracer.record_span("decode.chunk", parent=child, start=child.start,
                       end=child.start + clock.TICK, attrs={"tokens": 2})
    clock.now += 200 * clock.TICK
    child.end("error")
    root.end()


def _kept(tracer):
    snap = tracer.snapshot(limit=256)
    return snap["finished"], sorted(
        (t["kept"], t["duration_ms"],
         tuple(sorted((s["name"], s["status"]) for s in t["spans"])))
        for t in snap["traces"])


@pytest.mark.parametrize("sample_every", [1, 4, 16])
def test_tail_sampler_verdicts_match_jax(sample_every, monkeypatch):
    got, p99 = {}, {}
    for k, m in TRACERS.items():
        clock = _Clock()
        monkeypatch.setattr(m, "time", clock)
        tr = m.Tracer(sample_every=sample_every)
        _span_sequence(clock, tr)
        got[k] = _kept(tr)
        p99[k] = tr.snapshot()["p99_ms"]
    assert got["torch"] == got["jax"]
    finished, kept = got["torch"]
    assert finished == 71
    # every failure class is kept, under its own verdict; cancelled is
    # not a failure
    fails = sorted(v for v, _, _ in kept if v not in ("sampled", "slow_p99"))
    assert fails == ["deadline", "error", "error", "poisoned", "shed"]
    # the slow class: the traces that reached the p99 once 64 finished
    ms = 1e3 * _Clock.TICK
    assert p99["torch"] == p99["jax"] == round(59 * ms, 3)
    assert sorted(d for v, d, _ in kept if v == "slow_p99") == [
        round(t * ms, 3) for t in (59, 59, 80, 100)]
    # 1-in-N of the rest by finish number: the cancelled trace (5th) and
    # the healthy ones (6th to 70th) that were not slow
    slow = {64, 66, 68, 70}
    assert sum(v == "sampled" for v, _, _ in kept) == sum(
        1 for f in range(5, 71) if f not in slow and f % sample_every == 0)


@pytest.mark.parametrize("pool,status,n,cap", [
    ("_errors", "error", 1000, 256),
    ("_errors", "shed", 300, 256),
    ("_sampled", None, 2000, 64),
])
def test_tail_sampler_pools_stay_bounded(pool, status, n, cap):
    lens = {}
    for k, m in TRACERS.items():
        tr = m.Tracer(sample_every=1)
        for _ in range(n):
            tr.span("boom").end(status)
        lens[k] = (len(getattr(tr, pool)), len(tr.snapshot(limit=64)["traces"]),
                   len(tr._live))
    assert lens["torch"] == lens["jax"] == (cap, 64, 0)


def test_live_traces_are_evicted_not_accumulated():
    got = {}
    for k, m in TRACERS.items():
        tr = m.Tracer(max_live=8, sample_every=1)
        for _ in range(20):
            tr.span("leaked")  # never ended
        assert len(tr._live) == 8
        # the 12 evicted traces were finalized and classified, not kept live
        got[k] = _kept(tr)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 12


@pytest.mark.parametrize("mod", sorted(TRACERS))
def test_disabled_tracer_is_a_falsy_noop(mod):
    m = TRACERS[mod]
    tr = m.Tracer(enabled=False)
    span = tr.span("route")
    assert not span and span.header() == "" and span.ctx is None
    span.set_attr("k", "v")
    span.event("e")
    span.end("error")
    with span:
        pass
    tr.record_span("decode.chunk", parent=span, start=0.0, end=1.0)
    assert tr.snapshot()["traces"] == [] and tr.snapshot()["finished"] == 0


@pytest.mark.parametrize("value,enabled", [
    ("0", False), ("false", False), ("off", False), ("1", True), ("yes", True)])
def test_kft_trace_switch(monkeypatch, value, enabled):
    monkeypatch.setenv("KFT_TRACE", value)
    assert ttrace.Tracer().enabled is jtrace.Tracer().enabled is enabled


def test_current_ids_follow_the_ambient_span():
    span = ttrace.TRACER.span("dataplane")
    tok = ttrace.set_current(span)
    try:
        assert ttrace.current_ids() == (span.trace_id, span.span_id)
    finally:
        ttrace.reset_current(tok)
        span.end()
    assert ttrace.current_ids() is None


# ------------------------------------------------------------- export


def _perfetto_shape(doc):
    """The export without ids and times: (phase, name, status, parent's
    name) per event, and the set of keys per phase."""
    names = {e["args"]["span_id"]: e["name"] for e in doc["traceEvents"]
             if e["ph"] == "X"}
    rows = sorted(
        (e["ph"], e["name"], e.get("args", {}).get("status", ""),
         names.get(e.get("args", {}).get("parent_span_id"), ""))
        for e in doc["traceEvents"] if e["ph"] != "M")
    keys = sorted({(e["ph"], tuple(sorted(e))) for e in doc["traceEvents"]})
    return rows, keys


def test_perfetto_export_shape_matches_jax():
    docs = {}
    for k, m in TRACERS.items():
        tr = m.Tracer(sample_every=1)
        root = tr.span("route")
        child = tr.span("proxy", parent=root)
        child.set_attr("backend", "http://b")
        child.event("retry", attempt=1)
        child.end()
        tr.record_span("decode.chunk", parent=child, start=child.start,
                       end=child.end_time)
        root.end("error")
        docs[k] = m.to_perfetto(tr.snapshot())
        json.dumps(docs[k])  # loadable by ui.perfetto.dev: serializes clean
    assert set(docs["torch"]) == {"traceEvents", "displayTimeUnit"}
    assert _perfetto_shape(docs["torch"]) == _perfetto_shape(docs["jax"])
    xs = [e for e in docs["torch"]["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)


# ---------------------------------------------------- served traces


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = JaxConfig(**KW, attn_impl="reference", dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    return jcfg, params


ENGINE_KW = dict(max_batch=2, chunk_steps=2, max_new_tokens=MAX_NEW, eos_id=EOS,
                 watchdog=False, pipeline_depth=0, **PAGED)


def _jax_lm(name="lm"):
    jcfg, params = _weights()
    m = jeng.LMEngineModel(
        name, None, config=jcfg,
        buckets=BucketSpec(batch_sizes=(1,), seq_lens=(16,)), **ENGINE_KW)
    m.load()
    m._params = jax.device_put(params)
    m.engine.stop()
    m.engine = m._make_engine().start()
    return m


def _torch_lm(name="lm"):
    _, params = _weights()
    return teng.LMEngineModel(
        name, config=TransformerConfig(**KW), state_dict=params_to_state_dict(params),
        device="cpu", prefill_buckets=(16,), **ENGINE_KW)


class _JaxTagged(JaxModel):
    def __init__(self, name="m"):
        super().__init__(name)
        self.ready = True

    def predict(self, inputs, headers=None):
        return {"predictions": [0 for _ in inputs["instances"]]}


class _TorchTagged(Model):
    def __init__(self, name="m"):
        super().__init__(name)
        self.ready = True

    def predict(self, inputs, headers=None):
        return [0 for _ in inputs["instances"]]


class _JaxReplica:
    """A JAX ``ModelServer`` on an ephemeral port, its event loop on a
    thread of its own."""

    def __init__(self, models, **kw):
        self.models = models
        self.server = jserver.ModelServer(models, **kw)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def up():
            runner = web.AppRunner(self.server.build_app())
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return runner, site._server.sockets[0].getsockname()[1]

        self.runner, self.port = asyncio.run_coroutine_threadsafe(
            up(), self.loop).result(60)

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(
                self.runner.cleanup(), self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()
            for m in self.models:
                m.unload()


def _call(port, method, path, body=None, headers=None):
    """``(status, body text)`` over ``http.client`` with lower-case
    header names (the JAX server reads both spellings)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _tree(port, trace_id):
    """The trace's spans as sorted (name, parent's name, status), read
    from ``/debug/traces``; every span's parent is in the trace except
    the root's, whose parent is the client's span."""
    status, text = _call(port, "GET", "/debug/traces?limit=16")
    assert status == 200
    tr = next(t for t in json.loads(text)["traces"] if t["trace_id"] == trace_id)
    by_id = {s["span_id"]: s["name"] for s in tr["spans"]}
    return sorted((s["name"], by_id.get(s["parent_span_id"], "<client>"),
                   s["status"]) for s in tr["spans"])


def _wait_finished(tracer, trace_id, timeout_s=30.0):
    """The trace leaves the live pool once its last span ends (the SSE
    pump may end its span just after the client read the last frame)."""
    ev = threading.Event()
    for _ in range(int(timeout_s / 0.01)):
        with tracer._lock:
            if trace_id not in tracer._live:
                return
        ev.wait(0.01)
    raise AssertionError(f"trace {trace_id} still live after {timeout_s}s")


ROUTES = {
    "generate": ("POST", "/v2/models/lm/generate",
                 {"input_ids": [3, 4, 5, 6], "max_new_tokens": MAX_NEW}),
    "generate_stream": ("POST", "/v2/models/lm/generate_stream",
                        {"input_ids": [3, 4, 5, 6], "max_new_tokens": MAX_NEW}),
    "predict": ("POST", "/v1/models/lm:predict",
                {"instances": [{"input_ids": [3, 4, 5, 6]}, {"input_ids": [7, 8]}]}),
    "batched_predict": ("POST", "/v1/models/m:predict", {"instances": [[1], [2]]}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_served_trace_tree_matches_jax_replica(route):
    method, path, body = ROUTES[route]
    batched = route == "batched_predict"
    ctx = ttrace.TraceContext("ab" * 16, "12" * 8)
    hdrs = {TRACE_HEADER: ctx.header()}
    if batched:
        jrep = _JaxReplica([_JaxTagged()], batcher=JaxBatcherConfig(
            max_batch_size=4, max_latency_ms=1.0))
        tserv = ModelServer([_TorchTagged()], http_port=0, batcher=BatcherConfig(
            max_batch_size=4, max_latency_ms=1.0)).start()
    else:
        jrep = _JaxReplica([_jax_lm()])
        tserv = ModelServer([_torch_lm()], http_port=0).start()
    try:
        jout = _call(jrep.port, method, path, body, hdrs)
        tout = _call(tserv.port, method, path, body, hdrs)
        assert jout[0] == tout[0] == 200
        if not batched:
            assert tout[1] == jout[1]  # same tokens (f32, bridged weights)
        _wait_finished(jtrace.TRACER, ctx.trace_id)
        _wait_finished(ttrace.TRACER, ctx.trace_id)
        jtree, ttree = _tree(jrep.port, ctx.trace_id), _tree(tserv.port, ctx.trace_id)
    finally:
        tserv.stop()
        jrep.close()
    assert ttree == jtree
    names = {n for n, _, _ in ttree}
    if batched:
        assert {"dataplane", "batcher.wait", "batcher.flush"} <= names
    else:
        top = "dataplane.stream" if route == "generate_stream" else "dataplane"
        assert (top, "<client>", "ok") in ttree
        assert {"engine", "queue.wait", "prefill", "decode.chunk"} <= names
        assert all(p == "engine" for n, p, _ in ttree
                   if n in ("queue.wait", "prefill", "decode.chunk"))


def test_debug_traces_limit_and_perfetto_on_the_torch_replica():
    tserv = ModelServer([_TorchTagged()], http_port=0).start()
    try:
        for _ in range(3):
            assert _call(tserv.port, "POST", "/v1/models/m:predict",
                         {"instances": [[1]]})[0] == 200
        status, text = _call(tserv.port, "GET", "/debug/traces?limit=2")
        snap = json.loads(text)
        assert status == 200 and len(snap["traces"]) == 2
        assert snap["finished"] == 3 and snap["live"] == 0
        status, text = _call(tserv.port, "GET", "/debug/traces?format=perfetto")
        assert status == 200
        assert any(e["ph"] == "X" and e["name"] == "dataplane"
                   for e in json.loads(text)["traceEvents"])
        assert _call(tserv.port, "GET", "/debug/traces?limit=x")[0] == 400
    finally:
        tserv.stop()


# --------------------------------------------- TTFT/TPOT, the JAX rule


def _hist_count(metric, label):
    child = metric._children.get((("model", label),))
    return child.count if child else 0


def _engine_counts(side):
    m = TRACERS[side]
    return _hist_count(m.TTFT_MS, "engine"), _hist_count(m.TPOT_MS, "engine")


@pytest.mark.parametrize("side", ["jax", "torch"])
@pytest.mark.parametrize("how", ["traced", "untraced", "disabled"])
def test_ttft_tpot_only_under_an_engine_span(side, how):
    """The engine observes TTFT/TPOT when it closes a request's ``engine``
    span, so only a traced request is counted: not an untraced submit,
    and not a traced one while the tracer is off."""
    jcfg, params = _weights()
    base = dict(max_batch=2, max_seq=64, chunk_steps=2, prefill_buckets=(16,),
                eos_id=EOS, pipeline_depth=0, **PAGED)
    if side == "jax":
        eng = jeng.LMEngine(JaxLM(jcfg), jcfg, params, **base)
    else:
        tm = TransformerLM(TransformerConfig(**KW), device="cpu")
        tm.load_state_dict(params_to_state_dict(params))
        eng = teng.LMEngine(tm.eval().requires_grad_(False), **base)
    eng.start()
    mod = TRACERS[side]
    try:
        before = _engine_counts(side)
        if how == "disabled":
            mod.TRACER.enabled = False
        ctx = mod.TraceContext("cd" * 16, "34" * 8) if how != "untraced" else None
        toks = eng.submit([3, 4, 5], max_new_tokens=4, trace=ctx)
        after = _engine_counts(side)
    finally:
        eng.stop()
    assert len(toks) == 4
    want = (1, 1) if how == "traced" else (0, 0)
    assert (after[0] - before[0], after[1] - before[1]) == want


@pytest.mark.parametrize("enabled", [True, False])
def test_served_requests_follow_the_tracer_switch_in_both_servers(enabled):
    """Behind either server, a request counts toward TTFT/TPOT only while
    tracing is on (the dataplane span parents the engine span); with
    tracing off neither server records it."""
    jrep = _JaxReplica([_jax_lm("lm-sw")])
    tserv = ModelServer([_torch_lm("lm-sw")], http_port=0).start()
    body = {"input_ids": [3, 4, 5], "max_new_tokens": 4}
    try:
        for m in TRACERS.values():
            m.TRACER.enabled = enabled
        counts = {}
        for side, port in (("jax", jrep.port), ("torch", tserv.port)):
            m = TRACERS[side]
            t0 = _hist_count(m.TTFT_MS, "lm-sw")
            for path in ("/v2/models/lm-sw/generate",
                         "/v2/models/lm-sw/generate_stream"):
                assert _call(port, "POST", path, body)[0] == 200
            counts[side] = _hist_count(m.TTFT_MS, "lm-sw") - t0
    finally:
        tserv.stop()
        jrep.close()
    assert counts["torch"] == counts["jax"] == (2 if enabled else 0)
