"""The replica's request contract in ``kubeflow_tpu_torch`` against the
JAX package's, on the CPU.

The mirrors of ``tests/test_sre.py`` (header parsing, the stream's
end-to-end deadline, queued and mid-decode expiry, the unmeetable-deadline
shed, the cold EWMA, priority eviction, the server's error mapping and its
default deadline) run the same request sequence through a JAX engine or
replica and a torch one on the same weights (the JAX init bridged into
the port, f32, 2 layers, d_model 64, GQA 4/2 heads, vocab 97, paged pool
of 16-token pages): the same statuses, the same ``Retry-After``, the same
``shed_*`` counts, the same tokens. Waits are on Events; a wedge is the
engine's ``pre_chunk`` fault hook blocking on one, and a deadline that
must pass inside a wedge is set on the request, never waited out.

Then the port's own surface: SSE streaming (frames equal the JAX engine's
greedy stream, a resumed stream continues it, a disconnect frees the
row), ``/metrics`` against the JAX server's exposition, the int8
``kv_quant_error`` against the JAX engine's EWMA, warmup, and the
disaggregation and session headers served on both routes.
"""

from __future__ import annotations

import asyncio
import functools
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve import deadline as jdl
from kubeflow_tpu.serve import engine as jeng
from kubeflow_tpu.serve import server as jserver
from kubeflow_tpu.serve import watchdog as jwd
from kubeflow_tpu.serve.model import BucketSpec
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.obs import prom
from kubeflow_tpu_torch.serve import deadline as tdl
from kubeflow_tpu_torch.serve import engine as teng
from kubeflow_tpu_torch.serve import watchdog as twd
from kubeflow_tpu_torch.serve.headers import (
    DEADLINE_ABS_HEADER,
    DEADLINE_HEADER,
    PREFILL_PEER_HEADER,
    PRIORITY_HEADER,
    RESUME_TOKENS_HEADER,
    SEED_HEADER,
    SESSION_HEADER,
    TRACE_HEADER,
)
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
EOS = 1
NEVER = 97  # an eos id outside the vocab: rows never retire early
PAGED = dict(kv_pool_tokens=16 * 16, page_size=16)
MAX_NEW = 8


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = JaxConfig(**KW, attn_impl="reference", dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = TransformerLM(TransformerConfig(**KW), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(params))
    return jmodel, jcfg, params, tmodel.eval().requires_grad_(False)


def _engines(**kw):
    """A JAX and a torch engine with the same knobs (not started)."""
    jmodel, jcfg, params, tmodel = _weights()
    base = dict(max_batch=2, max_seq=64, chunk_steps=2, prefill_buckets=(16,),
                eos_id=EOS, **PAGED)
    base.update(kw)
    return {"jax": jeng.LMEngine(jmodel, jcfg, params, **base),
            "torch": teng.LMEngine(tmodel, **base)}


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, KW["vocab_size"], size=n)]
            for n in lengths]


def _jax_greedy(prompts, max_new=MAX_NEW):
    eng = _engines(pipeline_depth=0)["jax"].start()
    try:
        return [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    finally:
        eng.stop()


def _wedge(eng):
    """Block the engine's next chunk dispatch until ``release``;
    ``entered`` is set once the scheduler is inside the hook."""
    entered, release = threading.Event(), threading.Event()

    def hook(e):
        entered.set()
        release.wait(120)
        e._fault_hooks.pop("pre_chunk", None)

    eng._fault_hooks["pre_chunk"] = hook
    return entered, release


def _counter(metric, **labels):
    child = metric._children.get(tuple(sorted(labels.items())))
    return child.value if child else 0.0


def _outcome(fn):
    """``("ok", result)`` or the error's class name and shed fields."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, getattr(e, "stage", None),
                getattr(e, "reason", None), getattr(e, "retry_after_s", None))


# ------------------------------------------------------------- headers


HEADER_CASES = [
    None, {}, {DEADLINE_HEADER: "junk"}, {DEADLINE_HEADER: "1500"},
    {DEADLINE_HEADER.title(): "1500"}, {DEADLINE_HEADER: "-5"},
    {DEADLINE_HEADER: "1500", DEADLINE_ABS_HEADER: "42.5"},
    {DEADLINE_ABS_HEADER: "nope"}, {PRIORITY_HEADER: "7"},
    {PRIORITY_HEADER: "x"}, {PRIORITY_HEADER.title(): "-2"},
    {RESUME_TOKENS_HEADER: "5, 9,11"}, {RESUME_TOKENS_HEADER: "5,x"},
    {RESUME_TOKENS_HEADER: ""}, {SEED_HEADER: "1234"}, {SEED_HEADER: "1.5"},
]


@pytest.mark.parametrize("headers", HEADER_CASES, ids=range(len(HEADER_CASES)))
def test_header_parsing_matches_jax(headers):
    clock = lambda: 100.0  # noqa: E731
    got, want = (
        (m.deadline_from_headers(headers, clock=clock),
         m.priority_from_headers(headers), m.resume_from_headers(headers),
         m.seed_from_headers(headers), m.remaining_s(
             m.deadline_from_headers(headers, clock=clock), clock=clock))
        for m in (tdl, jdl)
    )
    assert got == want
    assert tdl.deadline_from_headers({DEADLINE_HEADER: "1500"},
                                     clock=clock) == pytest.approx(101.5)
    for name in ("DEADLINE_HEADER", "DEADLINE_ABS_HEADER", "PRIORITY_HEADER",
                 "RESUME_TOKENS_HEADER", "SEED_HEADER"):
        assert getattr(tdl, name) == getattr(jdl, name)
    from kubeflow_tpu.obs import headers as jh
    from kubeflow_tpu_torch.serve import headers as th
    for name in ("TRACE_HEADER", "PREFILL_PEER_HEADER", "SESSION_HEADER"):
        assert getattr(th, name) == getattr(jh, name)


def test_error_classes_match_jax():
    e = tdl.AdmissionShed("x", reason="priority_evict", retry_after_s=0.2)
    assert (e.reason, e.retry_after_s) == ("priority_evict", 1.0)
    d = tdl.DeadlineExceeded("y", stage="queued")
    assert isinstance(d, TimeoutError) and (d.stage, d.retry_after_s) == ("queued", 1.0)
    # the engine module still exports both
    assert teng.DeadlineExceeded is tdl.DeadlineExceeded
    assert teng.AdmissionShed is tdl.AdmissionShed


# ---------------------------------------------------- deadline seams


def _stream_deadline(eng):
    """Each chunk is held 0.2 s (an Event wait in the fault hook), well
    inside the 0.5 s deadline, so per-item timeouts would let the 15
    chunks run 3 s; one end-to-end deadline fails the stream at 0.5 s."""
    eng.start()
    eng.submit([9, 8], max_new_tokens=2)  # warm
    done = threading.Event()
    eng._fault_hooks["pre_chunk"] = lambda e: done.wait(0.2)
    try:
        t0 = time.monotonic()
        chunks = []
        with pytest.raises(TimeoutError) as ei:
            for c in eng.stream([3, 4, 5], max_new_tokens=30,
                                deadline=time.monotonic() + 0.5):
                chunks.append(c)
        elapsed = time.monotonic() - t0
        return type(ei.value).__name__, ei.value.stage, elapsed, sum(map(len, chunks))
    finally:
        done.set()
        eng.stop()


def test_stream_deadline_is_end_to_end_not_per_item():
    outs = {k: _stream_deadline(e)
            for k, e in _engines(eos_id=NEVER, max_batch=1).items()}
    for name, (_, _, elapsed, n) in outs.items():
        assert elapsed < 2.0 and n < 30, (name, elapsed, n)
    assert outs["torch"][:2] == outs["jax"][:2] == ("DeadlineExceeded", "wait")


def _queued_deadline(eng, dl):
    """The victim's deadline passes while it waits behind a wedged row:
    it is retired from the queue, never admitted."""
    eng.start()
    entered, release = _wedge(eng)
    q0 = _counter(dl.DEADLINE_EXPIRED, stage="queued")
    try:
        blocker = eng._enqueue([5, 6, 7], 6, 0.0, live=False,
                               deadline=time.monotonic() + 120)
        assert entered.wait(120)
        admitted0 = eng.stats["admitted"]
        victim = eng._enqueue([8, 9], 4, 0.0, live=False,
                              deadline=time.monotonic() + 120)
        victim.deadline = time.monotonic() - 1e-3  # expires while queued
        release.set()
        assert victim.done.wait(120) and blocker.done.wait(120)
        return {
            "victim": (type(victim.error).__name__, victim.error.stage,
                       victim.tokens),
            "blocker": (blocker.error, blocker.tokens),
            "admitted": eng.stats["admitted"] - admitted0,
            "expired_queued": eng.stats["deadline_expired_queued"],
            "counter": _counter(dl.DEADLINE_EXPIRED, stage="queued") - q0,
        }
    finally:
        release.set()
        eng.stop()


def test_queued_past_deadline_never_admitted():
    engines = _engines(max_batch=1)
    got = _queued_deadline(engines["torch"], tdl)
    want = _queued_deadline(engines["jax"], jdl)
    assert got == want
    assert got["victim"] == ("DeadlineExceeded", "queued", [])
    assert got["admitted"] == 0 and got["expired_queued"] == got["counter"] == 1


def _mid_decode_deadline(eng, dl):
    eng.start()
    eng.submit([9, 8], max_new_tokens=2)  # warm
    entered, release = _wedge(eng)
    d0 = _counter(dl.DEADLINE_EXPIRED, stage="decoding")
    try:
        req = eng._enqueue([3, 4, 5], 30, 0.0, live=False,
                           deadline=time.monotonic() + 120)
        assert entered.wait(120)  # admitted, prefilled, first chunk wedged
        req.deadline = time.monotonic() - 1e-3
        release.set()
        assert req.done.wait(120)
        after = eng.submit([5, 6], max_new_tokens=3, timeout_s=60)
        return {
            "error": (type(req.error).__name__, req.error.stage),
            "expired_decoding": eng.stats["deadline_expired_decoding"],
            "counter": _counter(dl.DEADLINE_EXPIRED, stage="decoding") - d0,
            "active_after": int(eng.active.sum()), "after": after,
            "pages_used": eng.pager.used_pages,
        }
    finally:
        release.set()
        eng.stop()


def test_mid_decode_deadline_cancelled_at_epoch():
    engines = _engines(max_batch=1, eos_id=NEVER)
    got = _mid_decode_deadline(engines["torch"], tdl)
    want = _mid_decode_deadline(engines["jax"], jdl)
    assert got == want
    assert got["error"] == ("DeadlineExceeded", "decoding")
    assert got["expired_decoding"] == got["counter"] == 1
    assert got["active_after"] == 0 and got["pages_used"] == 0


def _shed(eng, dl):
    eng.start()
    s0 = _counter(dl.ADMISSION_SHED, reason="deadline_unmeetable")
    try:
        # evidence: 200 ms a 2-token chunk → 32 tokens ≈ 3.2 s > 0.5 s
        eng.overlap["decode_gap_ms"] = 200.0
        est = eng.estimate_admission(32)
        shed = _outcome(lambda: eng.submit(
            [3, 4, 5], max_new_tokens=32, deadline=time.monotonic() + 0.5))
        stats = {k: eng.stats[k] for k in ("shed_deadline", "admitted")}
        roomy = eng.submit([3, 4, 5], max_new_tokens=4, timeout_s=60)
        return {"est": est, "shed": shed, "stats": stats, "roomy": roomy,
                "counter": _counter(dl.ADMISSION_SHED,
                                    reason="deadline_unmeetable") - s0}
    finally:
        eng.stop()


def test_admission_shed_unmeetable_deadline():
    engines = _engines()
    got, want = _shed(engines["torch"], tdl), _shed(engines["jax"], jdl)
    assert got == want
    assert got["shed"] == ("AdmissionShed", None, "deadline_unmeetable", 1.0)
    assert got["stats"] == {"shed_deadline": 1, "admitted": 0}
    assert got["counter"] == 1 and got["roomy"]


def test_admission_never_sheds_on_cold_ewma():
    for eng in _engines().values():
        eng.start()
        try:
            assert eng.estimate_admission(32) is None
            assert eng.submit([3, 4], max_new_tokens=4,
                              deadline=time.monotonic() + 30)
        finally:
            eng.stop()


class _Dummy:
    """A stand-in queued request: the estimate only counts them."""

    done = cancelled = None
    priority = 0


ESTIMATES = [
    # (spec K, decode_gap_ms, occupied rows, active rows, queued, held,
    #  max_new_tokens)
    (0, 0.0, 1, 1, 0, False, 16),
    (0, 120.0, 0, 0, 0, False, 16),
    (0, 120.0, 2, 2, 0, False, 16),
    (0, 75.5, 2, 1, 3, False, 9),
    (0, 75.5, 1, 1, 2, True, 33),
    (2, 40.0, 2, 2, 5, True, 20),
    (2, 40.0, 2, 0, 1, False, 7),
]


@pytest.mark.parametrize("case", ESTIMATES, ids=range(len(ESTIMATES)))
def test_estimate_admission_matches_jax(case):
    k, gap, occupied, active, queued, held, max_new = case
    results = []
    for eng in _engines(max_batch=2, chunk_steps=3,
                        spec_draft_tokens=k).values():
        eng.overlap["decode_gap_ms"] = gap
        for row in range(occupied):
            eng._slots[row] = _Dummy()
        eng.active[:active] = True
        eng.budget[:] = (10, 23)
        eng.gen_count[:] = (4, 2)
        for _ in range(queued):
            eng._pending.put(_Dummy())
        eng._held = _Dummy() if held else None
        results.append(eng.estimate_admission(max_new))
    assert results[0] == results[1]
    assert (results[0] is None) == (gap == 0.0)


def _priority(eng, dl):
    """Capacity 1 row + 2 queued, the row wedged: a priority-3 newcomer
    evicts the lowest queued request; an equal-priority one is refused."""
    eng.start()
    entered, release = _wedge(eng)
    p0 = _counter(dl.ADMISSION_SHED, reason="priority_evict")
    enq = lambda ids, prio: eng._enqueue(  # noqa: E731
        ids, 6, 0.0, live=False, deadline=time.monotonic() + 120,
        priority=prio)
    try:
        reqs = {"active": enq([5, 6, 7], 0)}
        assert entered.wait(120)
        reqs["low"] = enq([8, 9], 0)
        reqs["mid"] = enq([9, 10], 1)
        reqs["high"] = enq([11, 12], 3)          # evicts "low"
        low_gone = reqs["low"].done.is_set()
        refused = _outcome(lambda: enq([13, 14], 1))
        shed = eng.stats["shed_priority"]
        release.set()
        for r in reqs.values():
            assert r.done.wait(120)
        return {
            "low_gone_at_once": low_gone, "refused": refused,
            "shed_priority": shed,
            "counter": _counter(dl.ADMISSION_SHED, reason="priority_evict") - p0,
            "results": {k: (type(r.error).__name__ if r.error else None,
                            getattr(r.error, "reason", None), r.tokens)
                        for k, r in reqs.items()},
        }
    finally:
        release.set()
        eng.stop()


def test_priority_evicts_lowest_queued_under_overload():
    engines = _engines(max_batch=1, max_queue=2)
    got = _priority(engines["torch"], tdl)
    want = _priority(engines["jax"], jdl)
    assert got == want
    assert got["low_gone_at_once"] and got["shed_priority"] == got["counter"] == 1
    assert got["refused"][0] == "EngineOverloaded"
    res = got["results"]
    assert res["low"][:2] == ("AdmissionShed", "priority_evict")
    assert all(res[k][0] is None and res[k][2] for k in ("active", "mid", "high"))


# ---------------------------------------------------------- the replicas


def _jax_model(name, **kw):
    _, jcfg, params, _ = _weights()
    m = jeng.LMEngineModel(
        name, None, config=jcfg, max_batch=2, chunk_steps=2,
        buckets=BucketSpec(batch_sizes=(1,), seq_lens=(16,)),
        max_new_tokens=MAX_NEW, eos_id=EOS, watchdog=False, **PAGED, **kw,
    )
    m.load()
    m._params = jax.device_put(params)
    m.engine.stop()
    m.engine = m._make_engine().start()
    return m


def _torch_model(name, **kw):
    _, _, params, _ = _weights()
    kw = {**dict(max_new_tokens=MAX_NEW, prefill_buckets=(16,), max_batch=2,
                 chunk_steps=2, eos_id=EOS, watchdog=False, **PAGED), **kw}
    return teng.LMEngineModel(
        name, config=TransformerConfig(**KW),
        state_dict=params_to_state_dict(params), device="cpu", **kw,
    )


def _jax_calls(server, calls):
    """[(status, Retry-After, body text)] of ``calls`` through the JAX
    server; a call is ``(method, path, body, headers, before)``."""
    async def drive():
        out = []
        async with TestClient(TestServer(server.build_app())) as client:
            for method, path, body, headers, before in calls:
                if before is not None:
                    before()
                r = await client.request(method, path, json=body,
                                         headers=headers or {})
                out.append((r.status, r.headers.get("Retry-After"),
                            await r.text()))
        return out

    return asyncio.run(drive())


def _torch_call(server, method, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Retry-After"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read().decode()


def _torch_calls(server, calls):
    out = []
    for method, path, body, headers, before in calls:
        if before is not None:
            before()
        out.append(_torch_call(server, method, path, body, headers))
    return out


def _tokens(status, text):
    """token ids of a 200 predict, generate or SSE body."""
    if status != 200:
        return None
    if text.startswith("data:"):
        return [t for f in _frames(text) for t in f.get("token_ids", [])]
    body = json.loads(text)
    if "predictions" in body:
        return [p["token_ids"] for p in body["predictions"]]
    return body["token_ids"]


def _frames(text):
    return [json.loads(line[len("data: "):]) for line in text.split("\n")
            if line.startswith("data: ")]


def _both(calls_for, *, default_deadline_ms=None, name="lm"):
    """Run the same calls through a JAX and a torch replica; returns
    ``{side: ([(status, retry_after, text)], engine stats)}``."""
    jm = _jax_model(name)
    tm = _torch_model(name)
    jserv = jserver.ModelServer([jm], default_deadline_ms=default_deadline_ms)
    tserv = ModelServer([tm], http_port=0,
                        default_deadline_ms=default_deadline_ms).start()
    try:
        jres = _jax_calls(jserv, calls_for(jm))
        tres = _torch_calls(tserv, calls_for(tm))
        return {"jax": (jres, dict(jm.engine.stats)),
                "torch": (tres, dict(tm.engine.stats))}
    finally:
        tserv.stop()
        jm.unload()


def _gap(model, ms):
    return lambda: model.engine.overlap.__setitem__("decode_gap_ms", ms)


def test_server_maps_sre_errors_and_default_deadline():
    """An expired budget → 503 + Retry-After 1 (it was 200 before the
    port read the header); a roomy one → 200 with JAX's tokens; an
    admission shed → 503 + Retry-After; the SSE route refuses before a
    200."""
    row = {"instances": [{"input_ids": [3, 4, 5]}]}

    def calls(m):
        return [
            ("POST", "/v1/models/lm:predict", row, {DEADLINE_HEADER: "30000"}, None),
            ("POST", "/v1/models/lm:predict", row, {DEADLINE_HEADER: "0"}, None),
            ("POST", "/v1/models/lm:predict", row, {DEADLINE_HEADER: "-5"}, None),
            ("POST", "/v1/models/lm:predict", row, {DEADLINE_HEADER: "300"},
             _gap(m, 500.0)),
            ("POST", "/v2/models/lm/generate_stream", {"input_ids": [3, 4, 5]},
             {DEADLINE_HEADER: "0"}, _gap(m, 0.0)),
            ("POST", "/v2/models/lm/generate", {"input_ids": [3, 4, 5]},
             {DEADLINE_HEADER: "0"}, None),
            # a client's absolute stamp is another clock: stripped
            ("POST", "/v2/models/lm/generate", {"input_ids": [3, 4, 5]},
             {DEADLINE_HEADER: "30000", DEADLINE_ABS_HEADER: "1.0"}, None),
        ]

    out = _both(calls)
    (jres, jstats), (tres, tstats) = out["jax"], out["torch"]
    assert [r[:2] for r in tres] == [r[:2] for r in jres]
    assert [r[:2] for r in tres] == [
        (200, None), (503, "1"), (503, "1"), (503, "1"), (503, "1"),
        (503, "1"), (200, None)]
    assert "deadline" in tres[1][2].lower() and "deadline" in jres[1][2].lower()
    assert "unmeetable" in tres[3][2] and "unmeetable" in jres[3][2]
    assert [_tokens(r[0], r[2]) for r in tres] == [_tokens(r[0], r[2]) for r in jres]
    assert tstats["shed_deadline"] == jstats["shed_deadline"] == 1


def test_server_default_deadline_applies_when_header_absent():
    row = {"instances": [{"input_ids": [3, 4, 5]}]}

    def calls(m):
        return [
            ("POST", "/v1/models/lm:predict", row, None, _gap(m, 500.0)),
            ("POST", "/v1/models/lm:predict", row, {DEADLINE_HEADER: "60000"},
             _gap(m, 0.0)),
        ]

    out = _both(calls, default_deadline_ms=250.0)
    (jres, _), (tres, _) = out["jax"], out["torch"]
    assert [r[:2] for r in tres] == [r[:2] for r in jres] == [
        (503, "1"), (200, None)]
    assert _tokens(200, tres[1][2]) == _tokens(200, jres[1][2])


class _Raises(Model):
    def __init__(self, name, err):
        super().__init__(name)
        self.err = err

    def predict(self, inputs, headers=None):
        raise self.err


ERRORS = {
    "admission_shed": lambda m: m.AdmissionShed("x", retry_after_s=2.3),
    "deadline": lambda m: m.DeadlineExceeded("x", stage="queued"),
    "restarting": lambda m: m.EngineRestarting("x"),
    "overloaded": lambda m: m.EngineOverloaded("x"),
}


class _Ns:
    def __init__(self, dl, wd, eng):
        self.AdmissionShed, self.DeadlineExceeded = dl.AdmissionShed, dl.DeadlineExceeded
        self.EngineRestarting, self.EngineOverloaded = wd.EngineRestarting, eng.EngineOverloaded


@pytest.mark.parametrize("kind", sorted(ERRORS))
def test_error_statuses_match_jax_shed_response(kind):
    jexc = jserver._shed_response(ERRORS[kind](_Ns(jdl, jwd, jeng)))
    server = ModelServer([_Raises("m", ERRORS[kind](_Ns(tdl, twd, teng)))],
                         http_port=0).start()
    try:
        status, retry, _ = _torch_call(server, "POST", "/v2/models/m/generate",
                                       {"input_ids": [3]})
    finally:
        server.stop()
    assert (status, retry) == (jexc.status, jexc.headers.get("Retry-After"))
    assert {"admission_shed": (503, "3"), "deadline": (503, "1"),
            "restarting": (503, None), "overloaded": (429, None)}[kind] == (
        status, retry)


# ------------------------------------------------ the port's own surface


@pytest.fixture(scope="module")
def served():
    model = _torch_model("lm", paged_attn_impl="kernel")
    server = ModelServer([model], http_port=0).start()
    try:
        yield server, model
    finally:
        server.stop()


@pytest.mark.parametrize("header", [PREFILL_PEER_HEADER, SESSION_HEADER])
@pytest.mark.parametrize("route", ["generate", "generate_stream"])
def test_kv_movement_headers_are_honoured(served, header, route):
    """The disaggregation and session headers are served on both routes:
    a prefill peer (here the replica itself) ships the span, and a
    session without a host tier decodes as a plain request."""
    server, model = served
    eng = model.engine
    injected0 = eng.stats["kv_injected"]
    value = f"http://127.0.0.1:{server.port}" if header == PREFILL_PEER_HEADER \
        else "chat-1"
    plain = _torch_call(server, "POST", f"/v2/models/lm/{route}",
                        {"input_ids": [3, 4, 5]})
    status, _, text = _torch_call(server, "POST", f"/v2/models/lm/{route}",
                                  {"input_ids": [3, 4, 5]}, {header: value})
    assert status == plain[0] == 200
    assert _tokens(status, text) == _tokens(200, plain[2])
    assert eng.stats["kv_injected"] - injected0 == (header == PREFILL_PEER_HEADER)
    assert eng.stats["kv_ship_fallbacks"] == 0
    assert model._inflight == 0


def test_trace_header_is_accepted_and_ignored(served):
    server, _ = served
    plain = _torch_call(server, "POST", "/v2/models/lm/generate",
                        {"input_ids": [3, 4, 5]})
    traced = _torch_call(
        server, "POST", "/v2/models/lm/generate", {"input_ids": [3, 4, 5]},
        {TRACE_HEADER: "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01"})
    assert plain[0] == traced[0] == 200 and plain[2] == traced[2]


def test_routes_answer_like_jax(served):
    server, _ = served
    assert json.loads(_torch_call(server, "GET", "/")[2]) == {"status": "alive"}
    assert json.loads(_torch_call(server, "GET", "/v2/health/live")[2]) == {"live": True}
    assert json.loads(_torch_call(server, "GET", "/v1/models")[2]) == {"models": ["lm"]}
    assert json.loads(_torch_call(server, "GET", "/v1/models/lm")[2]) == {
        "name": "lm", "ready": True}
    assert json.loads(_torch_call(server, "GET", "/v2/models/lm")[2]) == {
        "name": "lm", "ready": True, "platform": "torch-cuda"}
    assert _torch_call(server, "GET", "/v2/models/nope")[0] == 404


def test_sse_frames_equal_jax_greedy_streams(served):
    server, _ = served
    prompts = _prompts(11, (5, 9, 14))
    with ThreadPoolExecutor(3) as ex:
        replies = list(ex.map(lambda p: _torch_call(
            server, "POST", "/v2/models/lm/generate_stream",
            {"input_ids": p}), prompts))
    want = _jax_greedy(prompts)
    for (status, _, text), w in zip(replies, want):
        frames = _frames(text)
        assert status == 200 and frames[-1] == {"done": True, "n_tokens": len(w)}
        assert all(f["token_ids"] for f in frames[:-1])  # no empty frames
        assert _tokens(status, text) == w


def _open_sse(server, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    conn.request("POST", "/v2/models/lm/generate_stream", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    assert resp.status == 200
    return conn, resp


def _next_frame(resp):
    while True:
        line = resp.readline().decode()
        if line.startswith("data: "):
            return json.loads(line[len("data: "):])
        assert line, "stream ended without a frame"


@pytest.mark.parametrize("depth", [0, 1])
def test_sse_resume_after_watchdog_restart_continues_the_stream(depth):
    """A stream wedged after its first frame: the watchdog trips, the
    stream ends with a resumable error frame, and the resend with the
    committed tokens gives the rest of the uninterrupted greedy stream."""
    model = _torch_model("lm", pipeline_depth=depth, eos_id=NEVER)
    server = ModelServer([model], http_port=0).start()
    now = [0.0]
    wd = twd.EngineWatchdog(lambda: model.engine, model.restart_engine,
                            on_ready=model._set_ready, clock=lambda: now[0],
                            config=twd.WatchdogConfig(min_wedge_s=5.0),
                            model_name="lm-sse")
    prompt = _prompts(5, (6,))[0]
    old = model.engine
    entered, release = _wedge(old)
    try:
        conn, resp = _open_sse(server, {"input_ids": prompt})
        committed = _next_frame(resp)["token_ids"]
        assert entered.wait(120)
        now[0] = old.heartbeat() + 10.0
        assert wd.tick() == "wedged"
        end = _next_frame(resp)
        assert end.get("resumable") is True and "error" in end
        conn.close()
        status, _, text = _torch_call(
            server, "POST", "/v2/models/lm/generate_stream",
            {"input_ids": prompt},
            {RESUME_TOKENS_HEADER: ",".join(map(str, committed))})
        rest = _tokens(status, text)
        # the uninterrupted stream, on the JAX engine
        eng = _engines(pipeline_depth=0, eos_id=NEVER)["jax"].start()
        try:
            want = eng.submit(prompt, max_new_tokens=MAX_NEW)
        finally:
            eng.stop()
        assert committed + rest == want and len(want) == MAX_NEW
        assert wd.stats == {"trips": {"wedged": 1}, "restarts": 1}
        assert server.total_inflight() == 0
    finally:
        release.set()
        server.stop()


def test_sse_disconnect_frees_the_row():
    """A client that walks away mid-stream: the next frame write fails,
    the iterator is closed, and the engine frees the row and its pages at
    the next chunk boundary, long before the budget would."""
    model = _torch_model("lm", eos_id=NEVER, max_new_tokens=40, max_seq=64)
    server = ModelServer([model], http_port=0).start()
    eng = model.engine
    gate, free = threading.Semaphore(0), threading.Event()
    seen: list = []

    def hook(e):  # one chunk per gate release
        if not seen:
            seen.extend(r for r in e._slots if r is not None)
        if not free.is_set():
            gate.acquire(timeout=60)

    eng._fault_hooks["pre_chunk"] = hook
    try:
        conn, resp = _open_sse(server, {"input_ids": [3, 4, 5, 6]})
        assert _next_frame(resp)["token_ids"]
        conn.close()  # the client goes away
        for _ in range(30):
            gate.release()
            if seen and seen[0].done.wait(1.0):
                break
        req = seen[0]
        assert req.done.is_set() and req.cancelled.is_set()
        assert 1 <= len(req.tokens) < 40
        assert eng.pager.used_pages == 0 and not eng.active.any()
    finally:
        free.set()
        for _ in range(100):
            gate.release()
        server.stop()
    assert server.total_inflight() == 0


# ------------------------------------------------------------------ metrics


def _scrape(text):
    """``{series: value}`` of an exposition (comments dropped)."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def _family(series):
    name = series.split("{")[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.startswith(("kft_server_ttft_ms", "kft_server_tpot_ms")) and \
                name.endswith(suffix):
            return name[: -len(suffix)]
    return name


#: JAX /metrics lines of features the port has not ported (none since
#: the KV transfer and the host tier were)
NOT_PORTED: set[str] = set()

#: series whose values are fixed by the request sequence alone
DETERMINISTIC = [
    'kubeflow_tpu_requests_total{model="lm-metrics"}',
    'kft_server_inflight{model="lm-metrics"}',
    'kft_engine_paged_attn_kernel{model="lm-metrics"}',
    'kubeflow_tpu_engine_active_rows{model="lm-metrics"}',
    'kft_engine_prefix_hits_total{model="lm-metrics"}',
    'kft_engine_spec_proposed_total{model="lm-metrics"}',
    'kft_engine_kv_quant_error{model="lm-metrics"}',
    'kft_server_ttft_ms_count{model="lm-metrics"}',
    'kft_server_tpot_ms_count{model="lm-metrics"}',
    *(f'kubeflow_tpu_engine_{k}{{model="lm-metrics"}}' for k in (
        "admitted", "completed", "chunks", "max_concurrent", "prefix_hits",
        "prefill_pieces", "spec_proposed", "spec_accepted",
        "deadline_expired_queued", "deadline_expired_decoding",
        "shed_deadline", "shed_priority", "resume_admits",
        "kv_pages_used_peak", "kv_page_size", "kv_pages_total",
        "kv_pages_used", "kv_rows_resident")),
]


def test_metrics_exposition_matches_jax_server():
    prompts = _prompts(21, (4, 7, 12))
    row = lambda p: {"input_ids": p, "max_new_tokens": 5}  # noqa: E731

    def calls(m):
        seq = [("POST", "/v2/models/lm-metrics/generate", row(p), None, None)
               for p in prompts]
        seq.append(("POST", "/v1/models/lm-metrics:predict",
                    {"instances": [row(prompts[0])]}, None, None))
        return seq + [("GET", "/metrics", None, None, None)]

    jm = _jax_model("lm-metrics", kv_quant="int8", pipeline_depth=0)
    tm = _torch_model("lm-metrics", kv_quant="int8", pipeline_depth=0)
    jserv = jserver.ModelServer([jm])
    tserv = ModelServer([tm], http_port=0).start()
    try:
        jres = _jax_calls(jserv, calls(jm))
        tres = _torch_calls(tserv, calls(tm))
    finally:
        tserv.stop()
        jm.unload()
    assert [r[0] for r in tres] == [r[0] for r in jres] == [200] * 5
    assert [_tokens(200, r[2]) for r in tres[:4]] == [
        _tokens(200, r[2]) for r in jres[:4]]
    jx, tx = _scrape(jres[-1][2]), _scrape(tres[-1][2])
    jfam = {_family(s) for s in jx if "lm-metrics" in s}
    tfam = {_family(s) for s in tx if "lm-metrics" in s}
    assert jfam - NOT_PORTED <= tfam, sorted(jfam - NOT_PORTED - tfam)
    for series in DETERMINISTIC:
        assert series in tx and series in jx, series
        assert tx[series] == pytest.approx(jx[series], rel=1e-5, abs=1e-6), series
    assert tx['kubeflow_tpu_requests_total{model="lm-metrics"}'] == 4
    assert tx['kft_server_ttft_ms_count{model="lm-metrics"}'] == 4
    assert tx['kft_engine_kv_quant_error{model="lm-metrics"}'] > 0


# -------------------------------------------------------- kv_quant_error


def _quant_prompts(kind):
    if kind == "bucketed":
        return _prompts(4, (6, 11, 16, 9))
    # a 32-token shared prefix: the third prompt hits the second's entry
    # and prefills only its 4-token suffix at offset 32
    shared = _prompts(3, (32,))[0]
    tails = _prompts(4, (5, 9, 4, 11))
    return [tails[0], shared + tails[1], shared + tails[2], tails[3]]


@pytest.mark.parametrize("kind,kw", [
    ("bucketed", dict()),
    ("chunked_prefix", dict(prefill_chunk=16, prefix_cache_entries=4,
                            prefill_buckets=(16, 48), max_seq=64)),
], ids=["bucketed", "chunked_prefix"])
def test_kv_quant_error_matches_jax_ewma(kind, kw):
    prompts = _quant_prompts(kind)
    got = {}
    for side, eng in _engines(kv_quant="int8", pipeline_depth=0, **kw).items():
        eng.start()
        try:
            assert eng.overlap["kv_quant_error"] == 0.0  # pre-initialized
            for p in prompts:
                eng.submit(p, max_new_tokens=4)
            got[side] = (eng.overlap["kv_quant_error"],
                         eng.stats["prefill_pieces"], eng.stats["prefix_hits"])
        finally:
            eng.stop()
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][2] == (1 if kind == "chunked_prefix" else 0)
    assert 0 < got["torch"][0] < 0.05
    assert got["torch"][0] == pytest.approx(got["jax"][0], rel=1e-5)
    for eng in _engines().values():  # only the int8 pool keeps the gauge
        assert "kv_quant_error" not in eng.overlap


def test_decode_chunks_do_not_measure_quant_error():
    eng = _engines(kv_quant="int8", pipeline_depth=0)["torch"].start()
    try:
        eng.submit([3, 4, 5], max_new_tokens=2)
        after_prefill = eng.overlap["kv_quant_error"]
        calls = []
        real = eng.model.forward

        def spy(*a, **k):
            calls.append(k.get("quant_stats"))
            return real(*a, **k)

        eng.model.forward = spy
        try:
            eng.submit([3, 4, 5], max_new_tokens=12)
        finally:
            del eng.model.forward
    finally:
        eng.stop()
    assert after_prefill > 0
    # one prefill with a list, then every decode step with None
    assert isinstance(calls[0], list) and len(calls) > 1
    assert all(c is None for c in calls[1:])


# ------------------------------------------------------- warmup, latency


def test_warmup_zeroes_metrics_and_keeps_the_streams():
    model = _torch_model("lm-warm", spec_draft_tokens=2, prefix_cache_entries=4,
                         prefill_buckets=(16, 32))
    model.load()
    try:
        eng = model.engine
        ttft0 = _counter(teng.TTFT_MS, model="lm-warm")
        report = model.warmup()
        assert report == model.warmup_report and report["libraries"] == []
        assert report["seconds"] > 0
        assert all(v == 0 for v in eng.stats.values())
        assert all(v == 0 for v in eng.overlap.values())
        assert isinstance(eng.overlap["carry_uploads"], int)
        assert not eng.ttft_ms and eng.prefix_cache_stats()["entries"] == 0
        assert _counter(teng.TTFT_MS, model="lm-warm") == ttft0
        prompts = _prompts(8, (5, 10))
        got = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    finally:
        model.unload()
    assert got == _jax_greedy(prompts)


def _hist_count(metric, label):
    child = metric._children.get((("model", label),))
    return child.count if child else 0


def test_ttft_tpot_recorded_for_served_requests_only(served):
    server, model = served
    t0, p0 = _hist_count(teng.TTFT_MS, "lm"), _hist_count(teng.TPOT_MS, "lm")
    model.engine.submit([3, 4, 5], max_new_tokens=4)  # direct: no label
    assert _hist_count(teng.TTFT_MS, "lm") == t0
    status, _, text = _torch_call(server, "POST", "/v2/models/lm/generate",
                                  {"input_ids": [3, 4, 5], "max_new_tokens": 4})
    n = len(_tokens(status, text))
    assert _hist_count(teng.TTFT_MS, "lm") == t0 + 1
    assert _hist_count(teng.TPOT_MS, "lm") == p0 + (1 if n >= 2 else 0)
    assert "kft_server_ttft_ms_bucket" in prom.REGISTRY.expose()


def test_graceful_drain_flips_readiness_first():
    model = _torch_model("lm-drain")
    server = ModelServer([model], http_port=0, drain_grace_s=30.0).start()
    gate = threading.Event()
    model.engine._fault_hooks["pre_chunk"] = lambda e: gate.wait(60)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", _torch_call(
        server, "POST", "/v2/models/lm-drain/generate", {"input_ids": [3, 4]})))
    t.start()
    stopper = threading.Thread(target=server.stop)
    try:
        while server.total_inflight() == 0:
            threading.Event().wait(0.01)
        stopper.start()
        while not server._draining:
            threading.Event().wait(0.01)
        status, _, text = _torch_call(server, "GET", "/v2/health/ready")
        assert status == 503 and json.loads(text)["draining"] is True
    finally:
        gate.set()
        t.join(60)
        stopper.join(60)
    assert out["r"][0] == 200 and not stopper.is_alive()
