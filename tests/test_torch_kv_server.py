"""KV movement between replicas over HTTP: ``kubeflow_tpu_torch``'s stdlib
``ModelServer`` against the JAX aiohttp replica, on the CPU.

A torch decode replica handed ``x-kft-prefill-peer`` pulls each row's
span from a prefill replica (``kv_span:prefill``) on ``generate`` and
``generate_stream``, a resumed stream included, and runs zero prefill
pieces for the same tokens a colocated replica gives. The peer may be
the other framework's replica in either direction: a torch decode
replica pulls from a JAX prefill replica, and a JAX decode replica from
a torch one. The prefix-cache routes (index, export, pull) move entries
torch to torch and JAX to torch; a dead peer answers 502 and a model
without a prefix cache 501. ``role`` is validated and reported by
readiness as the JAX replica reports it, and ``x-kft-session`` parks a
session's KV in the host tier between two turns.

Weights are the JAX init bridged into the port (f32, 2 layers, d_model
64, GQA 4/2 heads, vocab 97, 16-token pages). Every server binds port 0
and is stopped in a ``finally`` or a fixture's teardown.
"""

from __future__ import annotations

import asyncio
import functools
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve import engine as jeng
from kubeflow_tpu.serve import server as jserver
from kubeflow_tpu.serve.model import BucketSpec
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.serve import engine as teng
from kubeflow_tpu_torch.serve.headers import (
    PREFILL_PEER_HEADER,
    RESUME_TOKENS_HEADER,
    SEED_HEADER,
    SESSION_HEADER,
)
from kubeflow_tpu_torch.serve.kv_codec import decode_kv_entries
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
BUCKETS = (16, 32)
PAGED = dict(kv_pool_tokens=16 * 16, page_size=16)
MAX_NEW = 8
COMMON = dict(max_batch=2, chunk_steps=2, max_new_tokens=MAX_NEW, eos_id=1,
              watchdog=False, **PAGED)
DEAD_PEER = "http://127.0.0.1:1"


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = JaxConfig(**KW, attn_impl="reference", dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jcfg, jax.tree_util.tree_map(np.asarray, params["params"])


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, KW["vocab_size"], size=n)]
            for n in lengths]


PROMPTS = _prompts(5, (5, 12, 20, 27))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models stepped by many engine and client threads: one
    intra-op thread each keeps the module from oversubscribing the CPU
    that concurrent test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _torch_model(name="lm", **kw):
    _, params = _weights()
    return teng.LMEngineModel(
        name, config=TransformerConfig(**KW),
        state_dict=params_to_state_dict(params), device="cpu",
        prefill_buckets=BUCKETS, **{**COMMON, **kw},
    )


def _jax_model(name="lm", **kw):
    jcfg, params = _weights()
    m = jeng.LMEngineModel(
        name, None, config=jcfg,
        buckets=BucketSpec(batch_sizes=(1,), seq_lens=BUCKETS),
        **{**COMMON, **kw},
    )
    m.load()
    m._params = jax.device_put(params)
    m.engine.stop()
    m.engine = m._make_engine().start()
    return m


class _JaxReplica:
    """A JAX ``ModelServer`` on an ephemeral port, its event loop on a
    thread of its own, so that urllib peers reach it."""

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
        self.url = f"http://127.0.0.1:{self.port}"

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


@pytest.fixture(scope="module")
def jax_replica():
    """One JAX replica for the module (prefix cache on): a prefill peer, a
    decode replica and a prefix-cache exporter in turn."""
    rep = _JaxReplica([_jax_model(prefix_cache_entries=8)])
    try:
        yield rep
    finally:
        rep.close()


def _call(port, method, path, body=None, headers=None):
    """``(status, body bytes)``; header names are sent exactly as given
    (the JAX replica matches lower-case or title-case names only)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _tokens(status, raw):
    assert status == 200, raw
    text = raw.decode()
    if text.startswith("data:"):
        frames = [json.loads(ln[len("data: "):]) for ln in text.split("\n")
                  if ln.startswith("data: ")]
        assert frames[-1].get("done") is True, frames[-1]
        return [t for f in frames for t in f.get("token_ids", [])]
    return json.loads(text)["token_ids"]


def _generate(port, ids, headers=None, route="generate", **row):
    return _tokens(*_call(port, "POST", f"/v2/models/lm/{route}",
                          {"input_ids": ids, **row}, headers))


def _servers(*specs):
    """Started torch servers, one per ``(role, model kwargs)``."""
    return [ModelServer([_torch_model(**kw)], http_port=0, role=role).start()
            for role, kw in specs]


def _stop(*servers):
    for s in servers:
        s.stop()


def _engine(server):
    return server.models["lm"].engine


# ------------------------------------------------------------------ role


def test_role_validated_and_reported_as_jax():
    async def jax_ready(role):
        async with TestClient(TestServer(
                jserver.ModelServer([], role=role).build_app())) as client:
            r = await client.get("/v2/health/ready")
            return r.status, await r.json()

    for role in ("both", "prefill", "decode"):
        server = ModelServer([], http_port=0, role=role).start()
        try:
            status, raw = _call(server.port, "GET", "/v2/health/ready")
        finally:
            server.stop()
        assert (status, json.loads(raw)) == asyncio.run(jax_ready(role))
        assert json.loads(raw)["role"] == role
    for cls in (ModelServer, jserver.ModelServer):
        with pytest.raises(ValueError, match="role"):
            cls([], role="router")


# ------------------------------------------------- disaggregated serving


def test_disagg_torch_pair_generate_stream_and_resume():
    pre, dec = _servers(("prefill", {}), ("decode", {}))
    peer = {PREFILL_PEER_HEADER: f"http://127.0.0.1:{pre.port}"}
    try:
        got = [_generate(dec.port, p, peer) for p in PROMPTS]
        streamed = [_generate(dec.port, p, peer, route="generate_stream")
                    for p in PROMPTS]
        seeded = _generate(dec.port, PROMPTS[2], {**peer, SEED_HEADER: "77"},
                           temperature=0.9)
        # a resumed stream with a peer: the span covers prompt + committed
        resumed = _generate(dec.port, PROMPTS[3],
                            {**peer, RESUME_TOKENS_HEADER: ",".join(
                                map(str, got[3][:3]))},
                            route="generate_stream")
        dstats, pstats = dict(_engine(dec).stats), dict(_engine(pre).stats)
        _, metrics = _call(dec.port, "GET", "/metrics")
        # the reference: the prefill replica serving colocated, afterwards
        want = [_generate(pre.port, p) for p in PROMPTS]
        want_seeded = _generate(pre.port, PROMPTS[2], {SEED_HEADER: "77"},
                                temperature=0.9)
    finally:
        _stop(pre, dec)
    n = 2 * len(PROMPTS) + 2
    assert got == streamed == want and seeded == want_seeded
    assert resumed == want[3][3:]
    assert dstats["prefill_pieces"] == 0, dstats
    assert dstats["kv_injected"] == dstats["admitted"] == n
    assert dstats["kv_ship_fallbacks"] == 0 and dstats["kv_ship_bytes"] > 0
    assert dstats["resume_admits"] == 1
    assert pstats["kv_spans_exported"] == n and pstats["chunks"] == 0
    text = metrics.decode()
    assert 'kubeflow_tpu_engine_kv_injected{model="lm"} %d' % n in text
    assert 'kft_engine_kv_ship_bytes_total{direction="import",model="lm"}' in text
    assert "kft_engine_kv_ship_ms_count" in text


def test_dead_peer_falls_back_to_local_prefill():
    (dec,) = _servers(("decode", {}))
    try:
        got = _generate(dec.port, PROMPTS[1], {PREFILL_PEER_HEADER: DEAD_PEER})
        want = _generate(dec.port, PROMPTS[1])
        stats = dict(_engine(dec).stats)
    finally:
        _stop(dec)
    assert got == want
    assert stats["kv_ship_fallbacks"] == 1 and stats["kv_injected"] == 0


def test_torch_decode_pulls_from_jax_prefill_replica(jax_replica):
    (dec,) = _servers(("decode", {}))
    jstats = jax_replica.models[0].engine.stats
    exported0 = jstats["kv_spans_exported"]
    try:
        got = [_generate(dec.port, p, {PREFILL_PEER_HEADER: jax_replica.url})
               for p in PROMPTS]
        stats = dict(_engine(dec).stats)
    finally:
        _stop(dec)
    want = [_generate(jax_replica.port, p) for p in PROMPTS]
    assert got == want
    assert stats["prefill_pieces"] == 0 and stats["kv_injected"] == len(PROMPTS)
    assert stats["kv_ship_fallbacks"] == 0
    assert jstats["kv_spans_exported"] - exported0 == len(PROMPTS)


def test_jax_decode_pulls_from_torch_prefill_replica(jax_replica):
    (pre,) = _servers(("prefill", {}))
    jstats = jax_replica.models[0].engine.stats
    before = {k: jstats[k] for k in ("prefill_pieces", "kv_injected",
                                     "kv_ship_fallbacks")}
    peer = {PREFILL_PEER_HEADER: f"http://127.0.0.1:{pre.port}"}
    try:
        got = [_generate(jax_replica.port, p, peer) for p in PROMPTS]
        want = [_generate(pre.port, p) for p in PROMPTS]
        exported = _engine(pre).stats["kv_spans_exported"]
    finally:
        _stop(pre)
    assert got == want
    assert {k: jstats[k] - v for k, v in before.items()} == {
        "prefill_pieces": 0, "kv_injected": len(PROMPTS), "kv_ship_fallbacks": 0}
    assert exported == len(PROMPTS)


# ------------------------------------------------------- prefix transfer


SHARED = _prompts(9, (16,))[0]
PREFIXED = [SHARED + t for t in _prompts(10, (4, 9, 13))]


def test_prefix_cache_index_export_pull_torch_pair():
    a, b = _servers(("both", dict(prefix_cache_entries=8)),
                    ("both", dict(prefix_cache_entries=8)))
    try:
        want = [_generate(a.port, p) for p in PREFIXED]
        status, raw = _call(a.port, "GET", "/v2/models/lm/prefix_cache")
        index = json.loads(raw)
        status_x, blob = _call(a.port, "POST", "/v2/models/lm/prefix_cache:export",
                               {"limit": 1})
        status_p, pulled = _call(b.port, "POST", "/v2/models/lm/prefix_cache:pull",
                                 {"peer": f"http://127.0.0.1:{a.port}",
                                  "keys": index["keys"]})
        got = [_generate(b.port, p) for p in PREFIXED]
        bstats = _engine(b).prefix_cache_stats()
        astats = _engine(a).prefix_cache_stats()
    finally:
        _stop(a, b)
    assert status == status_x == status_p == 200
    assert index == {"keys": [SHARED], "count": 1, "tokens": 16}
    entries, meta = decode_kv_entries(blob)
    assert [list(k) for k, _ in entries] == [SHARED] and meta is None
    assert json.loads(pulled) == {"imported": 1,
                                  "peer": f"http://127.0.0.1:{a.port}"}
    assert got == want
    assert bstats["hits"] == len(PREFIXED) and bstats["imported"] == 1
    assert astats["exported"] == 2


def test_prefix_pull_from_jax_replica(jax_replica):
    jeng_ = jax_replica.models[0].engine
    jeng_.drop_prefix_cache()
    (b,) = _servers(("both", dict(prefix_cache_entries=8)))
    try:
        want = [_generate(jax_replica.port, p) for p in PREFIXED]
        status, raw = _call(b.port, "POST", "/v2/models/lm/prefix_cache:pull",
                            {"peer": jax_replica.url})
        got = [_generate(b.port, p) for p in PREFIXED]
        stats = _engine(b).prefix_cache_stats()
    finally:
        _stop(b)
    assert status == 200 and json.loads(raw)["imported"] == 1
    assert got == want
    assert stats["hits"] == len(PREFIXED) and stats["imported"] == 1


class _Plain(Model):
    """A model without an engine."""

    def load(self):
        self.ready = True
        return True

    def predict(self, rows, headers=None):
        return rows


def test_kv_route_errors():
    server = ModelServer([_torch_model(), _Plain("plain")], http_port=0).start()
    try:
        got = {
            "index_no_cache": _call(server.port, "GET", "/v2/models/lm/prefix_cache"),
            "export_no_cache": _call(server.port, "POST",
                                     "/v2/models/lm/prefix_cache:export", {}),
            "pull_no_cache": _call(server.port, "POST",
                                   "/v2/models/lm/prefix_cache:pull",
                                   {"peer": DEAD_PEER}),
            "span_no_engine": _call(server.port, "POST",
                                    "/v2/models/plain/kv_span:prefill", {"ids": [3]}),
            "span_bad_body": _call(server.port, "POST", "/v2/models/lm/kv_span:prefill",
                                   {"ids": "x"}),
            "span_empty": _call(server.port, "POST", "/v2/models/lm/kv_span:prefill",
                                {"ids": []}),
            "span_unknown_model": _call(server.port, "POST",
                                        "/v2/models/nope/kv_span:prefill", {"ids": [3]}),
        }
    finally:
        server.stop()
    cached = ModelServer([_torch_model(prefix_cache_entries=4)], http_port=0).start()
    try:
        got["pull_dead_peer"] = _call(cached.port, "POST",
                                      "/v2/models/lm/prefix_cache:pull",
                                      {"peer": DEAD_PEER})
        got["pull_no_peer"] = _call(cached.port, "POST",
                                    "/v2/models/lm/prefix_cache:pull", {})
    finally:
        cached.stop()
    assert {k: v[0] for k, v in got.items()} == {
        "index_no_cache": 501, "export_no_cache": 501, "pull_no_cache": 501,
        "span_no_engine": 501, "span_bad_body": 400, "span_empty": 400,
        "span_unknown_model": 404, "pull_dead_peer": 502, "pull_no_peer": 400}
    assert b"unreachable" in got["pull_dead_peer"][1]


# -------------------------------------------------------------- sessions


def test_sessions_over_http_swap_through_the_host_tier():
    first = PROMPTS[2]
    (ref,) = _servers(("both", {}))
    try:
        t1 = _generate(ref.port, first)
        turn2 = first + t1 + [7, 8]
        want = _generate(ref.port, turn2)
    finally:
        _stop(ref)
    (srv,) = _servers(("both", dict(host_kv_bytes=1 << 20)))
    session = {SESSION_HEADER: "chat-1"}
    eng = _engine(srv)
    try:
        got1 = _generate(srv.port, first, session)
        assert eng.flush_offload()
        _, metrics = _call(srv.port, "GET", "/metrics")
        got2 = _generate(srv.port, turn2, session, route="generate_stream")
        stats = dict(eng.stats)
    finally:
        _stop(srv)
    assert (got1, got2) == (t1, want)
    assert stats["kv_offload_in"] == 1 and stats["kv_offload_out"] >= 1
    text = metrics.decode()
    assert 'kft_engine_kv_offload_resident_rows{model="lm"} 1' in text
    assert 'kft_engine_kv_offload_bytes{model="lm"}' in text
