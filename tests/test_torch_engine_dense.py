"""The port's DENSE ``LMEngine`` (``kv_pool_tokens=None``, the JAX
default) against the JAX dense ``LMEngine``: the sequence of
``tests/test_engine.py``, at a small size (2 layers, d_model 32, 4 heads,
f32) on bridged weights, greedy unless a case samples with a seed.

Every case must give the JAX engine's token streams, at
``pipeline_depth`` 1 and 0: batch parity with ``make_generate_fn``,
staggered concurrency through few rows, EOS freeing a row, budget
gating, the prefix cache with its ``max_seq`` fallback, chunked prefill
across the bucket gap, GQA and a sliding window, K=4 speculative
decoding, seeded sampling and resume. Then KV movement in dense mode:
spans implanted across frameworks both ways, a paged prefill replica
feeding a dense decode replica over HTTP (no prefill piece on the decode
side), prefix entries moved between engines, and the prompt-only swap of
a dense row through the host tier.
"""

from __future__ import annotations

import functools
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.serve.engine import LMEngine, LMEngineModel
from kubeflow_tpu_torch.serve.generate import make_generate_fn
from kubeflow_tpu_torch.serve.headers import PREFILL_PEER_HEADER
from kubeflow_tpu_torch.serve.server import ModelServer
from kubeflow_tpu_torch.serve.threefry import prng_key

KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64)
EOS = 1
BASE = dict(max_batch=2, max_seq=64, chunk_steps=4, prefill_buckets=(16, 32),
            eos_id=EOS)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models stepped by engine and client threads: one intra-op
    thread each keeps the module from oversubscribing a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(over=()):
    kw = {**KW, **dict(over)}
    jmodel = JaxLM(JaxConfig(**kw, attn_impl="reference", dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = TransformerLM(TransformerConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(params))
    return jmodel, params, tmodel.eval().requires_grad_(False)


def _prompts(seed, lengths, vocab=KW["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, size=n)] for n in lengths]


def _motifs(seed, lengths):
    """Prompts repeating a 6-token motif, so K=4 prompt lookup drafts."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        motif = [int(t) for t in rng.integers(2, KW["vocab_size"], size=6)]
        out.append((motif * 16)[:n])
    return out


def _run(eng, waves):
    """Each wave's requests at once (rows churn), waves in order; returns
    the streams in request order and the engine's stats."""
    eng.start()
    try:
        out = []
        for wave in waves:
            with ThreadPoolExecutor(len(wave)) as ex:
                futs = [ex.submit(eng.submit, ids, **kw) for ids, kw in wave]
                out.extend(f.result() for f in futs)
        return out, dict(eng.stats)
    finally:
        eng.stop()


def _wave(prompts, max_new, **kw):
    return [(p, dict(max_new_tokens=max_new, **kw)) for p in prompts]


def SEQ(prompts, max_new, **kw):
    """One request a wave: each prefill completes before the next."""
    return [[r] for r in _wave(prompts, max_new, **kw)]


SCENARIOS = {
    # name: (model overrides, engine overrides, waves, stats that must agree)
    "staggered": ((), dict(max_batch=3, chunk_steps=2),
                  [_wave(_prompts(1, (5, 14, 3, 19, 9, 12, 7)), 16)],
                  ("admitted", "completed")),
    "budget_gating": ((), dict(chunk_steps=8),
                      [[(p, dict(max_new_tokens=n)) for p, n in
                        zip(_prompts(2, (4, 9, 15)), (3, 1, 7))]], ()),
    "prefix_cache": ((), dict(max_seq=96, prefill_buckets=(32,),
                              prefix_cache_entries=4),
                     SEQ([p[:16] + t for p, t in zip(
                         _prompts(11, (20,)) * 4,
                         [[], *_prompts(12, (5, 3, 9))])], 10),
                     ("prefix_hits", "prefix_tokens_reused", "prefill_pieces")),
    "prefix_max_seq_fallback": ((), dict(max_batch=1, max_seq=40,
                                         prefill_buckets=(20,),
                                         prefix_cache_entries=2),
                                [_wave(_prompts(17, (18,)), 4),
                                 _wave([_prompts(17, (18,))[0][:16] + [3, 4]], 10)],
                                ("prefix_hits",)),
    "chunked_prefill": ((), dict(max_seq=112, prefill_buckets=(64,),
                                 prefill_chunk=16),
                        [_wave(_prompts(5, (37, 6, 50, 20)), 12)],
                        ("prefill_pieces",)),
    "chunked_prefix": ((), dict(max_seq=112, prefill_buckets=(64,),
                                prefill_chunk=16, prefix_cache_entries=4),
                       SEQ([p[:32] + t for p, t in zip(
                           _prompts(6, (40,)) * 3,
                           [[5, 6, 7, 8, 9, 10, 11, 12], *_prompts(7, (21, 4))])], 10),
                       ("prefix_hits", "prefill_pieces")),
    "gqa": ((("n_kv_heads", 2),), dict(max_batch=3),
            [_wave(_prompts(8, (7, 30, 16, 3)), 14)], ()),
    "window": ((("attn_window", 5),), dict(),
               [_wave(_prompts(9, (4, 22, 31)), 24)], ()),
    "gqa_window_chunked": ((("n_kv_heads", 1), ("attn_window", 7)),
                           dict(max_seq=96, prefill_buckets=(48,),
                                prefill_chunk=16),
                           [_wave(_prompts(10, (45, 17)), 20)],
                           ("prefill_pieces",)),
    "spec_k4": ((), dict(max_seq=72, spec_draft_tokens=4, spec_ngram=3),
                [_wave(_motifs(3, (20, 27, 12)), 16)],
                ("spec_proposed", "spec_accepted")),
    "spec_k4_gqa_window": ((("n_kv_heads", 2), ("attn_window", 6)),
                           dict(max_seq=72, spec_draft_tokens=4),
                           [_wave(_motifs(9, (18, 31)), 16)],
                           ("spec_accepted",)),
    "seeded_sampling": ((), dict(max_batch=3),
                        [[(p, dict(max_new_tokens=12, temperature=0.9,
                                   seed=100 + i))
                          for i, p in enumerate(_prompts(13, (6, 19, 11, 25)))]],
                        ()),
}


@functools.lru_cache(maxsize=None)
def _jax_streams(name):
    over, eng_kw, waves, _ = SCENARIOS[name]
    jmodel, params, _ = _models(over)
    return _run(JaxEngine(jmodel, jmodel.cfg, params, **{**BASE, **eng_kw}), waves)


@pytest.mark.parametrize("depth", [1, 0])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dense_engine_matches_jax(name, depth):
    over, eng_kw, waves, keys = SCENARIOS[name]
    want, jstats = _jax_streams(name)
    eng = LMEngine(_models(over)[2], **{**BASE, **eng_kw, "pipeline_depth": depth})
    assert eng.pager is None
    got, stats = _run(eng, waves)
    assert got == want
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    if name.startswith("prefix_cache") or name == "chunked_prefix":
        assert stats["prefix_hits"] > 0
    if name == "prefix_max_seq_fallback":
        assert stats["prefix_hits"] == 0  # the padded layout cannot fit
    if name.startswith("spec"):
        assert stats["spec_accepted"] > 0
    if name.startswith("chunked"):
        assert stats["prefill_pieces"] > len(want)


def test_dense_engine_matches_make_generate_fn():
    """The engine against the whole-batch path it must equal (JAX
    ``test_engine_matches_batch_generate_exactly``), batch 1, bucket 32."""
    _, _, tmodel = _models()
    gen = make_generate_fn(tmodel, max_new_tokens=12, eos_id=EOS)
    prompts = _prompts(0, (3, 17, 9, 30, 12, 5))
    got, _ = _run(LMEngine(tmodel, **{**BASE, "max_batch": 4}),
                  SEQ(prompts, 12))
    for ids, g in zip(prompts, got):
        prompt = torch.zeros((1, 32), dtype=torch.int64)
        prompt[0, :len(ids)] = torch.tensor(ids)
        toks, n = gen(prompt, torch.tensor([len(ids)]), prng_key(torch.tensor(7)),
                      torch.zeros(1))
        assert g == toks[0, :int(n[0])].tolist()
    assert got == _run(JaxEngine(_models()[0], _models()[0].cfg, _models()[1],
                                 **{**BASE, "max_batch": 4}), SEQ(prompts, 12))[0]


def test_eos_frees_a_row_early():
    """EOS set to a token one prompt emits third: that row retires after
    at most two tokens while its neighbours keep decoding; both engines
    agree."""
    _, _, tmodel = _models()
    prompts = _prompts(14, (8, 21, 13))
    free, _ = _run(LMEngine(tmodel, **BASE), SEQ(prompts, 16))
    row = next(i for i, f in enumerate(free) if len(f) >= 3)
    eos = free[row][2]
    kw = {**BASE, "eos_id": eos, "max_batch": 2}
    want, _ = _run(JaxEngine(_models()[0], _models()[0].cfg, _models()[1], **kw),
                   [_wave(prompts, 16)])
    for depth in (1, 0):
        got, stats = _run(LMEngine(tmodel, **kw, pipeline_depth=depth),
                          [_wave(prompts, 16)])
        assert got == want and len(got[row]) <= 2 and eos not in got[row]
        assert stats["completed"] == 3


def test_resume_continues_greedy_and_seeded_streams():
    """A stream cut in half and resumed with ``resume_tokens`` gives its
    other half, greedy and seeded, as in JAX."""
    jmodel, params, tmodel = _models()
    ids = _prompts(15, (14,))[0]
    jeng = JaxEngine(jmodel, jmodel.cfg, params, **BASE).start()
    eng = LMEngine(tmodel, **BASE).start()
    try:
        for samp in ({}, dict(temperature=0.9, seed=77)):
            full = eng.submit(ids, max_new_tokens=14, **samp)
            assert full == jeng.submit(ids, max_new_tokens=14, **samp)
            rest = eng.submit(ids, max_new_tokens=14, resume_tokens=full[:6],
                              **samp)
            assert rest == full[6:] == jeng.submit(
                ids, max_new_tokens=14, resume_tokens=full[:6], **samp)
        assert eng.stats["resume_admits"] == 2
    finally:
        jeng.stop()
        eng.stop()


def test_dense_spec_headroom_check_matches_jax():
    """Dense speculative rows reserve K slots: a layout that fits without
    them is refused, with JAX's message."""
    jmodel, params, tmodel = _models()
    kw = {**BASE, "spec_draft_tokens": 4}
    for eng in (LMEngine(tmodel, **kw), JaxEngine(jmodel, jmodel.cfg, params, **kw)):
        with pytest.raises(ValueError, match="reserves K"):
            eng._enqueue([3] * 20, 30, 0.0, live=False,
                         deadline=time.monotonic() + 30)
        with pytest.raises(ValueError, match="max_seq"):
            eng._enqueue([3] * 20, 40, 0.0, live=False,
                         deadline=time.monotonic() + 30)


# ------------------------------------------------------ KV movement


PAGED = dict(kv_pool_tokens=16 * 24, page_size=16)
SPAN_PROMPTS = _prompts(20, (20, 27, 9))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_dense_span_crosses_frameworks(direction):
    """A dense prefill span made by one framework's engine implants in the
    other's dense engine: zero prefill pieces there, the colocated
    tokens, greedy and seeded."""
    jmodel, params, tmodel = _models()
    jax_eng = lambda: JaxEngine(jmodel, jmodel.cfg, params, **BASE)  # noqa: E731
    torch_eng = lambda: LMEngine(tmodel, **BASE)  # noqa: E731
    pre, dec = ((jax_eng(), torch_eng()) if direction == "jax_to_torch"
                else (torch_eng(), jax_eng()))
    pre.start()
    try:
        spans = [dec.prepare_kv_span(p, *pre.prefill_span(p))
                 for p in SPAN_PROMPTS]
        seeded = [dec.prepare_kv_span(p, *pre.prefill_span(
            p, temperature=0.9, seed=5 + i)) for i, p in enumerate(SPAN_PROMPTS)]
    finally:
        pre.stop()
    assert pre.stats["kv_spans_exported"] == 6 and pre.stats["chunks"] == 0
    got, stats = _run(dec, [[(p, dict(max_new_tokens=10, kv_span=s))
                             for p, s in zip(SPAN_PROMPTS, spans)],
                            [(p, dict(max_new_tokens=10, kv_span=s,
                                      temperature=0.9, seed=5 + i))
                             for i, (p, s) in enumerate(zip(SPAN_PROMPTS, seeded))]])
    want, _ = _run(jax_eng(), [_wave(SPAN_PROMPTS, 10),
                               [(p, dict(max_new_tokens=10, temperature=0.9,
                                         seed=5 + i))
                                for i, p in enumerate(SPAN_PROMPTS)]])
    assert got == want
    assert stats["prefill_pieces"] == 0 and stats["kv_injected"] == 6


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    return dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                if ln and not ln.startswith("#"))


def test_paged_prefill_replica_feeds_dense_decode_replica_over_http():
    """A paged port prefill replica and a dense port decode replica: every
    row's span ships over ``x-kft-prefill-peer``, the decode replica runs
    no prefill piece, and the streams equal a colocated dense engine's."""
    _, _, tmodel = _models()
    common = dict(config=tmodel.cfg, state_dict=tmodel.state_dict(),
                  device="cpu", max_new_tokens=10, prefill_buckets=(16, 32),
                  max_batch=2, chunk_steps=4, eos_id=EOS, watchdog=False)
    pre = ModelServer([LMEngineModel("lm", **common, **PAGED)], http_port=0,
                      role="prefill").start()
    dec = ModelServer([LMEngineModel("lm", **common)], http_port=0,
                      role="decode").start()
    try:
        assert dec.models["lm"].engine.pager is None
        assert pre.models["lm"].engine.pager is not None
        peer = {PREFILL_PEER_HEADER: f"http://127.0.0.1:{pre.port}"}
        with ThreadPoolExecutor(3) as ex:
            got = list(ex.map(
                lambda p: _post(dec.port, "/v2/models/lm/generate",
                                {"input_ids": p}, peer)["token_ids"],
                SPAN_PROMPTS))
        deng = dec.models["lm"].engine
        assert deng.stats["prefill_pieces"] == 0
        assert deng.stats["kv_injected"] == 3
        assert deng.stats["kv_ship_fallbacks"] == 0
        assert pre.models["lm"].engine.stats["kv_spans_exported"] == 3
        m = _scrape(dec.port)
        assert m['kubeflow_tpu_engine_prefill_pieces{model="lm"}'] == "0"
        # a dense engine exposes no pager series
        assert not any("kv_pages" in k for k in m)
    finally:
        pre.stop()
        dec.stop()
    want, _ = _run(LMEngine(tmodel, **BASE), [_wave(SPAN_PROMPTS, 10)])
    assert got == want


def test_dense_prefix_entries_export_and_import():
    """Prefix entries of a dense engine move to a dense engine of the other
    framework (and back) and serve hits there with the same tokens."""
    jmodel, params, tmodel = _models()
    kw = {**BASE, "prefix_cache_entries": 4}
    shared = _prompts(21, (16,))[0]
    warm, probe = shared + [3, 9, 4, 8], shared + [7, 7, 2, 5]
    mk = {"torch": lambda: LMEngine(tmodel, **kw).start(),
          "jax": lambda: JaxEngine(jmodel, jmodel.cfg, params, **kw).start()}
    out = {}
    for src_kind, dst_kind in (("torch", "jax"), ("jax", "torch"),
                               ("torch", "torch")):
        src, dst = mk[src_kind](), mk[dst_kind]()
        try:
            src.submit(warm, max_new_tokens=4)
            entries = src.export_prefix_entries()
            assert [k for k, _ in entries] == [tuple(shared)]
            assert dst.import_prefix_entries(entries) == 1
            assert dst.import_prefix_entries(entries) == 0
            out[(src_kind, dst_kind)] = dst.submit(probe, max_new_tokens=10)
            assert dst.stats["prefix_hits"] == 1
        finally:
            src.stop()
            dst.stop()
    ref, _ = _run(LMEngine(tmodel, **BASE), SEQ([probe], 10))
    assert set(map(tuple, out.values())) == {tuple(ref[0])}


def test_dense_host_tier_swaps_the_prompt_only():
    """A finished dense row swaps only its prompt's window out (its
    generated KV sits past the gap); the session's next turn swaps it
    back in, as the JAX dense engine does, with the same tokens."""
    jmodel, params, tmodel = _models()
    kw = {**BASE, "host_kv_bytes": 1 << 20}
    first = _prompts(22, (20,))[0]

    def turns(eng):
        eng.start()
        try:
            t1 = eng.submit(first, max_new_tokens=8, session="s1")
            assert eng.flush_offload()
            t2 = eng.submit(first + t1 + [12, 13], max_new_tokens=8, session="s1")
            assert eng.flush_offload()
            return (t1, t2), dict(eng.stats), eng.host_kv_tier.resident()
        finally:
            eng.stop()

    want, jstats, _ = turns(JaxEngine(jmodel, jmodel.cfg, params, **kw))
    got, stats, res = turns(LMEngine(tmodel, **kw))
    assert got == want
    for key in ("kv_offload_out", "kv_offload_in", "prefix_hits"):
        assert stats[key] == jstats[key], key
    assert stats["kv_offload_out"] == 2 and stats["kv_offload_in"] == 1
    # turn 2's prompt is 30 tokens: its swap-out holds the 16-token prompt
    # window (2 layers of K and V, 1 x 4 x 16 x 8 f32 each, plus framing),
    # where a paged row would hold 32 of its 37 written tokens
    window = 2 * 2 * 4 * 16 * 8 * 4
    assert res["rows"] == 1 and window < res["bytes"] < 2 * window
    plain, _ = _run(LMEngine(tmodel, **BASE),
                    SEQ([first], 8) + SEQ([first + want[0] + [12, 13]], 8))
    assert tuple(plain) == want


def test_dense_staggered_arrivals_share_the_batch():
    """Requests arriving while others decode join the running dense batch
    (JAX ``test_concurrent_staggered_requests_share_the_batch``)."""
    jmodel, params, tmodel = _models()
    kw = {**BASE, "max_batch": 3, "chunk_steps": 2}
    prompts = _prompts(23, (5, 11, 17, 3, 9))
    want, _ = _run(JaxEngine(jmodel, jmodel.cfg, params, **kw), SEQ(prompts, 16))
    eng = LMEngine(tmodel, **kw)
    # a slow decode (the loop's fault seam) keeps early rows resident
    # while the later ones arrive
    eng._fault_hooks["pre_chunk"] = lambda _: time.sleep(0.01)
    eng.start()
    results, errors = {}, []

    def worker(i):
        try:
            time.sleep(0.02 * i)
            results[i] = eng.submit(prompts[i], max_new_tokens=16)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        eng.stop()
    assert not errors and [results[i] for i in range(5)] == want
    assert eng.stats["admitted"] == 5 and 2 <= eng.stats["max_concurrent"] <= 3
