"""The port's engine loop against the JAX ``LMEngine``: the pipelined
one-chunk-ahead dispatch, chunked prefill, the prefix cache and seeded
resume.

Both engines run the same bridged weights in f32 on the CPU in paged
mode; the JAX engine reads the pool by ``gather`` (its gather and kernel
paths are greedy-identical by contract). Greedy streams must be
identical, and so must seeded temperature streams: the port draws them
through its own threefry (``serve/threefry.py``), bit for bit JAX's.
Every comparison is exact (token lists equal); no tolerance applies.
"""

from __future__ import annotations

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from kubeflow_tpu_torch.serve.engine import (
    LMEngine,
    LMEngineConfig,
    LMEngineModel,
)
from kubeflow_tpu_torch.serve.headers import SEED_HEADER

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
EOS = 1
PAGED = dict(kv_pool_tokens=16 * 24, page_size=16, eos_id=EOS)


@functools.lru_cache(maxsize=None)
def _models(over=()):
    over = dict(over)
    jcfg = JaxConfig(**{**KW, **over}, attn_impl="reference",
                     dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = TransformerLM(TransformerConfig(**{**KW, **over}), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(params))
    return (jmodel, jcfg, params), tmodel.eval()


def _jax(kw, over=()):
    (jmodel, jcfg, params), _ = _models(over)
    return JaxEngine(jmodel, jcfg, params, **kw).start()


def _torch(kw, over=()):
    return LMEngine(_models(over)[1], **kw).start()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, KW["vocab_size"], size=n)]
            for n in lengths]


def _sequential(eng, prompts, **kw):
    try:
        return [eng.submit(p, **kw) for p in prompts]
    finally:
        eng.stop()


def _staggered(eng, prompts, max_new, *, cancel_one=False, gap=0.02):
    """Submit every prompt from its own thread, ``gap`` seconds apart
    (admission churn through fewer rows); optionally a stream of the first
    prompt reads one chunk and walks away."""
    outs: dict[int, list[int]] = {}
    errors: list[Exception] = []

    def worker(i):
        try:
            time.sleep(gap * i)
            outs[i] = eng.submit(prompts[i], max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        if cancel_one:
            stream = eng.stream(prompts[0], max_new_tokens=max_new)
            next(iter(stream))
            stream.close()
        for t in threads:
            t.join(120)
        assert all(not t.is_alive() for t in threads)
        stats, overlap = dict(eng.stats), dict(eng.overlap)
        pages_left = eng.pager.used_pages
    finally:
        eng.stop()
    assert not errors, errors
    return [outs[i] for i in range(len(prompts))], stats, overlap, pages_left


# ----------------------------------------------------- the pipelined loop


CHURN = dict(PAGED, max_batch=3, max_seq=96, chunk_steps=4,
             prefill_buckets=(48,), prefill_chunk=16, seed=7)


@functools.lru_cache(maxsize=None)
def _churn_want():
    prompts = _prompts(71, (5, 9, 3, 12, 7, 34, 41))
    return prompts, _sequential(_jax(CHURN), prompts, max_new_tokens=12)


@pytest.mark.parametrize("depth", [0, 1])
def test_pipelined_and_inline_match_jax_under_churn(depth):
    """JAX ``test_engine.py`` pipelined/inline parity under churn: 7
    staggered requests through 3 rows, two of them chunked into 3 prefill
    pieces, with a stream cancelled mid-way — every stream equals the JAX
    engine's, at both depths."""
    prompts, want = _churn_want()
    got, stats, overlap, pages_left = _staggered(
        _torch({**CHURN, "pipeline_depth": depth}), prompts, 12,
        cancel_one=True)
    assert got == want
    assert stats["max_concurrent"] >= 2
    assert stats["prefill_pieces"] > len(prompts)
    assert pages_left == 0
    # uploads are epochs (admissions, activations, cancellations) and page
    # widenings, never one per chunk on top of those
    assert overlap["carry_uploads"] < stats["chunks"] + 2 * stats["admitted"]


def test_steady_state_uploads_are_epochs_not_chunks():
    """JAX ``test_engine.py`` :997 — a request decoding over several chunks
    costs one carry upload (its admission epoch), and every chunk's
    outputs went through one staged copy."""
    eng = _torch(dict(PAGED, max_batch=2, max_seq=64, chunk_steps=2,
                      prefill_buckets=(32,), pipeline_depth=1))
    try:
        found = False
        for ids in _prompts(73, [int(n) for n in
                                 np.random.default_rng(73).integers(3, 20, 40)]):
            c0, u0 = eng.stats["chunks"], eng.overlap["carry_uploads"]
            out = eng.submit(ids, max_new_tokens=16)
            dc = eng.stats["chunks"] - c0
            du = eng.overlap["carry_uploads"] - u0
            assert du <= 2, (ids, du, dc)
            if len(out) >= 10:  # >= 5 chunks at chunk_steps=2
                assert dc > du, (ids, dc, du)
                found = True
                break
        assert found, "no prompt produced a long enough completion"
        assert eng._outputs.staged == eng.stats["chunks"]
        assert eng.overlap["decode_gap_ms"] > 0
        assert 0 < eng.overlap["slot_occupancy"] <= 1
    finally:
        eng.stop()


def test_fatal_inflight_chunk_leaks_no_request():
    """JAX ``test_engine.py`` :1030 — the second chunk dispatch raises while
    the first is in flight: every request fails promptly with the real
    error, and later submits fail fast."""
    eng = LMEngine(_models()[1], **PAGED, max_batch=2, max_seq=64,
                   chunk_steps=2, prefill_buckets=(32,), pipeline_depth=1)
    real_chunk = eng._chunk
    calls = {"n": 0}

    def exploding(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device failure")
        return real_chunk(*a, **k)

    eng._chunk = exploding
    eng.start()
    errors: dict[int, Exception] = {}

    def worker(i):
        try:
            eng.submit([3 + i, 5, 7, 11], max_new_tokens=16, timeout_s=30)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(25)
        assert all(not t.is_alive() for t in threads)
        assert time.monotonic() - t0 < 20
        assert len(errors) == 2, "a request leaked past the fatal path"
        for e in errors.values():
            assert "injected device failure" in str(e)
        with pytest.raises(RuntimeError, match="engine is dead"):
            eng.submit([9, 9, 9], max_new_tokens=4, timeout_s=10)
    finally:
        eng.stop()


def test_carry_and_staged_outputs_never_alias_host_state():
    """JAX ``test_engine.py`` :1105 — the carry and its block table are
    snapshots: host edits after the upload do not reach them, and a later
    epoch uploads the table anew. The output ring hands each chunk in
    flight its own slot and refuses to reuse one before its drain; on the
    CPU an upload holds no pinned snapshot."""
    eng = LMEngine(_models()[1], **PAGED, max_batch=2, max_seq=64,
                   chunk_steps=2, prefill_buckets=(32,))
    eng.last_tok[:] = 7
    eng.active[:] = False
    eng.pager.alloc(0, 2)
    eng._upload_carry()
    c = eng._carry
    eng.last_tok[:] = 99
    eng.active[:] = True
    assert c["last_tok"].tolist() == [7, 7]
    assert c["active"].tolist() == [False, False]
    dev = c["table"]
    before = dev.clone()
    eng.pager.free(0)
    eng.pager.alloc(1, 3)
    assert torch.equal(dev, before)
    eng._upload_carry()  # the next epoch's table is the host's
    assert eng._carry["table"] is not dev
    w = eng._carry["table"].shape[1]
    assert eng._carry["table"].tolist() == eng.pager.table[:, :w].tolist()
    assert eng.uploader.held == 0

    ring = eng._outputs  # depth 1: two slots
    a = ring.stage({"t": torch.tensor([[1, 2]]), "v": torch.tensor([[True, False]])})
    b = ring.stage({"t": torch.tensor([[3, 4]]), "v": torch.tensor([[False, True]])})
    with pytest.raises(RuntimeError, match="before its drain"):
        ring.stage({"t": torch.tensor([[5, 6]])})
    got = ring.fetch(a)
    assert got["t"].tolist() == [[1, 2]] and got["v"].dtype == bool
    assert got["v"].tolist() == [[True, False]]
    ring.stage({"t": torch.tensor([[5, 6]])})  # slot a is free again
    assert ring.fetch(b)["t"].tolist() == [[3, 4]]


def test_config_defaults_and_validation():
    """``LMEngineConfig`` and ``LMEngineModel`` take the JAX defaults
    (``pipeline_depth=1``); the JAX constructor's checks raise."""
    assert LMEngineConfig().pipeline_depth == 1
    lm = LMEngineModel("lm", config=TransformerConfig(**KW), device="cpu",
                       kv_pool_tokens=16 * 8, page_size=16)
    assert lm._engine_config.pipeline_depth == 1
    tmodel = _models()[1]
    for bad, match in ((dict(pipeline_depth=2), "pipeline_depth"),
                       (dict(spec_draft_tokens=-1), "spec_draft_tokens"),
                       (dict(spec_draft_tokens=2, spec_ngram=0), "spec_ngram"),
                       (dict(prefill_chunk=24), "prefill_chunk")):
        with pytest.raises(ValueError, match=match):
            LMEngine(tmodel, **PAGED, **bad)
    with pytest.raises(TypeError):
        LMEngine(tmodel, **PAGED, not_a_knob=1)
    # the ngram knob is inert while speculation is off
    assert LMEngine(tmodel, **PAGED, spec_ngram=0).spec_k == 0


# ------------------------------------------------------------ paged loop


@pytest.mark.parametrize("depth", [0, 1])
def test_horizon_growth_matches_jax(depth):
    """JAX ``test_engine_paged.py`` :415 — a 40-token budget walks the read
    window across pow2 page buckets (1 → 2 → 4 pages) mid-generation; the
    pipelined loop widens the table within an epoch, log-bounded."""
    kw = dict(PAGED, max_batch=2, max_seq=64, chunk_steps=4,
              prefill_buckets=(32,), kv_pool_tokens=16 * 12, seed=7)
    prompts = _prompts(61, (4, 10, 7))
    want = _sequential(_jax({**kw, "pipeline_depth": 0}), prompts,
                       max_new_tokens=40)
    eng = _torch({**kw, "pipeline_depth": depth})
    try:
        got = [eng.submit(p, max_new_tokens=40) for p in prompts]
        if depth:
            assert eng.overlap["carry_uploads"] < eng.stats["chunks"]
    finally:
        eng.stop()
    assert got == want and any(got)


@pytest.mark.parametrize("depth", [0, 1])
def test_backpressure_matches_jax_and_frees_every_page(depth):
    """JAX ``test_engine_paged.py`` :446 — mixed-length concurrent traffic
    through a 5-page pool (4 allocatable: fewer than 3 rows of 1–2 pages
    need) holds admissions; streams equal the JAX engine's and no page
    leaks past a retired row."""
    kw = dict(PAGED, max_batch=3, max_seq=64, chunk_steps=4,
              prefill_buckets=(32,), kv_pool_tokens=16 * 5, seed=3)
    prompts = _prompts(67, (3, 13, 8, 11, 5, 9))
    want = _sequential(_jax(kw), prompts, max_new_tokens=10)
    got, stats, _, pages_left = _staggered(
        _torch({**kw, "pipeline_depth": depth}), prompts, 10, gap=0.0)
    assert got == want
    assert pages_left == 0 and stats["page_holds"] > 0


# --------------------------------------------------------- chunked prefill


def test_chunked_prefill_matches_jax_while_another_row_decodes():
    """JAX ``test_engine.py`` :790 — a 40-token prompt prefills in 3 pieces
    of 16; then a 48-token admission arrives while a short row decodes.
    All streams equal the JAX engine's."""
    kw = dict(PAGED, max_batch=2, max_seq=128, chunk_steps=2,
              prefill_buckets=(64,), prefill_chunk=16)
    ids, long_ids, short_ids = _prompts(41, (40, 48, 6))
    jeng = _jax(kw)
    try:
        want = [jeng.submit(p, max_new_tokens=n)
                for p, n in ((ids, 10), (long_ids, 10), (short_ids, 16))]
    finally:
        jeng.stop()
    eng = _torch(kw)
    results = {}
    try:
        got = eng.submit(ids, max_new_tokens=10)
        assert eng.stats["prefill_pieces"] == 3

        def run_short():
            results["short"] = eng.submit(short_ids, max_new_tokens=16)

        th = threading.Thread(target=run_short)
        th.start()
        time.sleep(0.02)
        results["long"] = eng.submit(long_ids, max_new_tokens=10)
        th.join(120)
        assert not th.is_alive()
    finally:
        eng.stop()
    assert [got, results["long"], results["short"]] == want


def test_chunked_prefill_with_prefix_cache_matches_jax():
    """JAX ``test_engine.py`` :831 — a hit implants 48 tokens and the
    20-token suffix prefills in pieces of 16 at positions 48 onwards."""
    kw = dict(PAGED, max_batch=1, max_seq=160, chunk_steps=2,
              prefill_buckets=(64,), prefill_chunk=16, prefix_cache_entries=4)
    base, tail = _prompts(43, (50, 20))
    jobs = [(base, 4), (base[:48] + tail, 10)]
    outs = {}
    for name, eng in (("jax", _jax(kw)), ("torch", _torch(kw))):
        try:
            outs[name] = [eng.submit(p, max_new_tokens=n) for p, n in jobs]
            stats = dict(eng.stats)
        finally:
            eng.stop()
        assert stats["prefix_hits"] == 1
        assert stats["prefix_tokens_reused"] == 48
        assert stats["prefill_pieces"] == 4 + 2
    assert outs["torch"] == outs["jax"]


# ------------------------------------------------------------ prefix cache


PREFIX_CASES = [
    ("f32_gather", (), dict()),
    ("window", (("attn_window", 6),), dict()),
    ("int8_kernel", (), dict(kv_quant="int8", paged_attn_impl="kernel")),
]


@pytest.mark.parametrize("name,over,eng_kw", PREFIX_CASES,
                         ids=[c[0] for c in PREFIX_CASES])
def test_prefix_cache_parity_and_reuse(name, over, eng_kw):
    """JAX ``test_engine.py`` :609 — the first request stores a 16-token
    prefix, then three prompts sharing it with different tails hit it;
    every stream and the reuse counters equal the JAX engine's (int8
    entries carry their scales)."""
    kw = dict(PAGED, max_batch=2, max_seq=96, chunk_steps=4,
              prefill_buckets=(32,), prefix_cache_entries=4, **eng_kw)
    system, *tails = _prompts(11, (20, 5, 5, 5))
    jobs = [system] + [system[:16] + t for t in tails]
    jkw = {**kw, "paged_attn_impl": "gather"}
    want = _sequential(_jax(jkw, over), jobs, max_new_tokens=10)
    eng = _torch(kw, over)
    try:
        got = [eng.submit(p, max_new_tokens=10) for p in jobs]
        assert eng.stats["prefix_hits"] == 3
        assert eng.stats["prefix_tokens_reused"] == 48
        assert eng.prefix_cache_stats()["entries"] == 1
        assert eng.prefix_index() == [tuple(system[:16])]
        entry = next(iter(eng._prefix_cache.values()))["layers_0"]
        want_keys = {"k", "v", "k_scale", "v_scale"} if eng_kw else {"k", "v"}
        assert set(entry) == want_keys
        assert entry["k"].shape == (1, KW["n_kv_heads"], 16, 16)
        assert eng.drop_prefix_cache() == 1 and eng.prefix_index() == []
    finally:
        eng.stop()
    assert got == want


def test_prefix_cache_lru_eviction():
    """JAX ``test_engine.py`` :640 — three distinct prefixes through a
    2-entry cache: the oldest is evicted, the newest still hits."""
    kw = dict(PAGED, max_batch=1, max_seq=96, chunk_steps=4,
              prefill_buckets=(32,), prefix_cache_entries=2)
    prompts = _prompts(13, (18, 18, 18))
    eng = _torch(kw)
    try:
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        assert len(eng._prefix_cache) == 2
        eng.submit(prompts[0][:16] + [7, 8], max_new_tokens=4)
        assert eng.stats["prefix_hits"] == 0
        eng.submit(prompts[2][:16] + [7, 8], max_new_tokens=4)
        assert eng.stats["prefix_hits"] == 1
    finally:
        eng.stop()


def test_prefix_cache_token_bound_evicts():
    """``prefix_cache_tokens`` bounds stored tokens: a 32-token entry and
    a 16-token one do not both fit in 40."""
    kw = dict(PAGED, max_batch=1, max_seq=96, chunk_steps=4,
              prefill_buckets=(48,), prefix_cache_entries=8,
              prefix_cache_tokens=40)
    a, b = _prompts(17, (33, 17))
    eng = _torch(kw)
    try:
        eng.submit(a, max_new_tokens=2)
        eng.submit(b, max_new_tokens=2)
        assert eng.prefix_index() == [tuple(b[:16])]
        assert eng.prefix_cache_stats()["tokens_stored"] == 16
    finally:
        eng.stop()


# --------------------------------------------------------- seeded resume


def test_resume_tokens_continue_greedy_like_jax():
    """JAX ``test_engine.py`` :1214 — resuming with a committed prefix of a
    greedy stream gives exactly the rest of it, in both engines."""
    kw = dict(PAGED, max_batch=4, max_seq=64, chunk_steps=2,
              prefill_buckets=(32,))
    prompts = _prompts(11, (5, 9, 14))
    outs = {}
    for name, eng in (("jax", _jax(kw)), ("torch", _torch(kw))):
        try:
            res = []
            for ids in prompts:
                full = eng.submit(ids, max_new_tokens=10)
                res.append(full)
                for cut in sorted({1, len(full) // 2, len(full) - 1}):
                    if 1 <= cut < len(full):
                        admits = eng.stats["resume_admits"]
                        rest = eng.submit(ids, max_new_tokens=10,
                                          resume_tokens=full[:cut])
                        assert rest == full[cut:], (name, ids, cut)
                        assert eng.stats["resume_admits"] == admits + 1
            outs[name] = res
        finally:
            eng.stop()
    assert outs["torch"] == outs["jax"]
    assert any(len(o) >= 3 for o in outs["torch"])


SEEDED = [
    ("one_piece", dict(), (5, 9, 33, 60, 7)),
    ("chunked_int8_kernel", dict(prefill_chunk=16, prefill_buckets=(64,),
                                 kv_quant="int8", paged_attn_impl="kernel"),
     tuple(range(3, 43))),
]


@pytest.mark.parametrize("name,eng_kw,ids", SEEDED, ids=[s[0] for s in SEEDED])
def test_seeded_sampling_matches_jax_token_for_token(name, eng_kw, ids):
    """JAX ``test_engine.py`` :1241 — seeded temperature 0.9 draws: the port
    gives the JAX engine's stream token for token at every seed; the same
    seed twice agrees; resuming from half the stream gives the other
    half; another seed diverges."""
    kw = {**PAGED, "max_batch": 4, "max_seq": 96, "chunk_steps": 2,
          "prefill_buckets": (32,), **eng_kw}
    ids = list(ids)
    samp = dict(max_new_tokens=10, temperature=0.9)
    seeds = (1234, 77, 78, 79)
    jeng = _jax({**kw, "paged_attn_impl": "gather"})
    try:
        want = [jeng.submit(ids, seed=s, **samp) for s in seeds]
    finally:
        jeng.stop()
    eng = _torch(kw)
    try:
        got = [eng.submit(ids, seed=s, **samp) for s in seeds]
        again = eng.submit(ids, seed=seeds[0], **samp)
        a = got[0]
        cut = len(a) // 2
        rest = eng.submit(ids, seed=seeds[0], resume_tokens=a[:cut], **samp)
        # concurrent seeded rows share chunks: batch composition must not
        # change a seeded stream
        threads, conc = [], {}
        for s in seeds:
            th = threading.Thread(target=lambda s=s: conc.__setitem__(
                s, eng.submit(ids, seed=s, **samp)))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(60)
    finally:
        eng.stop()
    assert got == want
    assert again == a and len(a) >= 3
    assert rest == a[cut:]
    assert any(o != a for o in got[1:])
    assert [conc[s] for s in seeds] == want


def test_resume_validation_errors():
    """JAX ``test_engine.py`` resume validation: a prefix that exhausts the
    budget or holds EOS is refused at admission."""
    eng = _torch(dict(PAGED, max_batch=2, max_seq=64, chunk_steps=2,
                      prefill_buckets=(32,)))
    try:
        with pytest.raises(ValueError, match="no generation budget"):
            eng.submit([5, 6, 7], max_new_tokens=3, resume_tokens=[8, 9, 10])
        with pytest.raises(ValueError, match="EOS"):
            eng.submit([5, 6, 7], max_new_tokens=8, resume_tokens=[8, EOS])
        with pytest.raises(ValueError, match="32-bit"):
            eng.submit([5, 6, 7], max_new_tokens=3, seed=2**40)
        assert len(eng.submit([5, 6, 7], max_new_tokens=3,
                              resume_tokens=[8, 9])) <= 1
    finally:
        eng.stop()


def test_seed_header_reaches_the_engine():
    """``LMEngineModel.predict`` passes ``x-kft-seed`` to
    ``engine.submit(seed=)``, as the JAX model does: the served stream is
    the engine's seeded stream."""
    _, tmodel = _models()
    lm = LMEngineModel("lm", config=TransformerConfig(**KW), device="cpu",
                       state_dict=tmodel.state_dict(), max_new_tokens=8,
                       prefill_buckets=(16,), max_batch=2, **PAGED)
    lm.load()
    try:
        row = {"input_ids": [5, 9, 33, 60, 7], "temperature": 0.9}
        served = lm({"instances": [row]}, {SEED_HEADER: "1234"})
        direct = lm.engine.submit(row["input_ids"], max_new_tokens=8,
                                  temperature=0.9, seed=1234)
    finally:
        lm.unload()
    assert served["predictions"][0]["token_ids"] == direct


def test_stress_many_submitters_short_switch_interval():
    """More submitter threads than cores against the pipelined loop with
    a 10 us switch interval: submits, streams walked away from and prefix
    hits interleave with the loop thread. Every finished stream equals
    its sequential one, every request ends, and no page leaks."""
    import os
    import sys

    kw = dict(PAGED, max_batch=3, max_seq=64, chunk_steps=2,
              prefill_buckets=(32,), prefix_cache_entries=4)
    base = _prompts(29, (18,))[0]
    prompts = [base[:16] + t for t in _prompts(31, [2, 3, 4, 5] * 2)]
    prompts += _prompts(37, (3, 7, 11, 5))
    eng = _torch(kw)
    try:
        want = [eng.submit(p, max_new_tokens=6) for p in prompts]
    finally:
        eng.stop()
    n = max(2 * (os.cpu_count() or 1), len(prompts))
    eng = _torch(kw)
    got: dict[int, list[int]] = {}
    errors: list[Exception] = []

    def worker(i):
        try:
            p = prompts[i % len(prompts)]
            if i % 5 == 4:  # walk away after the first piece
                s = eng.stream(p, max_new_tokens=6)
                next(iter(s))
                s.close()
            else:
                got[i] = eng.submit(p, max_new_tokens=6, timeout_s=60)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        assert all(not t.is_alive() for t in threads)
        deadline = time.monotonic() + 10
        while eng.pager.used_pages and time.monotonic() < deadline:
            time.sleep(0.01)  # walked-away rows retire at the next epoch
        pages_left = eng.pager.used_pages
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert not errors, errors
    assert {i: got[i] for i in got} == {
        i: want[i % len(prompts)] for i in got}
    assert pages_left == 0
