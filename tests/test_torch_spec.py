"""The port's threefry, prompt-lookup drafter and speculative engine
against the JAX package.

- ``serve/threefry.py`` equals ``jax.random`` bit for bit on the same
  numpy seeds and positions: keys, ``fold_in``, 32-bit bits and uniforms
  (compared as bit patterns); ``categorical`` gives equal tokens.
- ``serve/speculative.py``: the drafter equals JAX ``propose_draft`` on
  the same numpy histories, and greedy ``spec_accept`` equals JAX's.
- The speculative engine (``spec_draft_tokens=K``) gives greedy streams
  identical to the JAX engine's, with and without speculation, inline and
  pipelined, under churn, chunked prefill, the prefix cache,
  backpressure, int8 KV and the kernel read path (its (K+1)-query verify
  goes through ``ops/paged_attention.py`` with a per-row ``pos0``).

Every comparison is exact; no tolerance applies.
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
from kubeflow_tpu.serve.speculative import propose_draft as jax_propose
from kubeflow_tpu.serve.speculative import spec_accept as jax_accept
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.serve import threefry as tf
from kubeflow_tpu_torch.serve.engine import LMEngine
from kubeflow_tpu_torch.serve.speculative import propose_draft, spec_accept

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
EOS = 1
BASE = dict(max_batch=3, max_seq=96, chunk_steps=4, prefill_buckets=(32,),
            eos_id=EOS, kv_pool_tokens=16 * 20, page_size=16, seed=7)


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


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, KW["vocab_size"], size=n)]
            for n in lengths]


def _run(eng, jobs, *, concurrent=False, cancel=None):
    """Serve ``jobs`` [(ids, max_new)] one after another, or each from its
    own thread 20 ms apart (``concurrent``; ``cancel`` = a prompt whose
    stream reads one chunk and walks away). Returns the streams in job
    order and the engine's stats."""
    eng.start()
    try:
        if not concurrent:
            outs = [eng.submit(p, max_new_tokens=n) for p, n in jobs]
        else:
            res, errors = {}, []

            def worker(i):
                try:
                    time.sleep(0.02 * i)
                    res[i] = eng.submit(jobs[i][0], max_new_tokens=jobs[i][1])
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(jobs))]
            for t in threads:
                t.start()
            if cancel is not None:
                stream = eng.stream(cancel, max_new_tokens=12)
                next(iter(stream))
                stream.close()
            for t in threads:
                t.join(120)
            assert all(not t.is_alive() for t in threads) and not errors, errors
            outs = [res[i] for i in range(len(jobs))]
        assert eng.pager.used_pages == 0  # no page leaks past retired rows
        return outs, dict(eng.stats)
    finally:
        eng.stop()


@functools.lru_cache(maxsize=None)
def _jax_want(kw_items, jobs, over=()):
    (jmodel, jcfg, params), _ = _models(over)
    eng = JaxEngine(jmodel, jcfg, params, **dict(kw_items))
    return _run(eng, [(list(p), n) for p, n in jobs])[0]


def _want(kw, jobs, over=()):
    """The JAX engine's greedy streams (gather read, no speculation)."""
    kw = {**kw, "spec_draft_tokens": 0, "paged_attn_impl": "gather",
          "pipeline_depth": 0}
    return _jax_want(tuple(sorted(kw.items())),
                     tuple((tuple(p), n) for p, n in jobs), over)


# ---------------------------------------------------------------- threefry


SEEDS = np.array([0, 1, 7, 1234, 77, 2**31 - 1, 65536, 99991], np.int32)
POSITIONS = np.array([0, 1, 3, 17, 200, 4095, 100003, 2**31 - 2], np.int32)


def _jkeys():
    return [jax.random.fold_in(jax.random.PRNGKey(int(s)), int(p))
            for s, p in zip(SEEDS, POSITIONS)]


def _tkeys():
    return tf.fold_in(tf.prng_key(torch.from_numpy(SEEDS.astype(np.int64))),
                      torch.from_numpy(POSITIONS.astype(np.int64)))


def test_threefry_prng_key_and_fold_in_bit_exact():
    want = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(int(s))))
                     for s in SEEDS]).astype(np.int64)
    got = tf.prng_key(torch.from_numpy(SEEDS.astype(np.int64))).numpy()
    assert (got == want).all()
    want = np.stack([np.asarray(jax.random.key_data(k)) for k in _jkeys()])
    assert (_tkeys().numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize("n", [1, 97, 1000])
def test_threefry_bits_bit_exact(n):
    want = np.stack([np.asarray(jax.random.bits(k, (n,))) for k in _jkeys()])
    assert (tf.random_bits(_tkeys(), n).numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (tf.TINY, 1.0), (-2.0, 3.0)])
def test_threefry_uniform_bit_exact(lo, hi):
    want = np.stack([np.asarray(jax.random.uniform(k, (257,), minval=lo,
                                                   maxval=hi))
                     for k in _jkeys()])
    got = tf.uniform(_tkeys(), 257, lo, hi).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()


def test_threefry_categorical_equal_tokens_64_seeds_8_positions():
    """``categorical`` over 64 seeds x 8 positions on the same logits:
    equal tokens (the Gumbel noise is bit-exact; logs may differ in the
    last ulp, which no draw here is close enough to a tie to notice)."""
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2**31 - 1, size=64).astype(np.int64)
    pos = np.arange(8, dtype=np.int64) * 13 + 5
    S, P = np.meshgrid(seeds, pos, indexing="ij")
    S, P = S.ravel(), P.ravel()
    logits = (rng.standard_normal((S.size, 97)) * 2).astype(np.float32)

    @jax.jit
    def draw(s, p, lg):
        return jax.vmap(lambda s, p, l: jax.random.categorical(
            jax.random.fold_in(jax.random.PRNGKey(s), p), l))(s, p, lg)

    want = np.asarray(draw(S.astype(np.int32), P.astype(np.int32), logits))
    key = tf.fold_in(tf.prng_key(torch.from_numpy(S)), torch.from_numpy(P))
    got = tf.categorical(key, torch.from_numpy(logits)).numpy()
    assert (got == want).all()
    assert len(set(got.tolist())) > 20  # real draws, not argmax


# ----------------------------------------------------------------- drafter


def test_propose_draft_matches_and_degrades():
    """JAX ``test_engine_spec.py`` :61 — a periodic row drafts the full
    window, a non-repeating row and a too-short one draft nothing."""
    hist = np.array([
        [5, 6, 7, 5, 6, 7, 5, 6, 7, 0, 0, 0],
        [2, 3, 4, 5, 6, 7, 8, 9, 10, 0, 0, 0],
        [4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ], np.int64)
    hist_len = np.array([9, 9, 2], np.int64)
    draft, n = propose_draft(torch.from_numpy(hist), torch.from_numpy(hist_len),
                             ngram=3, k=4)
    assert n.tolist() == [4, 0, 0]
    assert draft[0].tolist() == [5, 6, 7, 5]


def test_propose_draft_prefers_recent_full_window():
    """JAX ``test_engine_spec.py`` :84."""
    row = [1, 2, 3, 9, 9, 1, 2, 3, 4, 4, 1, 2, 3]
    draft, n = propose_draft(torch.tensor([row + [0] * 3]),
                             torch.tensor([len(row)]), ngram=3, k=2)
    assert n.tolist() == [2] and draft[0].tolist() == [4, 4]


@pytest.mark.parametrize("ngram,k", [(1, 2), (2, 4), (3, 4), (3, 8)])
def test_propose_draft_equals_jax_on_random_histories(ngram, k):
    """Random histories over a 3-token alphabet (so matches abound) and
    random lengths, including rows shorter than the n-gram."""
    rng = np.random.default_rng(ngram * 10 + k)
    hist = rng.integers(2, 5, size=(32, 40)).astype(np.int32)
    hist_len = rng.integers(0, 41, size=32).astype(np.int32)
    jd, jn = jax_propose(jnp.asarray(hist), jnp.asarray(hist_len),
                         ngram=ngram, k=k)
    td, tn = propose_draft(torch.from_numpy(hist.astype(np.int64)),
                           torch.from_numpy(hist_len.astype(np.int64)),
                           ngram=ngram, k=k)
    assert (tn.numpy() == np.asarray(jn)).all()
    assert (tn > 0).sum() > 8
    assert (td.numpy() == np.asarray(jd)).all()


def test_spec_accept_greedy_equals_jax():
    """Greedy verification needs no noise: accepted counts and emitted
    spans equal JAX's on the same logits and drafts."""
    rng = np.random.default_rng(9)
    B, K, V = 16, 4, 11
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = greedy[:, :K].copy()
    cut = rng.integers(0, K + 1, size=B)
    for b in range(B):  # disagree from position cut[b] on
        draft[b, cut[b]:] = (draft[b, cut[b]:] + 1) % V
    dlen = rng.integers(0, K + 1, size=B)
    temp = np.zeros(B, np.float32)
    je, jn, ja = jax_accept(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                            jnp.asarray(dlen, jnp.int32), jax.random.PRNGKey(0),
                            jnp.asarray(temp))
    te, tn, ta = spec_accept(torch.from_numpy(logits),
                             torch.from_numpy(draft.astype(np.int64)),
                             torch.from_numpy(dlen.astype(np.int64)),
                             torch.Generator().manual_seed(0),
                             torch.from_numpy(temp))
    assert ta.tolist() == np.asarray(ja).tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert te.tolist() == np.asarray(je).tolist()
    assert 0 < int(ta.sum()) < B * K


# ------------------------------------------------------- the spec engine


MODES = [(0, "gather"), (1, "gather"), (1, "kernel")]


@pytest.mark.parametrize("depth,impl", MODES,
                         ids=[f"depth{d}_{i}" for d, i in MODES])
def test_spec_greedy_identical_to_jax_all_modes(depth, impl):
    """JAX ``test_engine_spec.py`` :101 — K=4 gives the JAX engine's K=0
    greedy streams, on prompts that draft heavily and ones that rarely
    match; the kernel read path verifies K+1 = 5 queries per row."""
    jobs = [(p, 12) for p in _prompts(0, (5, 12, 8, 17))]
    jobs += [([7, 8, 9] * 6, 12), ([11, 12] * 9, 12)]
    pa.LAUNCHES = 0  # CPU tensors run the twin: the count stays 0 here
    eng = LMEngine(_models()[1], **BASE, spec_draft_tokens=4,
                   pipeline_depth=depth, paged_attn_impl=impl)
    got, stats = _run(eng, jobs)
    assert got == _want(BASE, jobs)
    assert stats["spec_accepted"] > 0
    assert stats["spec_proposed"] >= stats["spec_accepted"]


def test_spec_parity_under_churn_chunked_prefill_and_cancel():
    """JAX ``test_engine_spec.py`` :149 — staggered requests through 3 rows,
    two prompts prefilled in pieces of 16 between speculative chunks, a
    stream cancelled mid-way: the JAX engine's streams."""
    kw = dict(BASE, max_seq=112, prefill_buckets=(48,), prefill_chunk=16)
    jobs = [(p, 12) for p in _prompts(71, (5, 9, 3, 12, 7, 34, 41))]
    eng = LMEngine(_models()[1], **kw, spec_draft_tokens=4)
    got, stats = _run(eng, jobs, concurrent=True, cancel=jobs[0][0])
    assert got == _want(kw, jobs)
    assert stats["max_concurrent"] >= 2
    assert stats["prefill_pieces"] > len(jobs)


def test_spec_with_prefix_cache_parity():
    """JAX ``test_engine_spec.py`` :229 — prefix hits implant KV while the
    history mirror is rebuilt from host data; streams equal JAX's."""
    kw = dict(BASE, max_batch=1, prefix_cache_entries=4)
    base = _prompts(11, (20,))[0]
    jobs = [(base, 10), (base[:16] + [3, 4], 10), (base[:16] + [5, 6, 7], 10)]
    eng = LMEngine(_models()[1], **kw, spec_draft_tokens=4)
    got, stats = _run(eng, jobs)
    assert got == _want(kw, jobs)
    assert stats["prefix_hits"] == 2


def test_spec_no_match_rows_take_one_token_steps():
    """JAX ``test_engine_spec.py`` :251 — with nothing to match, nothing is
    proposed and the chunk count equals the non-speculative engine's."""
    kw = dict(BASE, max_batch=1)
    jobs = [(list(range(2, 22)), 4)]
    runs = {k: _run(LMEngine(_models()[1], **kw, spec_draft_tokens=k), jobs)
            for k in (0, 4)}
    assert runs[4][0] == runs[0][0] == _want(kw, jobs)
    assert runs[4][1]["spec_proposed"] == runs[4][1]["spec_accepted"] == 0
    assert runs[4][1]["chunks"] == runs[0][1]["chunks"]


@functools.lru_cache(maxsize=None)
def _copy_model():
    """The copy-deterministic model of JAX ``test_engine_spec.py`` :311:
    attention and MLP write-backs zeroed, so the greedy chain is periodic
    and drafts are accepted structurally."""
    (jmodel, jcfg, params), _ = _models()
    zero = lambda path, v: (np.zeros_like(v) if any(  # noqa: E731
        getattr(p, "key", None) in ("o_proj", "down_proj") for p in path) else v)
    cp = jax.tree_util.tree_map_with_path(zero, params)
    tmodel = TransformerLM(TransformerConfig(**KW), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(cp))
    return (jmodel, jcfg, cp), tmodel.eval()


def test_spec_acceptance_counters_and_fewer_chunks():
    """JAX ``test_engine_spec.py`` :311 — a periodic greedy chain accepts
    drafts: the counters move, the acceptance EWMA is set, the same 64
    tokens (the JAX engine's) cost at least 1.5x fewer chunks."""
    (jmodel, jcfg, cp), tmodel = _copy_model()
    kw = dict(BASE, max_batch=1, max_seq=160, chunk_steps=2,
              eos_id=KW["vocab_size"] + 1)
    jobs = [([5, 6, 7, 8] * 4, 64)]
    want = _run(JaxEngine(jmodel, jcfg, cp, **kw), jobs)[0]
    runs = {}
    for k in (0, 4):
        eng = LMEngine(tmodel, **kw, spec_draft_tokens=k)
        runs[k] = (*_run(eng, jobs), eng.overlap["spec_acceptance"])
    assert runs[4][0] == runs[0][0] == want
    assert runs[4][1]["spec_accepted"] > 0 and runs[4][2] > 0
    assert runs[0][1]["chunks"] >= 1.5 * runs[4][1]["chunks"]


@pytest.mark.parametrize("depth", [0, 1])
def test_spec_horizon_growth_matches_jax(depth):
    """JAX ``test_engine_paged.py`` :495 — the page horizon grows by up to
    K+1 tokens a step across chunks; span positions past a row's budget
    write to the scratch page, never into its pages."""
    kw = dict(BASE, max_batch=2, max_seq=64, kv_pool_tokens=16 * 12)
    jobs = [(p, 40) for p in _prompts(61, (4, 10, 7))] + [([5, 6, 7] * 4, 40)]
    eng = LMEngine(_models()[1], **kw, spec_draft_tokens=4, pipeline_depth=depth)
    got, stats = _run(eng, jobs)
    assert got == _want(kw, jobs)
    assert stats["spec_accepted"] > 0


def test_spec_backpressure_matches_jax():
    """JAX ``test_engine_paged.py`` :527 — speculation with held admissions
    and concurrent traffic: JAX's streams, every page freed."""
    kw = dict(BASE, max_seq=64, kv_pool_tokens=16 * 5, seed=3)
    jobs = [(p, 10) for p in _prompts(67, (3, 13, 8, 11, 5, 9))]
    eng = LMEngine(_models()[1], **kw, spec_draft_tokens=4)
    got, stats = _run(eng, jobs, concurrent=True)
    assert got == _want(kw, jobs)


SPEC_MODELS = [
    ("gqa1_window_kernel", (("n_kv_heads", 1), ("attn_window", 6)),
     dict(paged_attn_impl="kernel")),
    ("int8_kernel", (), dict(kv_quant="int8", paged_attn_impl="kernel")),
    ("int8_k8_gather", (), dict(kv_quant="int8")),
    ("k8_kernel", (), dict(paged_attn_impl="kernel")),
]


@pytest.mark.parametrize("name,over,eng_kw", SPEC_MODELS,
                         ids=[c[0] for c in SPEC_MODELS])
def test_spec_model_variants_match_jax(name, over, eng_kw):
    """GQA with a sliding window through the kernel's verify, int8 KV
    (K=4 through the kernel, K=8 through the gather), and K=8 through the
    kernel (G·S = 18 queries a kv head: the kernel's row split)."""
    k = 8 if "k8" in name else 4
    kw = {**BASE, **eng_kw}
    jobs = [(p, 14) for p in _prompts(5, (9, 15))] + [([4, 5, 6, 7] * 4, 14)]
    eng = LMEngine(_models(over)[1], **kw, spec_draft_tokens=k)
    got, stats = _run(eng, jobs)
    assert got == _want(kw, jobs, over)
    assert stats["spec_accepted"] > 0


def test_spec_temperature_determinism_per_engine_seed():
    """JAX ``test_engine_paged.py`` :571 — rejection sampling draws from the
    engine generator: the same engine seed gives the same streams twice,
    through fresh engines."""
    def run():
        eng = LMEngine(_models()[1], **{**BASE, "max_batch": 1, "seed": 11},
                       spec_draft_tokens=4).start()
        try:
            return [eng.submit([7, 8, 9] * 4, max_new_tokens=16, temperature=0.9),
                    eng.submit([3, 4] * 6, max_new_tokens=10, temperature=1.3)]
        finally:
            eng.stop()

    a, b = run(), run()
    assert a == b and all(a)
    assert all(0 <= t < KW["vocab_size"] for s in a for t in s)


def test_spec_seeded_temperature_rows_match_jax():
    """Seeded temperature rows do not speculate (their draws must not
    depend on the batch), so under K=4 they give the JAX engine's seeded
    stream token for token — next to a greedy row that speculates."""
    kw = dict(BASE)
    ids = [7, 8, 9] * 4
    samp = dict(max_new_tokens=12, temperature=0.9)
    (jmodel, jcfg, params), tmodel = _models()
    jeng = JaxEngine(jmodel, jcfg, params, **kw, spec_draft_tokens=4).start()
    try:
        want = [jeng.submit(ids, seed=s, **samp) for s in (5, 6)]
    finally:
        jeng.stop()
    eng = LMEngine(tmodel, **kw, spec_draft_tokens=4).start()
    try:
        res = {}
        th = threading.Thread(target=lambda: res.__setitem__(
            "g", eng.submit([11, 12] * 9, max_new_tokens=12)))
        th.start()
        got = [eng.submit(ids, seed=s, **samp) for s in (5, 6)]
        th.join(60)
    finally:
        eng.stop()
    assert got == want and got[0] != got[1]
    assert res["g"] == _want(kw, [([11, 12] * 9, 12)])[0]


def test_spec_mixed_greedy_and_sampled_rows():
    """JAX ``test_engine_spec.py`` :343 — a greedy row co-batched with an
    unseeded sampling row keeps the greedy stream."""
    eng = LMEngine(_models()[1], **BASE, spec_draft_tokens=4).start()
    res = {}
    try:
        th = threading.Thread(target=lambda: res.__setitem__(
            "s", eng.submit([7, 8, 9] * 4, max_new_tokens=12, temperature=1.0)))
        th.start()
        res["g"] = eng.submit([5, 9, 33, 60, 2], max_new_tokens=12)
        th.join(60)
    finally:
        eng.stop()
    assert res["g"] == _want(BASE, [([5, 9, 33, 60, 2], 12)])[0]
    assert len(res["s"]) > 0
