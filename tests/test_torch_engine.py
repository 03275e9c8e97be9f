"""The port's paged ``LMEngine`` against the JAX ``LMEngine``.

Both engines run the same bridged weights in f32 on the CPU, in paged
mode (``kv_pool_tokens`` set) with the synchronous loop
(``pipeline_depth=0``) and greedy decoding, and must give identical token
streams: continuous batching, row churn, page backpressure, sliding
windows, GQA, int8 KV and the kernel read path change how the tokens are
computed, never which tokens come out. The pipelined loop, chunked
prefill, the prefix cache and seeded resume are held against the JAX
engine in ``test_torch_engine_loop.py``, speculative decoding in
``test_torch_spec.py``.
"""

from __future__ import annotations

import functools
import threading
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
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
)
from kubeflow_tpu_torch.serve.engine import (
    EngineOverloaded,
    LMEngine,
    LMEngineConfig,
    LMEngineModel,
)

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
ENGINE = dict(max_batch=2, max_seq=64, chunk_steps=4, prefill_buckets=(16, 32),
              eos_id=1, kv_pool_tokens=16 * 12, page_size=16,
              pipeline_depth=0)


@functools.lru_cache(maxsize=None)
def _models(over=()):
    over = dict(over)
    jcfg = JaxConfig(**{**KW, **over}, attn_impl="reference",
                     dtype=jnp.float32, interpret_kernels=True)
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


def _serve(engine, prompts, max_new):
    engine.start()
    try:
        with ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(engine.submit, p, max_new_tokens=max_new)
                    for p in prompts]
            return [f.result() for f in futs], dict(engine.stats)
    finally:
        engine.stop()


SCENARIOS = [
    # name, model overrides, engine overrides, prompt lengths, max_new
    ("two_buckets", (), dict(max_batch=4), (5, 12, 20, 28), 16),
    ("row_churn", (), dict(), (9, 3, 14, 27, 6, 18), 12),
    ("page_backpressure", (), dict(kv_pool_tokens=16 * 5), (20, 24, 22), 20),
    ("attn_window", (("attn_window", 6),), dict(), (12, 25, 7), 20),
    ("gqa_kernel", (("n_kv_heads", 1),), dict(paged_attn_impl="kernel"),
     (11, 19, 4), 16),
    ("int8", (), dict(kv_quant="int8"), (13, 26, 8), 16),
    ("int8_kernel", (), dict(kv_quant="int8", paged_attn_impl="kernel"),
     (17, 6), 16),
]


@pytest.mark.parametrize("name,over,eng,lengths,max_new", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_greedy_streams_match_jax_engine(name, over, eng, lengths, max_new):
    (jmodel, jcfg, params), tmodel = _models(over)
    kw = {**ENGINE, **eng}
    prompts = _prompts(sum(map(ord, name)), lengths)
    want, jstats = _serve(JaxEngine(jmodel, jcfg, params, **kw), prompts, max_new)
    got, tstats = _serve(LMEngine(tmodel, **kw), prompts, max_new)
    assert got == want
    assert all(1 <= len(t) <= max_new for t in got)
    for key in ("admitted", "completed"):
        assert tstats[key] == jstats[key] == len(prompts)
    if name == "row_churn":
        assert tstats["max_concurrent"] == kw["max_batch"]
    if name == "page_backpressure":
        # the pool holds one request's pages at a time: admission waits
        assert tstats["page_holds"] > 0 and tstats["max_concurrent"] == 1


def test_stream_yields_the_submit_tokens():
    _, tmodel = _models()
    prompt = _prompts(3, (10,))[0]
    eng = LMEngine(tmodel, **ENGINE).start()
    try:
        whole = eng.submit(prompt, max_new_tokens=10)
        pieces = list(eng.stream(prompt, max_new_tokens=10))
    finally:
        eng.stop()
    assert [t for p in pieces for t in p] == whole


def test_overload_past_max_queue_raises():
    """Rows decoding + queued beyond ``max_batch + max_queue`` are shed."""
    _, tmodel = _models()
    eng = LMEngine(tmodel, **{**ENGINE, "max_batch": 1, "max_queue": 1})
    errors: list[Exception] = []

    def queued():
        try:
            eng.submit([5, 6, 7], max_new_tokens=4, timeout_s=30)
        except Exception as e:  # noqa: BLE001 — checked below
            errors.append(e)

    # the loop is not started, so both submits stay queued
    waiting = [threading.Thread(target=queued) for _ in range(2)]
    for t in waiting:
        t.start()
    for _ in range(500):
        if eng._pending.qsize() == 2:
            break
        threading.Event().wait(0.01)
    with pytest.raises(EngineOverloaded):
        eng.submit([5, 6, 7], max_new_tokens=4)
    eng.stop()  # fails the queued requests instead of leaving them waiting
    for t in waiting:
        t.join(5)
    assert len(errors) == 2
    assert all("stopped" in str(e) for e in errors)


def test_request_validation():
    _, tmodel = _models()
    eng = LMEngine(tmodel, **ENGINE)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=4)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([3] * 30, max_new_tokens=40)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit([3] * 33, max_new_tokens=4)
    eng.stop()


UNPORTED = [
    ("mesh", dict(mesh=object()), "tensor-parallel"),
    ("measured_page_size", dict(page_size=None), "page-size"),
]
#: dense mode (``kv_pool_tokens=None``, the JAX default) is ported; like
#: the JAX engine it rejects the paged kernel and the int8 pool, which
#: need a pool, with a ValueError
POOL_ONLY = [
    ("dense_mode", dict(kv_pool_tokens=None, paged_attn_impl="kernel")),
    ("dense_mode_int8", dict(kv_pool_tokens=None, kv_quant="int8")),
]


@pytest.mark.parametrize(
    "name,knob,what",
    UNPORTED + [(n, k, "require paged mode") for n, k in POOL_ONLY],
    ids=[u[0] for u in UNPORTED + POOL_ONLY])
def test_unported_engine_knobs_raise(name, knob, what):
    _, tmodel = _models()
    err = ValueError if knob.get("kv_pool_tokens", 0) is None else NotImplementedError
    with pytest.raises(err, match=what):
        LMEngine(tmodel, **{**ENGINE, **knob})
    with pytest.raises(err, match="ROADMAP" if err is NotImplementedError else what):
        LMEngine(tmodel, config=LMEngineConfig(**{**ENGINE, **knob}))
    if err is ValueError:  # the reference raises the same
        jmodel, jcfg, params = _models()[0]
        with pytest.raises(ValueError, match=what):
            JaxEngine(jmodel, jcfg, params, **{**ENGINE, **knob})


@pytest.mark.parametrize("depth", [0, 1])
def test_dense_mode_serves_with_jax_defaults(depth):
    """The knobs of the old ``dense_mode`` row (``kv_pool_tokens=None``)
    build a dense engine that serves a request with the JAX dense
    engine's tokens; ``LMEngineModel`` with the JAX defaults serves too."""
    (jmodel, jcfg, params), tmodel = _models()
    kw = {**ENGINE, "kv_pool_tokens": None, "pipeline_depth": depth}
    prompt = _prompts(11, (13,))[0]
    jeng = JaxEngine(jmodel, jcfg, params, **kw).start()
    try:
        want = jeng.submit(prompt, max_new_tokens=10)
    finally:
        jeng.stop()
    eng = LMEngine(tmodel, **kw)
    assert eng.pager is None and eng.cache["layers_0"]["k"].shape == (
        2, KW["n_kv_heads"], 64, KW["d_model"] // KW["n_heads"])
    eng.start()
    try:
        assert eng.submit(prompt, max_new_tokens=10) == want
    finally:
        eng.stop()
    lm = LMEngineModel("lm", config=TransformerConfig(**KW), device="cpu",
                       state_dict=tmodel.state_dict(), max_new_tokens=10,
                       prefill_buckets=(16, 32), pipeline_depth=depth,
                       watchdog=False)
    lm.load()
    try:
        assert lm.engine.pager is None
        out = lm({"instances": [{"input_ids": prompt}]})
        assert out == {"predictions": [{"token_ids": want}]}
    finally:
        lm.unload()


def test_host_kv_bytes_starts_the_tier():
    """``host_kv_bytes`` builds the host tier; ``start`` runs its offload
    thread and ``stop`` drains and ends it (``tests/test_torch_kv_span.py``
    holds the swaps against the JAX engine)."""
    _, tmodel = _models()
    assert LMEngine(tmodel, **ENGINE).host_kv_tier is None
    eng = LMEngine(tmodel, **{**ENGINE, "host_kv_bytes": 1 << 20})
    assert eng.host_kv_tier.max_bytes == 1 << 20
    eng.start()
    thread = eng._offload_thread
    try:
        assert thread.is_alive() and eng.flush_offload(timeout_s=30)
    finally:
        eng.stop()
    thread.join(10)
    assert not thread.is_alive() and eng._offload_thread is None


UNPORTED_MODEL = [
    ("ring", dict(attn_impl="ring")),
    ("ulysses", dict(attn_impl="ulysses")),
    ("moe", dict(moe_every=2)),
    ("remat", dict(remat=True)),
    ("dropout", dict(dropout_rate=0.1)),
    ("onehot_embed", dict(embed_impl="onehot")),
]


@pytest.mark.parametrize("name,knob", UNPORTED_MODEL,
                         ids=[u[0] for u in UNPORTED_MODEL])
def test_unported_model_knobs_raise(name, knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(TransformerConfig(**KW, **knob), device="cpu")


def test_dense_cache_branch_raises():
    """The dense ``layer_cache`` branch (which raised before it was
    ported) now serves: a prefill into a cache from ``init_kv_cache``
    and a decode step give the no-cache logits, f32 within 1e-5
    (``tests/test_torch_generate.py`` holds it against JAX)."""
    _, tmodel = _models()
    toks = torch.tensor(_prompts(12, (9,)))
    full = tmodel(toks)
    cache = init_kv_cache(tmodel.cfg, 1, 16, device="cpu")
    lg, cache = tmodel(toks[:, :6], cache=cache, cache_index=0)
    torch.testing.assert_close(lg, full[:, :6], rtol=2e-5, atol=1e-5)
    for t in range(6, 9):
        lg, cache = tmodel(toks[:, t:t + 1], cache=cache, cache_index=t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=2e-5, atol=1e-5)
