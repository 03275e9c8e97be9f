"""The port's dense KV cache, ``make_generate_fn`` and the ``causal-lm``
runtime against the JAX package: the mirror of ``tests/test_generate.py``.

Both sides take the same seed-made numpy inputs and bridged f32 weights
(``models/bridge.py``) on the CPU. Logits of the dense-cache branch agree
with JAX's within rtol 2e-5 / atol 1e-5 (the JAX test's own tolerance for
cache against no-cache); masks are compared elementwise; greedy and
seeded sampled tokens must be identical; the threefry ``split`` and
one-key ``categorical`` are bit for bit ``jax.random``'s.
"""

from __future__ import annotations

import functools
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from kubeflow_tpu.serve import generate as jgen
from kubeflow_tpu.serve.model import BucketSpec as JaxBuckets
from kubeflow_tpu.serve.runtimes import SimpleTokenizer as JaxTokenizer
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
)
from kubeflow_tpu_torch.serve import generate as tgen
from kubeflow_tpu_torch.serve import threefry
from kubeflow_tpu_torch.serve.engine import engine_from_runtime
from kubeflow_tpu_torch.serve.model import BucketSpec
from kubeflow_tpu_torch.serve.runtimes import SimpleTokenizer, default_registry
from kubeflow_tpu_torch.serve.server import ModelServer
from kubeflow_tpu_torch.serve.spec import PredictorSpec

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
TOL = dict(rtol=2e-5, atol=1e-5)
EOS = 63


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models beside server threads: one intra-op thread keeps the
    module from oversubscribing a CPU shared with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(over=()):
    """The JAX model and params and the port's model on the same weights."""
    kw = {**KW, **dict(over)}
    jmodel = JaxLM(JaxConfig(**kw, attn_impl="reference", dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = TransformerLM(TransformerConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(params))
    return jmodel, params, tmodel.eval().requires_grad_(False)


def _key(seed):
    return threefry.prng_key(torch.tensor(seed))


# ------------------------------------------------------ the dense cache


CACHE_CASES = [
    # name, model overrides, B, S, P, MAX, kv_mask for decode steps
    ("rope", (), 2, 12, 7, 16, True),
    ("learned_positions", (("use_rope", False), ("max_seq_len", 64)),
     1, 8, 5, 12, True),
    ("window", (("attn_window", 4),), 2, 14, 6, 16, False),
    ("gqa_window", (("n_kv_heads", 2), ("attn_window", 5)), 2, 13, 4, 16, False),
]


@pytest.mark.parametrize("name,over,B,S,P,MAX,masked", CACHE_CASES,
                         ids=[c[0] for c in CACHE_CASES])
def test_dense_cache_decode_matches_jax_and_no_cache(name, over, B, S, P, MAX,
                                                     masked):
    """Prefill at ``cache_index=0`` then teacher-forced decode steps (a
    caller's (B, T) mask, or the default causal mask with the window):
    each step's logits equal the JAX ``apply(cache=...)`` logits and the
    port's own no-cache forward."""
    jmodel, params, tmodel = _models(over)
    toks = np.random.default_rng(1).integers(0, KW["vocab_size"], (B, S))
    full = tmodel(torch.tensor(toks))
    jcache = jax_init_kv_cache(jmodel.cfg, B, MAX)
    tcache = init_kv_cache(tmodel.cfg, B, MAX, device="cpu")
    jl, jcache = jmodel.apply({"params": params}, jnp.asarray(toks[:, :P]),
                              cache=jcache, cache_index=0)
    tl, tcache = tmodel(torch.tensor(toks[:, :P]), cache=tcache, cache_index=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), full[:, :P].numpy(), **TOL)
    for t in range(P, S):
        kv = np.broadcast_to(np.arange(MAX) <= t, (B, MAX)) if masked else None
        jl, jcache = jmodel.apply(
            {"params": params}, jnp.asarray(toks[:, t:t + 1]), cache=jcache,
            cache_index=t, kv_mask=None if kv is None else jnp.asarray(kv))
        tl, tcache = tmodel(
            torch.tensor(toks[:, t:t + 1]), cache=tcache, cache_index=t,
            kv_mask=None if kv is None else torch.tensor(kv))
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl[:, 0]),
                                   err_msg=f"step {t}", **TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t].numpy(),
                                   err_msg=f"step {t}", **TOL)
    for name_, lc in tcache.items():
        np.testing.assert_allclose(lc["k"].numpy(), np.asarray(jcache[name_]["k"]),
                                   **TOL)


def test_per_row_cache_index_and_span_mask_match_jax():
    """(B,) cache indices (each row writes at its own slot, clamped into
    the cache as ``dynamic_update_slice`` clamps) with a (B, S, T) span
    mask: logits and the written cache equal JAX's."""
    jmodel, params, tmodel = _models((("n_kv_heads", 2),))
    rng = np.random.default_rng(2)
    B, T, S = 3, 20, 3
    jcache = jax_init_kv_cache(jmodel.cfg, B, T)
    tcache = init_kv_cache(tmodel.cfg, B, T, device="cpu")
    prompt = rng.integers(0, KW["vocab_size"], (B, 8))
    _, jcache = jmodel.apply({"params": params}, jnp.asarray(prompt),
                             cache=jcache, cache_index=0)
    tmodel(torch.tensor(prompt), cache=tcache, cache_index=0)
    slot0 = np.array([8, 11, 19])  # the last row's span is clamped to 17
    pos = np.array([8, 9, 10])[:, None] + np.arange(S)
    mask = np.asarray(jgen.decode_span_kv_mask(
        jnp.arange(T), jnp.asarray([8, 6, 8]), jnp.asarray([8, 10, 12]),
        jnp.asarray(slot0), S, 4))
    x = rng.integers(0, KW["vocab_size"], (B, S))
    jl, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(x), cache=jcache,
        cache_index=jnp.asarray(slot0), positions=jnp.asarray(pos),
        kv_mask=jnp.asarray(mask))
    tl, tcache = tmodel(torch.tensor(x), cache=tcache,
                        cache_index=torch.tensor(slot0),
                        positions=torch.tensor(pos), kv_mask=torch.tensor(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, lc in tcache.items():
        for which in ("k", "v"):
            np.testing.assert_allclose(lc[which].numpy(),
                                       np.asarray(jcache[name][which]), **TOL)


def test_decode_masks_match_jax_elementwise():
    """``decode_kv_mask`` and ``decode_span_kv_mask`` over random
    layouts, slots, spans and windows, with scalar and (B,) arguments."""
    rng = np.random.default_rng(3)
    for trial in range(16):
        B, T = int(rng.integers(1, 5)), int(rng.integers(8, 48))
        pl = rng.integers(1, T // 2, size=B)
        gs = pl + rng.integers(0, 8, size=B)
        slot = gs + rng.integers(0, 8, size=B)
        window = None if trial % 3 == 0 else int(rng.integers(1, 12))
        span = int(rng.integers(1, 6))
        kj, kt = jnp.arange(T), torch.arange(T)
        args = [(pl, gs, slot)]
        if B == 1:
            args.append((int(pl[0]), int(gs[0]), int(slot[0])))
        for a, b, c in args:
            want = jgen.decode_kv_mask(kj, a, b, c, window)
            got = tgen.decode_kv_mask(kt, *(torch.as_tensor(v) for v in (a, b, c)),
                                      window)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want = jgen.decode_span_kv_mask(kj, a, b, c, span, window)
            got = tgen.decode_span_kv_mask(
                kt, *(torch.as_tensor(v) for v in (a, b, c)), span, window)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ make_generate_fn


def _batch(prompts, P):
    prompt = np.zeros((len(prompts), P), np.int32)
    plen = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        prompt[i, :len(p)] = p
        plen[i] = len(p)
    return prompt, plen


def _both_generate(over, prompts, P, max_new, temps, seed=0, eos=EOS):
    jmodel, params, tmodel = _models(over)
    prompt, plen = _batch(prompts, P)
    temps = np.asarray(temps, np.float32)
    jfn = jax.jit(jgen.make_generate_fn(jmodel, jmodel.cfg,
                                        max_new_tokens=max_new, eos_id=eos))
    jt, jn = jfn(params, prompt, plen, jax.random.PRNGKey(seed), jnp.asarray(temps))
    tfn = tgen.make_generate_fn(tmodel, max_new_tokens=max_new, eos_id=eos)
    tt, tn = tfn(torch.tensor(prompt, dtype=torch.int64), torch.tensor(plen),
                 _key(seed), torch.tensor(temps))
    return (np.asarray(jt), np.asarray(jn)), (tt.numpy(), tn.numpy())


GEN_CASES = [
    # name, model overrides, prompt lengths, bucket, max_new
    ("bucket32", (), (3, 17, 30), 32, 8),
    ("bucket128", (), (5, 64, 127), 128, 6),
    ("window", (("attn_window", 4),), (3, 7, 20), 32, 10),
    ("gqa", (("n_kv_heads", 2),), (9, 31), 32, 8),
    ("gqa_window_128", (("n_kv_heads", 1), ("attn_window", 6)), (40, 100), 128, 6),
    ("learned_positions", (("use_rope", False), ("max_seq_len", 64)),
     (4, 11), 32, 8),
]


@pytest.mark.parametrize("name,over,lengths,P,max_new", GEN_CASES,
                         ids=[c[0] for c in GEN_CASES])
def test_make_generate_fn_matches_jax(name, over, lengths, P, max_new):
    """Greedy ragged batches token for token, with the validity count."""
    rng = np.random.default_rng(len(name))
    prompts = [[int(t) for t in rng.integers(2, KW["vocab_size"] - 1, size=n)]
               for n in lengths]
    (jt, jn), (tt, tn) = _both_generate(over, prompts, P, max_new,
                                        [0.0] * len(prompts))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tn, jn)


def test_generation_eos_pads_and_counts_like_jax():
    """EOS set to a token the greedy streams emit: rows stop, then emit
    ``pad_id``, and the validity counts agree with JAX's."""
    prompts = [[5, 9, 17], [3, 30, 41, 28, 11], [7, 7, 7, 7]]
    _, (tt, tn) = _both_generate((), prompts, 8, 8, [0.0] * 3)
    eos = int(tt[0, 2])  # row 0 emits it third
    (jt, jn), (tt, tn) = _both_generate((), prompts, 8, 8, [0.0] * 3, eos=eos)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tn, jn)
    assert tn[0] <= 2 and (tt[0, tn[0]:] == 0).all()


def test_sampled_generation_matches_jax_token_for_token():
    """A temperature-0.8 batch (one greedy row among sampled ones): the
    key split per step and the one-key categorical give JAX's draws."""
    prompts = [[7, 13, 21], [4, 4, 4, 4], [9, 2, 33, 50, 12]]
    for seed in (0, 7):
        (jt, jn), (tt, tn) = _both_generate((), prompts, 8, 10,
                                            [0.8, 0.0, 0.8], seed=seed)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tn, jn)


def test_threefry_split_and_one_key_categorical_bit_for_bit():
    rng = np.random.default_rng(4)
    for seed in (0, 1, 1234, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        for _ in range(3):
            want = np.asarray(jax.random.split(key))
            got = threefry.split(torch.tensor(np.asarray(key).astype(np.int64)))
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
            key = want[0]
        for B, V in ((1, 5), (3, 64), (4, 257)):
            logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
            want = jax.random.categorical(key, jnp.asarray(logits), axis=-1)
            got = threefry.categorical_one_key(
                torch.tensor(np.asarray(key).astype(np.int64)),
                torch.tensor(logits))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ the runtime


def test_tokenizer_matches_jax():
    texts = ["", "hello world", "Hello, World!", "The [MASK] sat on the mat.",
             "[mask][MASK] mixed [Mask]", "naïve café — ünïcode ✓ 日本語",
             "tabs\tand\nnewlines  ", "a.b,c;d:e?f!", "x" * 50, "123 4.5e6"]
    for vocab in (64, 512, 30522):
        want, got = JaxTokenizer(vocab), SimpleTokenizer(vocab)
        for t in texts:
            assert got.encode(t) == want.encode(t), t


def _runtimes(over=(), seed=0, **kw):
    jmodel, params, tmodel = _models(over)
    kw = {"max_new_tokens": 5, **kw}
    jrt = jgen.LMRuntimeModel(
        "lm", None, config=jmodel.cfg, seed=seed,
        buckets=JaxBuckets(batch_sizes=(1, 4), seq_lens=(8, 32)), **kw)
    jrt.load()
    jrt._params = jax.device_put(params)
    trt = tgen.LMRuntimeModel(
        "lm", config=tmodel.cfg, seed=seed, device="cpu",
        state_dict=tmodel.state_dict(),
        buckets=BucketSpec(batch_sizes=(1, 4), seq_lens=(8, 32)), **kw)
    trt.load()
    return jrt, trt


def _predict(rt, instances):
    return rt.postprocess(rt.predict(rt.preprocess({"instances": instances})))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_lm_runtime_serves_v1_and_v2_like_jax():
    """Text, ``{"text"}``, ``{"input_ids"}`` and bare rows across both
    buckets, greedy, over ``/v1/models/lm:predict`` and
    ``/v2/models/lm/generate``: the JAX runtime's predictions; streaming
    answers 501, as the JAX server does for a non-engine model."""
    jrt, trt = _runtimes()
    instances = ["hello world", {"text": "The [MASK] sat."},
                 {"input_ids": [4, 5, 6]}, list(range(2, 22))]
    want = _predict(jrt, instances)
    server = ModelServer([trt], http_port=0).start()
    try:
        assert _post(server.port, "/v1/models/lm:predict",
                     {"instances": instances}) == (200, want)
        for inst in instances:
            row = inst if isinstance(inst, dict) else (
                {"text": inst} if isinstance(inst, str) else {"input_ids": inst})
            w = _predict(jrt, [row])["predictions"][0]
            assert _post(server.port, "/v2/models/lm/generate", row) == (200, w)
        status, body = _post(server.port, "/v2/models/lm/generate_stream",
                             {"input_ids": [4, 5]})
        assert status == 501 and "stream" in body["error"]
    finally:
        server.stop()
    assert trt.stats["requests"] == 1 + len(instances)
    assert all(len(p["token_ids"]) <= 5 for p in want["predictions"])


def test_seeded_lm_runtime_samples_jax_tokens():
    """``PRNGKey(seed)`` split once a request, as in JAX: a sequence of
    sampled requests gives the JAX runtime's tokens."""
    jrt, trt = _runtimes(seed=11, max_new_tokens=8)
    for inst in ([{"input_ids": [7, 13, 21], "temperature": 0.8},
                  {"input_ids": [4, 4, 4], "temperature": 0.0}],
                 [{"text": "sample me", "temperature": 1.3}],
                 [{"input_ids": list(range(3, 20)), "temperature": 0.8}] * 3):
        assert _predict(trt, inst) == _predict(jrt, inst)


def test_lm_runtime_through_default_registry(tmp_path):
    reg = default_registry()
    rt = reg.resolve(PredictorSpec(model_format="causal-lm"))
    assert rt.name == "kubeflow-tpu-causal-lm"
    m = rt.factory("gen", None, config=TransformerConfig(**KW), device="cpu",
                   max_new_tokens=3)
    m.load()
    out = _predict(m, ["hi"])
    assert 0 < len(out["predictions"][0]["token_ids"]) <= 3
    eng_rt = reg.resolve(PredictorSpec(model_format="vllm"))
    assert eng_rt.name == "kubeflow-tpu-causal-lm-engine"
    assert reg.resolve(PredictorSpec(runtime="kubeflow-tpu-causal-lm")) is rt
    # BERT resolves to the predictor runtime (ROADMAP item 8 is ported)
    for fmt, name in (("bert", "kubeflow-tpu-bert"),
                      ("huggingface", "kubeflow-tpu-bert"),
                      ("bert-tiny", "kubeflow-tpu-bert-tiny")):
        assert reg.resolve(PredictorSpec(model_format=fmt)).name == name
    bert = reg.resolve(PredictorSpec(model_format="bert-tiny")).factory(
        "b", None, device="cpu",
        buckets=BucketSpec(batch_sizes=(1, 2), seq_lens=(16,)))
    bert.load()
    preds = _predict(bert, ["hello [MASK] world", "the cat sat"])["predictions"]
    assert len(preds) == 2 and len(preds[0]) == 16
    # the classic formats resolve to their runtimes, as in JAX, and predict
    for fmt in ("sklearn", "xgboost", "lightgbm", "pmml"):
        assert reg.resolve(PredictorSpec(model_format=fmt)).name == f"kubeflow-tpu-{fmt}"
        assert reg.resolve(PredictorSpec(runtime=f"kubeflow-tpu-{fmt}")).name == (
            f"kubeflow-tpu-{fmt}")
    pmml = tmp_path / "model.pmml"
    pmml.write_text(
        '<PMML version="4.4"><DataDictionary><DataField name="x0"/>'
        '<DataField name="x1"/></DataDictionary><RegressionModel '
        'functionName="regression"><RegressionTable intercept="1.5">'
        '<NumericPredictor name="x0" coefficient="2.0"/>'
        '<NumericPredictor name="x1" coefficient="-0.5"/></RegressionTable>'
        '</RegressionModel></PMML>')
    lin = reg.resolve(PredictorSpec(model_format="pmml")).factory(
        "lin", str(pmml), device="cpu")
    lin.load()
    assert _predict(lin, [[1.0, 2.0], [0.0, 4.0]]) == {"predictions": [2.5, -0.5]}
    with pytest.raises(ValueError, match="no runtime"):
        reg.resolve(PredictorSpec(model_format="onnx"))


def test_engine_from_runtime_serves_the_runtime_weights():
    """``engine_from_runtime`` wraps a runtime's model in a dense engine
    whose greedy stream equals the runtime's own generation."""
    _, trt = _runtimes(max_new_tokens=6)
    want = _predict(trt, [[5, 9, 17, 3]])["predictions"][0]["token_ids"]
    eng = engine_from_runtime(trt, max_batch=2, max_seq=32,
                              prefill_buckets=(8,))
    try:
        assert eng.pager is None  # the dense cache, the JAX default
        assert eng.submit([5, 9, 17, 3], max_new_tokens=6) == want
    finally:
        eng.stop()


def test_learned_positions_overflow_fails_loudly():
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.LMRuntimeModel(
            "lm", config=TransformerConfig(**KW, use_rope=False, max_seq_len=16),
            buckets=BucketSpec(batch_sizes=(1,), seq_lens=(8,)),
            max_new_tokens=32, device="cpu")


def test_train_checkpoint_serves_through_storage_path(tmp_path):
    """The train → serve handoff: a ``Trainer.fit`` checkpoint directory
    serves as the runtime's weights (the newest step's model state), as
    does a bare ``state.pt``."""
    from kubeflow_tpu_torch.data.synthetic import TokenLMDataset, local_shard_iterator
    from kubeflow_tpu_torch.models.transformer import make_init_fn, make_loss_fn
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adamw

    cfg = TransformerConfig(**KW)
    trainer = Trainer(
        init_params=make_init_fn(cfg), loss_fn=make_loss_fn(),
        optimizer=adamw(1e-3),
        config=TrainConfig(
            mesh=None, global_batch=8, steps=3, log_every=10,
            checkpoint=CheckpointConfig(directory=str(tmp_path / "ckpt"),
                                        save_every_steps=1, async_save=False)),
        device="cpu",
    )
    ds = TokenLMDataset(vocab_size=cfg.vocab_size, seq_len=16)
    state, _ = trainer.fit(lambda s: local_shard_iterator(ds, 8, start_step=s))
    trained = state.model.state_dict()
    torch.save(dict(trained), tmp_path / "bare.pt")
    for path in (tmp_path / "ckpt", tmp_path / "bare.pt"):
        m = tgen.LMRuntimeModel(
            "chat", str(path), config=cfg, max_new_tokens=4, device="cpu",
            buckets=BucketSpec(batch_sizes=(1,), seq_lens=(8,)))
        m.load()
        for k, v in m._lm.state_dict().items():
            torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
        out = _predict(m, [[3, 5, 7]])
        assert 0 < len(out["predictions"][0]["token_ids"]) <= 4


def test_missing_storage_path_fails_closed(tmp_path):
    m = tgen.LMRuntimeModel("lm", str(tmp_path / "nope"),
                            config=TransformerConfig(**KW), device="cpu")
    with pytest.raises(RuntimeError, match="does not exist"):
        m.load()
    assert not m.ready and m._lm is None
    # the probe must not have made the directory
    assert not (tmp_path / "nope").exists()
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="neither"):
        tgen.LMRuntimeModel("lm", str(tmp_path / "empty"),
                            config=TransformerConfig(**KW), device="cpu").load()
