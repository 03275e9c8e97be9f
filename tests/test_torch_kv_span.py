"""KV movement between replicas in ``kubeflow_tpu_torch`` against the JAX
engine: the mirror of ``tests/test_kv_span.py``, at its size (2 layers,
d_model 32, 4 heads, f32, 16-token pages) on bridged weights.

A decode engine handed a prefill engine's finished span through the npz
codec runs zero prefill pieces and gives the tokens of a colocated
engine, the JAX one's included: paged and paged-int8, pipelined and
synchronous, greedy and seeded, with and without K=4 speculation, and
with the span made by either framework. The two codecs write the same
bytes for the same f32, int8 and bf16 trees. Spans whose quantization,
layout, dtype or meta do not fit are rejected. The host tier swaps a
session's KV out and back in byte for byte, and its LRU keeps the JAX
tier's counts. A failed ship falls back to a local prefill with the
same tokens. Dense mode is covered in ``test_torch_engine_dense.py``.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve import kv_codec as jcodec
from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
from kubeflow_tpu.serve.kv_tier import HostKVTier as JaxTier
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.serve import kv_codec as tcodec
from kubeflow_tpu_torch.serve.engine import LMEngine, fetch_kv_span
from kubeflow_tpu_torch.serve.kv_tier import HostKVTier

KW = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, d_ff=64,
          max_seq_len=256)
ENGINE = dict(max_batch=2, max_seq=128, prefill_buckets=(32, 64), chunk_steps=4)
PAGED = {"kv_pool_tokens": 1024, "page_size": 16}
QUANT = {"none": PAGED, "int8": {**PAGED, "kv_quant": "int8"}}
PROMPT = [5, 9, 11, 3, 7, 22, 40, 8, 15, 2, 33, 6, 19, 44, 12, 9, 27, 5, 61, 3]
MAX_NEW = 12
DEAD_PEER = "http://127.0.0.1:1"


def _motif_prompts():
    """Prompts that repeat a motif, so K=4 prompt lookup drafts; the
    lengths take both prefill buckets and a partial 16-token window."""
    rng = np.random.default_rng(7)
    out = []
    for n in (20, 27, 37):
        motif = [int(t) for t in rng.integers(2, KW["vocab_size"], size=6)]
        out.append((motif * 8)[:n])
    return out


PROMPTS = _motif_prompts()


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


@functools.lru_cache(maxsize=None)
def _weights(n_heads=4):
    kw = {**KW, "n_heads": n_heads}
    jcfg = JaxConfig(**kw, attn_impl="reference", dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = TransformerLM(TransformerConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_to_state_dict(params))
    return jmodel, jcfg, params, tmodel.eval().requires_grad_(False)


def _jax(quant="none", **kw):
    jmodel, jcfg, params, _ = _weights()
    return JaxEngine(jmodel, jcfg, params, **{**ENGINE, **QUANT[quant], **kw}).start()


def _torch(quant="none", n_heads=4, **kw):
    model = _weights(n_heads)[3]
    return LMEngine(model, **{**ENGINE, **QUANT[quant], **kw}).start()


def _sampling(sampled, i):
    return dict(temperature=0.9, seed=1234 + i) if sampled else {}


def _burst(eng, prompts, sampled, spans=None):
    """All prompts at once (rows churn through 2 slots)."""
    with ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(eng.submit, p, max_new_tokens=MAX_NEW,
                          kv_span=None if spans is None else spans[i],
                          **_sampling(sampled, i))
                for i, p in enumerate(prompts)]
        return [f.result() for f in futs]


def _wire(tree, meta, ids, encode=tcodec.encode_kv_entries,
          decode=tcodec.decode_kv_entries):
    """One span through a codec pair: ``(host tree, meta)`` as received."""
    entries, got_meta = decode(encode([(tuple(ids), tree)], meta))
    (key, host_tree), = entries
    assert list(key) == list(ids)
    return host_tree, got_meta


@functools.lru_cache(maxsize=None)
def _jax_colocated(quant, spec, sampled):
    eng = _jax(quant, spec_draft_tokens=spec)
    try:
        return _burst(eng, PROMPTS, sampled)
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def prefill_engines():
    engines = {q: _torch(q) for q in QUANT}
    try:
        yield engines
    finally:
        for e in engines.values():
            e.stop()


def _torch_spans(pre, dec, sampled):
    spans = []
    for i, p in enumerate(PROMPTS):
        s = _sampling(sampled, i)
        tree, meta = pre.prefill_span(p, **s)
        spans.append(dec.prepare_kv_span(p, *_wire(tree, meta, p)))
    return spans


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("spec", [0, 4], ids=["k0", "k4"])
@pytest.mark.parametrize("depth", [1, 0], ids=["depth1", "depth0"])
@pytest.mark.parametrize("quant", list(QUANT))
def test_disagg_decode_runs_zero_prefill(prefill_engines, quant, depth, spec,
                                         sampled):
    pre = prefill_engines[quant]
    exported0 = pre.stats["kv_spans_exported"]
    chunks0 = pre.stats["chunks"]
    kw = dict(pipeline_depth=depth, spec_draft_tokens=spec)
    colo = _torch(quant, **kw)
    dec = _torch(quant, **kw)
    try:
        want = _burst(colo, PROMPTS, sampled)
        got = _burst(dec, PROMPTS, sampled, _torch_spans(pre, dec, sampled))
    finally:
        colo.stop()
        dec.stop()
    assert got == want == _jax_colocated(quant, spec, sampled)
    assert dec.stats["prefill_pieces"] == 0, dec.stats
    assert dec.stats["kv_injected"] == dec.stats["admitted"] == len(PROMPTS)
    assert pre.stats["kv_spans_exported"] - exported0 == len(PROMPTS)
    assert pre.stats["chunks"] == chunks0  # a prefill replica never decodes
    if spec:
        # the drafter reads the injected rows' prompt and first token
        for key in ("spec_proposed", "spec_accepted"):
            assert dec.stats[key] == colo.stats[key], key
        if not sampled:
            assert dec.stats["spec_proposed"] > 0


@pytest.mark.parametrize("quant", list(QUANT))
def test_jax_span_into_torch_decode(quant):
    """JAX ``prefill_span`` → JAX codec → the port's decode engine."""
    pre = _jax(quant)
    dec = _torch(quant)
    try:
        spans = [dec.prepare_kv_span(p, *_wire(*pre.prefill_span(p), p,
                                               encode=jcodec.encode_kv_entries))
                 for p in PROMPTS]
        got = _burst(dec, PROMPTS, False, spans)
    finally:
        pre.stop()
        dec.stop()
    assert got == _jax_colocated(quant, 0, False)
    assert dec.stats["prefill_pieces"] == 0 and dec.stats["kv_injected"] == 3


@pytest.mark.parametrize("quant", list(QUANT))
def test_torch_span_into_jax_decode(quant):
    """The port's ``prefill_span`` → its codec → the JAX decode engine."""
    pre = _torch(quant)
    dec = _jax(quant)
    try:
        spans = [dec.prepare_kv_span(p, *_wire(*pre.prefill_span(p), p,
                                               decode=jcodec.decode_kv_entries))
                 for p in PROMPTS]
        got = _burst(dec, PROMPTS, False, spans)
    finally:
        pre.stop()
        dec.stop()
    assert got == _jax_colocated(quant, 0, False)
    assert dec.stats["prefill_pieces"] == 0 and dec.stats["kv_injected"] == 3


# ------------------------------------------------------------------ codec


def _tree(kind, n_layers=12):
    """A torch KV tree in the pool's order (layers_0..11; k, v, scales)
    and the JAX side's numpy tree, as a jitted function returns it."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    shape = (1, 2, 32, 8)
    tt = {}
    for i in range(n_layers):
        if kind == "int8":
            tt[f"layers_{i}"] = {
                **{w: torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
                   for w in ("k", "v")},
                **{w: torch.from_numpy(rng.random(shape[:3]).astype(np.float32))
                   for w in ("k_scale", "v_scale")}}
        else:
            dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
            tt[f"layers_{i}"] = {
                w: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
                for w in ("k", "v")}

    def to_jnp(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jt = jax.jit(lambda x: x)({n: {w: to_jnp(a) for w, a in lc.items()}
                              for n, lc in tt.items()})
    return tt, {n: {w: np.asarray(a) for w, a in lc.items()} for n, lc in jt.items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_codec_blobs_byte_equal_to_jax(kind):
    tt, jtree = _tree(kind)
    key = tuple(range(32))
    meta = {"real_len": 30, "first_tok": 5, "valid": True}
    tblob = tcodec.encode_kv_entries([(key, tcodec.tree_to_numpy(tt))], meta)
    jblob = jcodec.encode_kv_entries([(key, jtree)], meta)
    assert tblob == jblob
    assert tcodec.encode_kv_entries([(key, tcodec.tree_to_numpy(tt))]) == \
        jcodec.encode_kv_entries([(key, jtree)])
    # the port reads the JAX blob back bit for bit into a pool of its dtype
    (got_key, host), = tcodec.decode_kv_entries(jblob)[0]
    assert got_key == key and tcodec.decode_kv_entries(jblob)[1] == meta
    for name, lc in tt.items():
        for which, t in lc.items():
            back = tcodec.numpy_to_pool(host[name][which], t)
            assert back.dtype == t.dtype and torch.equal(_bits(back), _bits(t))
    if kind == "bf16":
        # the reference defect the port reads around: numpy gives the
        # plane back as a 2-byte void, which jnp.asarray refuses
        (_, jhost), = jcodec.decode_kv_entries(jblob)[0]
        plane = jhost["layers_0"]["k"]
        assert plane.dtype.kind == "V" and plane.dtype.itemsize == 2
        assert np.array_equal(plane.view(np.uint16),
                              jtree["layers_0"]["k"].view(np.uint16))
        with pytest.raises(TypeError):
            jnp.asarray(plane)


def test_plane_dtype_conversions():
    f32 = torch.zeros(2)
    bf16 = torch.zeros(2, dtype=torch.bfloat16)
    v2 = np.array([1.5, -2.0], ml_dtypes.bfloat16).view(np.uint16).view("V2")
    assert torch.equal(tcodec.numpy_to_pool(v2, bf16),
                       torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    for arr, like in ((v2, f32), (v2, torch.zeros(2, dtype=torch.float16)),
                      (np.zeros(2, np.float32), bf16),
                      (np.zeros(2, np.float64), f32)):
        with pytest.raises(ValueError, match="dtype"):
            tcodec.numpy_to_pool(arr, like)


# -------------------------------------------------------------- rejection


def test_mixed_quantization_rejected_both_directions():
    f32, i8 = _torch("none"), _torch("int8")
    try:
        with pytest.raises(ValueError, match="quant"):
            i8.prepare_kv_span(PROMPT, *_wire(*f32.prefill_span(PROMPT), PROMPT))
        tree8, meta8 = _wire(*i8.prefill_span(PROMPT), PROMPT)
        assert any("scale" in k for kv in tree8.values() for k in kv)
        with pytest.raises(ValueError, match="quant"):
            f32.prepare_kv_span(PROMPT, tree8, meta8)
    finally:
        f32.stop()
        i8.stop()


def test_layout_mismatch_rejected():
    """A span of 2 heads of 16 into an engine of 4 heads of 8."""
    pre, dec = _torch(n_heads=2), _torch()
    try:
        with pytest.raises(ValueError, match="shape"):
            dec.prepare_kv_span(PROMPT, *_wire(*pre.prefill_span(PROMPT), PROMPT))
    finally:
        pre.stop()
        dec.stop()


def test_malformed_meta_and_dtype_rejected():
    pre, dec = _torch(), _torch()
    try:
        tree, meta = _wire(*pre.prefill_span(PROMPT), PROMPT)
        with pytest.raises(ValueError, match="covers"):
            dec.prepare_kv_span(PROMPT, tree, {**meta, "real_len": 3})
        with pytest.raises(ValueError, match="malformed"):
            dec.prepare_kv_span(PROMPT, tree, {"first_tok": "nope"})
        # a bf16 span cannot enter an f32 pool
        bf16 = {n: {w: a.astype(ml_dtypes.bfloat16).view(np.uint16).view("V2")
                    for w, a in lc.items()} for n, lc in tree.items()}
        with pytest.raises(ValueError, match="dtype"):
            dec.prepare_kv_span(PROMPT, *_wire(bf16, meta, PROMPT))
        assert dec.import_prefix_entries([(tuple(PROMPT[:16]), {
            n: {w: a[:, :, :16] for w, a in lc.items()} for n, lc in bf16.items()
        })]) == 0
    finally:
        pre.stop()
        dec.stop()


# ------------------------------------------------------------- host tier


def _session_turns(eng, first):
    t1 = eng.submit(first, max_new_tokens=8, session="s1")
    assert eng.flush_offload()
    turn2 = first + t1 + [12, 13]
    t2 = eng.submit(turn2, max_new_tokens=8, session="s1")
    assert eng.flush_offload()
    return t1, t2


def test_host_tier_swap_is_byte_identical():
    """Turn 1 swaps out through the codec; turn 2 (turn 1's context plus
    two tokens) swaps it back in and continues as an engine whose row
    never left, and as the JAX engine's host tier does."""
    first = [4, 6, 8, 10] * 5
    ref = _torch()
    try:
        t1 = ref.submit(first, max_new_tokens=8)
        full = ref.submit(first + t1 + [12, 13], max_new_tokens=8)
    finally:
        ref.stop()
    jeng = _jax(host_kv_bytes=1 << 20)
    eng = _torch(host_kv_bytes=1 << 20)
    blobs = []
    put = eng.host_kv_tier.put
    eng.host_kv_tier.put = lambda s, k, b: blobs.append(b) or put(s, k, b)
    try:
        jt = _session_turns(jeng, first)
        got = _session_turns(eng, first)
        stats = dict(eng.stats)
        res = eng.host_kv_tier.resident()
    finally:
        jeng.stop()
        eng.stop()
    assert got == jt == (t1, full)
    assert stats["kv_offload_out"] == 2 and stats["kv_offload_in"] == 1
    assert res["rows"] == 1 and res["bytes"] == len(blobs[1])
    # turn 2 implanted turn 1's blob: its own span starts with those bytes
    (k1, tree1), = tcodec.decode_kv_entries(blobs[0])[0]
    (k2, tree2), = tcodec.decode_kv_entries(blobs[1])[0]
    n = len(k1)
    assert n >= 16 and len(k2) > n and k2[:n] == k1
    for name, lc in tree1.items():
        for which, arr in lc.items():
            assert np.array_equal(tree2[name][which][:, :, :n], arr)


def test_host_tier_divergent_session_reprefills():
    eng = _torch(host_kv_bytes=1 << 20)
    try:
        eng.submit([4, 6, 8, 10] * 5, max_new_tokens=4, session="s1")
        assert eng.flush_offload()
        before = eng.stats["prefill_pieces"]
        eng.submit([7, 7, 7] * 8, max_new_tokens=4, session="s1")
        assert eng.stats["kv_offload_in"] == 0
        assert eng.stats["prefill_pieces"] > before
        assert eng.host_kv_tier.stats["misses"] >= 1
    finally:
        eng.stop()


def test_host_tier_corrupt_blob_is_a_miss():
    ref = _torch()
    try:
        want = ref.submit(PROMPT, max_new_tokens=8)
    finally:
        ref.stop()
    eng = _torch(host_kv_bytes=1 << 20)
    try:
        eng.host_kv_tier.put("s1", PROMPT[:16], b"not an npz blob")
        assert eng.submit(PROMPT, max_new_tokens=8, session="s1") == want
        assert eng.stats["kv_offload_in"] == 0
        assert eng.host_kv_tier.stats["hits"] == 1  # taken, then refused
    finally:
        eng.stop()


def test_host_tier_lru_stats_match_jax():
    steps = [("put", "a", (1, 2), 60), ("put", "b", (3, 4), 60),
             ("take", "a", [1, 2, 3]), ("take", "b", [3, 4, 5]),
             ("put", "c", (5,), 101), ("put", "c", (5,), 30),
             ("put", "d", (6, 7), 40), ("take", "c", [9]),
             ("put", "e", (8,), 70), ("take", "d", [6, 7]),
             ("take", "e", [8, 1])]
    tiers = [HostKVTier(max_bytes=100), JaxTier(max_bytes=100)]
    for step in steps:
        outs = []
        for tier in tiers:
            if step[0] == "put":
                outs.append(tier.put(step[1], step[2], b"x" * step[3]))
            else:
                outs.append(tier.take(step[1], step[2]))
            outs.append((dict(tier.stats), tier.resident()))
        assert outs[:2] == outs[2:], step
    assert tiers[0].stats == {"puts": 5, "hits": 2, "misses": 3, "evictions": 2}


# -------------------------------------------------------------- fallbacks


def test_kv_ship_hook_and_dead_peer_fall_back_with_equal_tokens():
    ref = _torch()
    try:
        want = ref.submit(PROMPT, max_new_tokens=10)
    finally:
        ref.stop()
    dec = _torch()
    fired = []

    def drop(eng):
        eng._fault_hooks.pop("kv_ship", None)
        fired.append(eng)
        raise ConnectionResetError("prefill peer died mid-ship")

    dec._fault_hooks["kv_ship"] = drop
    try:
        assert fetch_kv_span(dec, DEAD_PEER, "m", PROMPT, 0.0, timeout_s=2.0) is None
        assert fired == [dec] and "kv_ship" not in dec._fault_hooks
        assert fetch_kv_span(dec, DEAD_PEER, "m", PROMPT, 0.0, timeout_s=2.0) is None
        assert dec.stats["kv_ship_fallbacks"] == 2
        assert dec.submit(PROMPT, max_new_tokens=10) == want  # local prefill
        assert dec.stats["kv_injected"] == 0 and dec.stats["prefill_pieces"] == 1
    finally:
        dec.stop()


# ------------------------------------------------- prefix-entry transfer


def test_prefix_entries_move_between_frameworks():
    """Entries exported by one framework's engine, through the other's
    codec, serve prefix hits in the other framework's engine."""
    shared = PROMPTS[2][:32]
    warm, probe = shared + [3, 9, 4], shared + [7, 7, 2, 5]
    out = {}
    for src_kind, dst_kind in (("torch", "jax"), ("jax", "torch")):
        mk = {"torch": _torch, "jax": _jax}
        src = mk[src_kind](prefix_cache_entries=4)
        dst = mk[dst_kind](prefix_cache_entries=4)
        try:
            src.submit(warm, max_new_tokens=4)
            entries = src.export_prefix_entries()
            assert [k for k, _ in entries] == [tuple(shared)]
            enc = (tcodec if src_kind == "torch" else jcodec).encode_kv_entries
            dec = (jcodec if dst_kind == "jax" else tcodec).decode_kv_entries
            assert dst.import_prefix_entries(dec(enc(entries))[0]) == 1
            assert dst.import_prefix_entries(dec(enc(entries))[0]) == 0
            out[dst_kind] = dst.submit(probe, max_new_tokens=MAX_NEW)
            assert dst.stats["prefix_hits"] == 1, dst_kind
            assert src.prefix_cache_stats()["exported"] == 1
            assert dst.prefix_cache_stats()["imported"] == 1
        finally:
            src.stop()
            dst.stop()
    ref = _torch()
    try:
        assert out["jax"] == out["torch"] == ref.submit(probe, max_new_tokens=MAX_NEW)
    finally:
        ref.stop()
