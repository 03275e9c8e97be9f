"""The PyTorch port's attention ops against the JAX package's.

``kubeflow_tpu_torch.ops`` holds two hand-written CUDA kernels, each
beside a plain PyTorch twin; on CPU tensors the wrappers run the twin.
Here the twin is held against the JAX function on the same numpy inputs:
the Pallas kernel under ``interpret=True`` and the plain
``reference_attention``. Everything is f32, so the only difference is
summation order: tolerance 1e-5 absolute on values of order 1.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops import paged_attention as tpa

# the JAX ``ops`` package re-exports functions under the modules' names
jfa = importlib.import_module("kubeflow_tpu.ops.flash_attention")
jpa = importlib.import_module("kubeflow_tpu.ops.paged_attention")

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ paged attention

# the oracle cases of tests/test_paged_attention.py, plus the pos0=0 edge
# and a dead row whose whole table is the scratch page; then windows of 12
# pages, more than the 4 warps of a page-split kernel block, and a decode
# that sees only its last page (the other warps' partials are empty)
PAGED_CASES = [
    ("decode", dict()),
    ("gqa_span", dict(S=5)),
    ("window", dict(S=3, window=24)),
    ("mha", dict(H=2, Hkv=2)),
    ("int8_span", dict(S=5, quant=True)),
    ("int8_window", dict(S=2, window=20, quant=True)),
    ("pos0_zero", dict(pos0_zero=True)),
    ("dead_row", dict(S=4, dead_row=True)),
    ("many_pages_decode", dict(W_pages=12, n_pages=16)),
    ("many_pages_gqa_window", dict(S=5, window=150, W_pages=12, n_pages=16)),
    ("many_pages_int8_span", dict(S=3, quant=True, W_pages=12, n_pages=16)),
    ("last_page_only_decode", dict(window=16, W_pages=12, n_pages=16)),
]


def _paged_inputs(seed, *, H=4, Hkv=2, S=1, window=None, quant=False,
                  pos0_zero=False, dead_row=False, n_pages=8, W_pages=4):
    rng = np.random.default_rng(seed)
    B, D, P = 2, 64, 16
    T = n_pages * P
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    kp = rng.normal(size=(Hkv, T, D)).astype(np.float32)
    vp = rng.normal(size=(Hkv, T, D)).astype(np.float32)
    table = np.zeros((B, W_pages), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    table[0] = perm[:W_pages]
    table[1] = perm[:W_pages][::-1]
    # row 1 ends mid-page so the partial-last-page mask runs every time
    pos0 = np.array([W_pages * P - S, (W_pages - 1) * P - S], np.int32)
    if pos0_zero:
        pos0[:] = 0
    if dead_row:
        table[1] = 0
    return dict(q=q, kp=kp, vp=vp, table=table, pos0=pos0, P=P,
                window=window, quant=quant)


@pytest.mark.parametrize("name,kw", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_matches_jax_kernel(name, kw):
    x = _paged_inputs(sum(map(ord, name)), **kw)
    jk, jv = jnp.asarray(x["kp"]), jnp.asarray(x["vp"])
    jks = jvs = tks = tvs = None
    tk, tv = _t(x["kp"]), _t(x["vp"])
    if x["quant"]:
        jk, jks = jpa.quantize_kv(jk)
        jv, jvs = jpa.quantize_kv(jv)
        tk, tks = tpa.quantize_kv(tk)
        tv, tvs = tpa.quantize_kv(tv)
    want = jpa.paged_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["table"]),
        jnp.asarray(x["pos0"]), page_size=x["P"], window=x["window"],
        k_scale=jks, v_scale=jvs, interpret=True,
    )
    got = tpa.paged_attention(
        _t(x["q"]), tk, tv, _t(x["table"]), _t(x["pos0"]),
        page_size=x["P"], window=x["window"], k_scale=tks, v_scale=tvs,
    )
    assert got.dtype == torch.float32 and got.shape == x["q"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.isfinite(got.numpy()).all()


def test_paged_attention_rejects_bad_shapes():
    x = _paged_inputs(0)
    q, k, v = _t(x["q"]), _t(x["kp"]), _t(x["vp"])
    table, pos0 = _t(x["table"]), _t(x["pos0"])
    with pytest.raises(ValueError, match="multiple of page"):
        tpa.paged_attention(q, k, v, table, pos0, page_size=24)
    with pytest.raises(ValueError, match="kv heads"):
        tpa.paged_attention(q[:, :3], k, v, table, pos0, page_size=16)
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(q, k, v, table, pos0, page_size=16,
                            k_scale=torch.ones(k.shape[:2]))


def test_quantize_kv_bit_equal_to_jax():
    """Codes and scales bit-for-bit, including exact halves (both
    frameworks round half to even) and an all-zero vector."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 40, 64)) * 3.0).astype(np.float32)
    x[0, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]  # scale 1: halves exactly
    x[0, 0, 5:] = 0.0
    x[1, 3] = 0.0
    jc, js = jpa.quantize_kv(jnp.asarray(x))
    tc, ts = tpa.quantize_kv(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert list(tc[0, 0, :5]) == [127, 0, 2, 2, 0]
    np.testing.assert_array_equal(
        tpa.dequantize_kv(tc, ts).numpy(),
        np.asarray(jpa.dequantize_kv(jc, js)),
    )


# ------------------------------------------------------------ flash attention

FLASH_CASES = [
    ("causal", dict()),
    ("window", dict(window=12)),
    ("segments", dict(seg=True)),
    ("window_segments", dict(window=20, seg=True)),
    ("bidirectional", dict(causal=False)),
    # q segment 2 appears in no kv row: those rows see no key and end with
    # out = mean(v) and lse at the -1e30 sentinel (the backward's dead rows)
    ("dead_rows", dict(causal=False, dead=True)),
]


def _flash_inputs(seed, *, seg=False, B=2, H=2, S=64, D=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32)
               for _ in range(3))
    ids = None
    if seg:
        ids = np.zeros((B, S), np.int32)
        ids[0, 20:] = 1
        ids[0, 45:] = 2
        ids[1, 33:] = 1
    return q, k, v, ids


@pytest.mark.parametrize("name,kw", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_matches_jax(name, kw):
    causal = kw.get("causal", True)
    window = kw.get("window")
    seed = sum(map(ord, name))
    q, k, v, ids = _flash_inputs(seed, seg=kw.get("seg", False))
    kv_ids = ids
    if kw.get("dead"):
        rng = np.random.default_rng(seed)
        B, _, S, _ = q.shape
        kv_ids = rng.integers(0, 2, size=(B, S)).astype(np.int32)
        ids = rng.integers(0, 3, size=(B, S)).astype(np.int32)
    jseg = None if ids is None else jnp.asarray(ids)
    jkseg = None if kv_ids is None else jnp.asarray(kv_ids)
    tseg = None if ids is None else _t(ids)
    tkseg = None if kv_ids is None else _t(kv_ids)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    # 16-wide blocks: 4 x 4 tiles, so the tile skip and online softmax run
    want, want_lse = jfa.flash_attention(
        jq, jk, jv, causal=causal, window=window, q_segment_ids=jseg,
        kv_segment_ids=jkseg, block_q=16, block_k=16, interpret=True,
        return_residuals=True,
    )
    want_ref = jfa.reference_attention(
        jq, jk, jv, causal=causal, window=window, q_segment_ids=jseg,
        kv_segment_ids=jkseg,
    )
    if kw.get("dead"):
        dead = np.asarray(want_lse) <= tfa.NEG_INF / 2
        assert dead.any() and not dead.all()
        np.testing.assert_allclose(np.asarray(want)[dead],
                                   np.broadcast_to(v.mean(2, keepdims=True),
                                                   v.shape)[dead],
                                   atol=ATOL, rtol=0)
    tq, tk, tv = map(_t, (q, k, v))
    kw_t = dict(causal=causal, window=window, q_segment_ids=tseg,
                kv_segment_ids=tkseg)
    got, got_lse = tfa.flash_attention(tq, tk, tv, return_residuals=True, **kw_t)
    assert got_lse.shape == q.shape[:3] and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tfa.flash_attention(tq, tk, tv, **kw_t).numpy(), np.asarray(want),
        atol=ATOL, rtol=0,
    )
    np.testing.assert_allclose(
        tfa.reference_attention(tq, tk, tv, **kw_t).numpy(),
        np.asarray(want_ref), atol=ATOL, rtol=0,
    )


BODY_CASES = [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.float16, 16, "mma"),
    (torch.float16, 64, "mma"), (torch.float16, 128, "mma"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar"),
    (torch.bfloat16, 40, "scalar"), (torch.float16, 40, "scalar"),
    (torch.bfloat16, 8, "scalar"),
]


@pytest.mark.parametrize("dtype,head_dim,want", BODY_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in BODY_CASES])
def test_kernel_body_dispatch(dtype, head_dim, want):
    """The Python mirror of the C entry points' choice of body: tensor
    cores for bf16/f16 with D a multiple of 16 up to 128, scalar f32
    arithmetic for f32 (a tensor-core f32 product would be TF32) and any
    other D; the forward and dk/dv kernels share the rule."""
    from kubeflow_tpu_torch.ops import flash_attention_bwd as tfb

    assert tfa.body(dtype, head_dim) == want
    assert tfb.dq_body(dtype, head_dim) == want
    assert tfb.dkv_body(dtype, head_dim) == want


def test_kernel_body_dispatch_matches_the_c_sources():
    """Both sources dispatch on the same condition the mirror states, and
    each of the three C entry points (forward, dq, dk/dv) takes its
    tensor-core body on exactly that condition."""
    import re

    rule = "(dtype == BF16 || dtype == F16) && D % 16 == 0 && D <= 128"
    for name in ("flash_attention", "flash_attention_bwd"):
        assert rule in (_build.CSRC / f"{name}.cu").read_text(), name
    for name, entry, launcher in (
        ("flash_attention", "kft_flash_forward", "launch_mma_any"),
        ("flash_attention_bwd", "kft_flash_bwd_dq", "launch_dq_mma_any"),
        ("flash_attention_bwd", "kft_flash_bwd_dkv", "launch_dkv_mma_any"),
    ):
        src = (_build.CSRC / f"{name}.cu").read_text()
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        branch = re.search(r"if \(mma_body\(dtype, D\)\) \{(.*?)\n  \}", body, re.S)
        assert branch is not None, entry
        assert launcher in branch.group(1), entry


def test_paged_kernel_body_and_shapes():
    """One paged body, the page-split kernel; the head dims it takes (D
    up to 128, pool rows of whole 16-byte chunks) are the ones the CUDA
    launcher checks."""
    assert tpa.body() == "split"
    assert "paged_attn_split_kernel" in (_build.CSRC / "paged_attention.cu").read_text()
    for d, dt, ok in ((64, torch.bfloat16, True), (128, torch.float32, True),
                      (16, torch.int8, True), (8, torch.int8, False),
                      (36, torch.bfloat16, False), (256, torch.bfloat16, False),
                      (4, torch.float32, True)):
        assert tpa.kernel_supports(d, dt) is ok, (d, dt)


def test_reference_attention_mask_is_bottom_right_aligned():
    """Sq < Skv (a suffix of queries): ``_full_mask`` puts query i at
    position i + Skv - Sq, as the JAX mask does."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 2, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 24, 16)).astype(np.float32) for _ in range(2))
    for window in (None, 6):
        want = jfa.reference_attention(*map(jnp.asarray, (q, k, v)),
                                       causal=True, window=window)
        got = tfa.reference_attention(*map(_t, (q, k, v)), causal=True,
                                      window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_attention_rejects_bad_args():
    q, k, v, _ = _flash_inputs(0)
    tq, tk, tv = map(_t, (q, k, v))
    with pytest.raises(ValueError, match="repeat kv heads"):
        tfa.flash_attention(tq, tk[:, :1], tv[:, :1], causal=True)
    with pytest.raises(ValueError, match="needs causal"):
        tfa.flash_attention(tq, tk, tv, causal=False, window=4)
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention(tq, tk, tv, q_segment_ids=torch.zeros(2, 64))


# ------------------------------------------------------------ device routing

def test_cpu_calls_never_touch_the_kernel_build(monkeypatch):
    """CPU tensors run the plain twins: no nvcc, no library, no launch."""

    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    before = (tpa.LAUNCHES, tfa.LAUNCHES)
    x = _paged_inputs(1, S=2)
    tpa.paged_attention(_t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(x["table"]),
                        _t(x["pos0"]), page_size=x["P"])
    q, k, v, ids = _flash_inputs(1, seg=True)
    tfa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                        q_segment_ids=_t(ids), kv_segment_ids=_t(ids),
                        return_residuals=True)
    assert (tpa.LAUNCHES, tfa.LAUNCHES) == before


def test_every_kernel_source_builds_to_a_hash_named_library(tmp_path, monkeypatch):
    """The build target is keyed by the source and flags: an edited
    kernel gets a new file name, so a stale library is never loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build._target("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build._target("k")
    assert second != first
    assert first.suffix == ".so" and first.name.startswith("k-")
    # a shared header is part of every kernel's key, and not a kernel
    (tmp_path / "shared.cuh").write_text("// helpers\n")
    assert _build._target("k") != second
    assert _build.sources() == ["k"]


# ------------------------------------------------- flash attention backward

BWD_CASES = [
    ("causal", dict()),
    ("bidirectional", dict(causal=False)),
    ("window", dict(window=24)),
    ("segments", dict(seg=True)),
    # q segment 2 appears in no kv row: those query rows are dead (lse at
    # the -1e30 sentinel) and contribute exactly 0
    ("dead_rows", dict(causal=False, dead=True)),
]


def _bwd_inputs(name, *, seg=False, dead=False, B=2, H=2, S=96, D=32):
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, dout = (rng.normal(size=(B, H, S, D)).astype(np.float32)
                     for _ in range(4))
    qids = kids = None
    if seg:
        qids = np.zeros((B, S), np.int32)
        qids[0, 20:] = 1
        qids[0, 70:] = 2
        qids[1, 41:] = 1
        kids = qids
    if dead:
        kids = rng.integers(0, 2, size=(B, S)).astype(np.int32)
        qids = rng.integers(0, 3, size=(B, S)).astype(np.int32)
    return q, k, v, dout, qids, kids


@pytest.mark.parametrize("name,kw", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_attention_bwd_reference_matches_jax_kernels(name, kw):
    """The backward twin against the JAX ``flash_attention_bwd`` run with
    32-wide blocks in interpret mode (3 x 3 tiles: the causal and window
    tile skips run), from the same forward residuals. f32: summation
    order only, atol 2e-5 on gradients of order 1."""
    causal = kw.get("causal", True)
    window = kw.get("window")
    q, k, v, dout, qids, kids = _bwd_inputs(
        name, seg=kw.get("seg", False), dead=kw.get("dead", False))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, dout))
    jseg = {} if qids is None else dict(
        q_segment_ids=jnp.asarray(qids), kv_segment_ids=jnp.asarray(kids))
    out, lse = jfa.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32,
        interpret=True, return_residuals=True, **jseg)
    want = jfa.flash_attention_bwd(
        jq, jk, jv, out, lse, jdo, causal=causal, window=window, block_q=32,
        block_k=32, interpret=True, **jseg)
    tseg = {} if qids is None else dict(
        q_segment_ids=_t(qids), kv_segment_ids=_t(kids))
    got = tfa.flash_attention_bwd(
        *map(_t, (q, k, v, np.asarray(out), np.asarray(lse), dout)),
        causal=causal, window=window, **tseg)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == q.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0, err_msg=n)
    if kw.get("dead"):
        dead = np.asarray(lse) <= tfa.NEG_INF / 2
        assert dead.any()
        assert (got[0].numpy()[dead] == 0).all()


GRAD_CASES = [
    ("causal", dict()),
    ("window", dict(window=12)),
    ("segments", dict(seg=True)),
]


@pytest.mark.parametrize("name,kw", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_flash_attention_grad_through_autograd_function_matches_jax(name, kw):
    """``torch.autograd.grad`` of sum(out**2) through the port's
    ``flash_attention`` on CPU tensors (the ``_FlashAttention`` function:
    twin forward, twin backward) against ``jax.grad`` of the JAX
    ``flash_attention`` under interpret mode. f32, atol 1e-5. Inputs are
    halved: dO = 2·out makes dp − delta a difference of two O(|v|²·D)
    numbers, whose f32 rounding then sets the error floor."""
    import jax

    window = kw.get("window")
    q, k, v, _, qids, _ = _bwd_inputs(name, seg=kw.get("seg", False), S=64)
    q, k, v = (0.5 * x for x in (q, k, v))
    jseg = {} if qids is None else dict(
        q_segment_ids=jnp.asarray(qids), kv_segment_ids=jnp.asarray(qids))

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=16, block_k=16, interpret=True,
                                  **jseg)
        return (out * out).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tseg = {} if qids is None else dict(
        q_segment_ids=_t(qids), kv_segment_ids=_t(qids))
    out = tfa.flash_attention(tq, tk, tv, causal=True, window=window, **tseg)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad((out * out).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_cpu_backward_runs_the_twin_not_the_kernels(monkeypatch):
    """A CPU gradient goes through ``flash_attention_bwd`` into its plain
    twin once per backward, and never reaches a kernel launcher."""
    from kubeflow_tpu_torch.ops import flash_attention_bwd as tfb

    calls = []
    twin = tfa.flash_attention_bwd_reference

    def counting(*a, **k):
        calls.append(1)
        return twin(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a CPU backward reached a kernel launcher")

    monkeypatch.setattr(tfa, "flash_attention_bwd_reference", counting)
    monkeypatch.setattr(tfb, "launch_dq", refuse)
    monkeypatch.setattr(tfb, "launch_dkv", refuse)
    before = (tfb.DQ_LAUNCHES, tfb.DKV_LAUNCHES)
    q, k, v, _ = _flash_inputs(3)
    tq = _t(q).requires_grad_()
    tfa.flash_attention(tq, _t(k), _t(v), causal=True).sum().backward()
    assert calls == [1] and tq.grad is not None
    assert (tfb.DQ_LAUNCHES, tfb.DKV_LAUNCHES) == before


def test_backward_kernel_wrappers_reject_cpu_and_bad_residuals():
    """The launchers take CUDA tensors of the kernel's contract only; a
    CPU tensor never silently runs the twin there."""
    from kubeflow_tpu_torch.ops import flash_attention_bwd as tfb

    q, k, v, dout, _, _ = _bwd_inputs("reject", S=32)
    tq, tk, tv, tdo = map(_t, (q, k, v, dout))
    lse = torch.zeros(q.shape[:3])
    kw = dict(causal=True, scale=0.125, q_segment_ids=None,
              kv_segment_ids=None, window=None)
    with pytest.raises(TypeError, match="lse must be f32"):
        tfb.launch_dq(tq, tk, tv, tdo, lse[..., :8].contiguous(), lse, **kw)
    with pytest.raises(TypeError, match="dout"):
        tfb.launch_dkv(tq, tk, tv, tdo.double(), lse, lse, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.launch_dq(tq, tk, tv, tdo.transpose(2, 3), lse, lse, **kw)
