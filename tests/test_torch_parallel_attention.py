"""Ring attention and Ulysses in the port against the JAX package: the
cases of ``tests/test_attention.py``'s ring and Ulysses sections, with
their tolerances (outputs 2e-5, gradients 5e-4), plus segment ids riding
the ring, in one gloo world of 8 CPU ranks.

Each rank computes its block (batch over data, seq over ``seq``) with the
port's flash kernel's plain twin per hop; the blocks are assembled here
and held against the JAX ``ring_attention`` / ``ulysses_attention`` (the
Pallas kernels in interpret mode on the 8 CPU devices) for a causal,
segmented case with gradients, and against the JAX
``reference_attention`` (XLA, the JAX tests' own oracle) for the rest.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_worlds as tw
from kubeflow_tpu.core.mesh import MeshSpec, build_mesh
from kubeflow_tpu.ops.flash_attention import reference_attention
from kubeflow_tpu.parallel.ring_attention import ring_attention
from kubeflow_tpu.parallel.ulysses import ulysses_attention

OUT_ATOL, GRAD_ATOL = 2e-5, 5e-4
B, H, S, D = 2, 8, 256, 32
_rng = np.random.RandomState(0)
Q, K, V = (_rng.randn(B, H, S, D).astype(np.float32) / np.sqrt(D) for _ in range(3))
DOUT = np.random.RandomState(5).randn(B, H, S, D).astype(np.float32)


def _packed_segs():
    """(B, S) segment labels: three packed documents per row."""
    rng = np.random.RandomState(3)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = sorted(rng.choice(np.arange(8, S - 8), size=2, replace=False))
        seg[b, cuts[0]:cuts[1]] = 1
        seg[b, cuts[1]:] = 2
    return seg


SEG = _packed_segs()
SEQ8, DATA2_SEQ4 = dict(seq=8), dict(data=2, seq=4)
CASES = {
    # name: (impl, mesh, causal, segments, gradients)
    "ring_full": ("ring", SEQ8, False, False, False),
    "ring_causal": ("ring", SEQ8, True, False, False),
    "ring_grad_full": ("ring", DATA2_SEQ4, False, False, True),
    "ring_grad_causal": ("ring", DATA2_SEQ4, True, False, True),
    "ring_2d": ("ring", DATA2_SEQ4, True, False, False),
    "ring_seg_full": ("ring", SEQ8, False, True, False),
    "ring_seg_causal": ("ring", SEQ8, True, True, False),
    "ring_seg_grad": ("ring", DATA2_SEQ4, True, True, True),
    "ulysses_full": ("ulysses", SEQ8, False, False, False),
    "ulysses_causal": ("ulysses", SEQ8, True, False, False),
    "ulysses_seg_full": ("ulysses", SEQ8, False, True, False),
    "ulysses_seg_causal": ("ulysses", SEQ8, True, True, False),
    "ulysses_seg_grad": ("ulysses", SEQ8, True, True, True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    cases = [(name, dict(fn="attention", spec=mesh, impl=impl, q=Q, k=K, v=V,
                         causal=causal, seg=SEG if seg else None,
                         dout=DOUT if grad else None))
             for name, (impl, mesh, causal, seg, grad) in CASES.items()]
    cases += [
        ("ulysses_bad_heads", dict(fn="attention", spec=SEQ8, impl="ulysses",
                                   q=Q, k=K, v=V, causal=False, heads=6)),
        ("ring_global", dict(fn="attention_global", spec=DATA2_SEQ4, impl="ring",
                             q=Q, k=K, v=V, causal=True)),
        ("ulysses_global", dict(fn="attention_global", spec=SEQ8,
                                impl="ulysses", q=Q, k=K, v=V, causal=True)),
    ]
    box: dict = {}

    def torch_side():
        try:
            box["torch"] = tw.world(8, cases, tmp_path_factory.mktemp("world"))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=torch_side)
    th.start()
    jax_runs = {}
    seg = jnp.asarray(SEG)
    for impl, fn, spec in (("ring", ring_attention, DATA2_SEQ4),
                           ("ulysses", ulysses_attention, SEQ8)):
        mesh = build_mesh(MeshSpec(**spec))

        def loss(q, k, v, fn=fn, mesh=mesh):
            out = fn(q, k, v, mesh, causal=True, segment_ids=seg, interpret=True)
            return (out * DOUT).sum(), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (Q, K, V)))
        jax_runs[impl] = (np.asarray(out), [np.asarray(g) for g in grads])
    th.join()
    if "error" in box:
        raise box["error"]
    return {"torch": box["torch"], "jax": jax_runs}


def _assemble(ranks, key):
    """The global (B, H, S, D) array from every rank's block."""
    out = np.zeros((B, H, S, D), np.float32)
    for r in ranks:
        b, m, j = r["where"]
        a = r[key]
        bl, hl, sl = a.shape[:3]
        out[b * bl:(b + 1) * bl, m * hl:(m + 1) * hl, j * sl:(j + 1) * sl] = a
    return out


def _reference(causal, seg, with_grads):
    s = jnp.asarray(SEG) if seg else None

    def loss(q, k, v):
        out = reference_attention(q, k, v, causal=causal, q_segment_ids=s,
                                  kv_segment_ids=s)
        return (out * DOUT).sum(), out

    args = tuple(jnp.asarray(a) for a in (Q, K, V))
    if not with_grads:
        return np.asarray(loss(*args)[1]), None
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_reference(runs, name):
    impl, _, causal, seg, grad = CASES[name]
    ranks = runs["torch"][name]
    out, grads = _reference(causal, seg, grad)
    np.testing.assert_allclose(_assemble(ranks, "out"), out, atol=OUT_ATOL)
    if grad:
        for key, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(_assemble(ranks, key), want,
                                       atol=GRAD_ATOL, err_msg=f"{key} {name}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_matches_jax_parallel_function(runs, impl):
    """Against the JAX ring / Ulysses function itself (causal, packed
    segments, forward and gradients)."""
    name = "ring_seg_grad" if impl == "ring" else "ulysses_seg_grad"
    out, grads = runs["jax"][impl]
    ranks = runs["torch"][name]
    np.testing.assert_allclose(_assemble(ranks, "out"), out, atol=OUT_ATOL)
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_assemble(ranks, key), want, atol=GRAD_ATOL,
                                   err_msg=key)


def test_ulysses_rejects_indivisible_heads(runs):
    for r in runs["torch"]["ulysses_bad_heads"]:
        assert isinstance(r, tw.RaisedInRank) and r.kind == "ValueError"
        assert "divisible" in r.message and "Ulysses" in r.message


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_global_wrappers(runs, impl):
    """``ring_attention(q, k, v, mesh)`` / ``ulysses_attention`` give every
    rank the global output, and the global gradient of a replicated
    objective."""
    def loss(q):
        out = reference_attention(q, jnp.asarray(K), jnp.asarray(V), causal=True)
        return (out ** 2).sum(), out

    (_, out), dq = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(Q))
    for r in runs["torch"][f"{impl}_global"]:
        np.testing.assert_allclose(r["out"], np.asarray(out), atol=OUT_ATOL)
        np.testing.assert_allclose(r["dq"], np.asarray(dq), atol=GRAD_ATOL)


def test_ring_sentinel_stays_finite():
    """Merging two empty partials keeps the kernels' sentinel, not NaN."""
    import torch

    from kubeflow_tpu_torch.ops.flash_attention import NEG_INF
    from kubeflow_tpu_torch.parallel.ring_attention import _merge

    o = torch.zeros(1, 1, 2, 4)
    lse = torch.full((1, 1, 2), NEG_INF)
    o2, lse2 = _merge(o, lse, torch.ones(1, 1, 2, 4), torch.full((1, 1, 2), NEG_INF))
    assert torch.isfinite(o2).all() and (lse2 <= NEG_INF / 2).all()


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_unsharded_attention_cannot_shard_seq(impl):
    """``flash`` and ``reference`` attend over one rank's whole sequence:
    under a seq-sharded mesh they raise (``flash`` with the JAX error)
    rather than attend within the local chunk."""
    import torch

    from kubeflow_tpu_torch.core.mesh import Mesh
    from kubeflow_tpu_torch.core.mesh import MeshSpec as TMeshSpec
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, dispatch_attention)

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                            d_ff=64, attn_impl=impl)
    mesh = Mesh(TMeshSpec(seq=2), 0, device="cpu")
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError) as err:
        dispatch_attention(q, q, q, cfg, mesh=mesh)
    assert str(err.value) == (
        f"attn_impl={impl!r} cannot shard the seq axis; use 'ring' or "
        "'ulysses' for sequence parallelism")
    # one seq rank: no sharding, no error
    out = dispatch_attention(q, q, q, cfg,
                             mesh=Mesh(TMeshSpec(data=2), 0, device="cpu"))
    assert out.shape == q.shape
