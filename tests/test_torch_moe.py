"""The port's ``parallel/expert.py`` against the JAX package's: the cases of
``tests/test_moe_pipeline.py``'s MoE section, then tight-capacity meshes
whose drops must be the JAX global view's exactly.

JAX's ``moe_ffn`` runs in the global view: capacity counts every token
and a token's slot is its place in a count over all tokens in (batch,
seq) order. The port's ranks each hold a block of rows times a sequence
chunk and build global slots from gathered counts; with capacity tight,
a per-rank count would drop other tokens. One gloo world of 8 CPU ranks.
Tolerance: outputs, aux losses and input gradients within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds as tw
from kubeflow_tpu.parallel import expert as jexp
from kubeflow_tpu_torch.parallel import expert as texp

ATOL = 1e-5


def _weights(rng, d, cfg):
    return (
        (rng.randn(d, cfg["num_experts"]) * 0.1).astype(np.float32),
        (rng.randn(cfg["num_experts"], d, cfg["expert_dim"]) * 0.1).astype(np.float32),
        (rng.randn(cfg["num_experts"], cfg["expert_dim"], d) * 0.1).astype(np.float32),
    )


def _jax_moe(x, router, up, down, cfg):
    """JAX global-view output, aux, stats and d(out.sum() + aux)/dx."""
    c = jexp.MoEConfig(**cfg)

    def f(x):
        out, aux, stats = jexp.moe_ffn(x, router, up, down, c)
        return out.sum() + aux, (out, aux, stats)

    (_, (out, aux, stats)), dx = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    return (np.asarray(out), float(aux), {k: float(v) for k, v in stats.items()},
            np.asarray(dx))


def test_top_k_routing_matches_jax_and_respects_capacity():
    probs = np.random.RandomState(0).dirichlet(np.ones(4), size=64).astype(np.float32)
    jc, jd = jexp.top_k_routing(jnp.asarray(probs), k=2, capacity=8)
    combine, dispatch = texp.top_k_routing(torch.tensor(probs), 2, 8)
    assert combine.shape == (64, 4, 8)
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    assert int(dispatch.sum(0).max()) <= 1              # no slot double-booked
    assert int(dispatch.sum((1, 2)).max()) <= 2         # at most k assignments


def test_moe_top1_matches_dense_expert_choice():
    rng = np.random.RandomState(1)
    d = 16
    cfg = dict(num_experts=4, expert_dim=32, top_k=1, capacity_factor=8.0)
    router, up, down = _weights(rng, d, cfg)
    x = rng.randn(32, d).astype(np.float32)
    out, aux, stats = texp.moe_ffn(torch.tensor(x), torch.tensor(router),
                                   torch.tensor(up), torch.tensor(down),
                                   texp.MoEConfig(**cfg))
    assert float(stats["moe_dropped_frac"]) == pytest.approx(0.0, abs=1e-6)
    choice = (x @ router).argmax(-1)
    gelu = lambda h: torch.nn.functional.gelu(torch.tensor(h), approximate="tanh").numpy()  # noqa: E731
    expected = np.stack([gelu(x[t] @ up[choice[t]]) @ down[choice[t]] for t in range(32)])
    np.testing.assert_allclose(out.numpy(), expected, atol=ATOL)
    jout, jaux, jstats, _ = _jax_moe(x, router, up, down, cfg)
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL)
    assert float(aux) == pytest.approx(jaux, abs=ATOL) and float(aux) > 0.0


def test_moe_dropping_under_tight_capacity():
    rng = np.random.RandomState(3)
    d = 8
    cfg = dict(num_experts=4, expert_dim=16, top_k=1, capacity_factor=0.25)
    router, up, down = _weights(rng, d, cfg)
    x = rng.randn(64, d).astype(np.float32)
    out, aux, stats = texp.moe_ffn(*(torch.tensor(a) for a in (x, router, up, down)),
                                   texp.MoEConfig(**cfg))
    jout, jaux, jstats, _ = _jax_moe(x, router, up, down, cfg)
    assert float(stats["moe_dropped_frac"]) > 0.0
    assert float(stats["moe_dropped_frac"]) == jstats["moe_dropped_frac"]
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL)


# --------------------------------------------------------------------------- #
# meshes (one world)
# --------------------------------------------------------------------------- #

SHARDED_CFG = dict(num_experts=8, expert_dim=32, top_k=2)
TIGHT_CFG = dict(num_experts=4, expert_dim=16, top_k=2, capacity_factor=0.5)
#: name: (mesh, cfg, (B, S, d))
MESH_CASES = {
    # tokens replicated, experts over 8 ranks (the JAX test's layout)
    "expert8": (dict(expert=8), SHARDED_CFG, (1, 64, 16)),
    # tight capacity: rows over data, sequence over seq, experts over expert
    "tight_data2_seq2_expert2": (dict(data=2, seq=2, expert=2), TIGHT_CFG, (4, 16, 8)),
    # tight capacity with the expert FFN split column/row over model
    "tight_data2_seq2_model2": (dict(data=2, seq=2, model=2), TIGHT_CFG, (4, 16, 8)),
    "tight_data2_seq4": (dict(data=2, seq=4), TIGHT_CFG, (4, 16, 8)),
}


#: tensor-parallel serving's token group: the whole batch on every rank,
#: replicated over ``data``; tight capacity, so a token counted once a
#: replica would change the drops
SERVING_CASE = ("serving_data2_expert2_model2",
                dict(data=2, expert=2, model=2), TIGHT_CFG, (4, 16, 8))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, inputs = [], {}
    for i, (name, (mesh, cfg, shape)) in enumerate(MESH_CASES.items()):
        rng = np.random.RandomState(10 + i)
        router, up, down = _weights(rng, shape[2], cfg)
        x = rng.randn(*shape).astype(np.float32)
        inputs[name] = (x, router, up, down)
        cases.append((name, dict(fn="moe", spec=mesh, x=x, router=router, up=up,
                                 down=down, cfg=cfg, rows=shape[0])))
    name, mesh, cfg, shape = SERVING_CASE
    rng = np.random.RandomState(20)
    router, up, down = _weights(rng, shape[2], cfg)
    x = rng.randn(*shape).astype(np.float32)
    inputs[name] = (x, router, up, down)
    cases.append((name, dict(fn="moe_serving", spec=mesh, x=x, router=router,
                             up=up, down=down, cfg=cfg)))
    return tw.world(8, cases, tmp_path_factory.mktemp("world")), inputs


def _assemble(ranks, key, shape):
    out = np.zeros(shape, np.float32)
    for r in ranks:
        p, j = r["where"]
        a = r[key]
        bl, sl = a.shape[:2]
        out[p * bl:(p + 1) * bl, j * sl:(j + 1) * sl] = a
    return out


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_moe_matches_jax_global_view(world, name):
    results, inputs = world
    _, cfg, shape = MESH_CASES[name]
    x, router, up, down = inputs[name]
    B, S, d = shape
    jout, jaux, jstats, jdx = _jax_moe(x.reshape(B * S, d), router, up, down, cfg)
    ranks = results[name]
    np.testing.assert_allclose(_assemble(ranks, "out", shape),
                               jout.reshape(shape), atol=ATOL)
    np.testing.assert_allclose(_assemble(ranks, "dx", shape),
                               jdx.reshape(shape), atol=ATOL)
    for r in ranks:
        assert r["aux"] == pytest.approx(jaux, abs=ATOL)
        # the drops are the global view's, token for token
        assert r["stats"]["moe_dropped_frac"] == jstats["moe_dropped_frac"]
        assert r["stats"]["moe_z_loss"] == pytest.approx(jstats["moe_z_loss"], abs=ATOL)


def test_serving_token_group_is_the_whole_batch(world):
    """``local_tokens=True`` under ``data=2``: every rank routes its whole
    (replicated) batch as the mesh-less ``moe_ffn`` does, drops included,
    with the expert FFN split over ``expert`` and ``model``."""
    results, inputs = world
    name, _, cfg, shape = SERVING_CASE
    x, router, up, down = inputs[name]
    B, S, d = shape
    want, waux, wstats = texp.moe_ffn(
        *(torch.tensor(a) for a in (x.reshape(B * S, d), router, up, down)),
        texp.MoEConfig(**cfg), rows=B)
    jout, jaux, jstats, _ = _jax_moe(x.reshape(B * S, d), router, up, down, cfg)
    assert float(wstats["moe_dropped_frac"]) > 0.1
    for r in results[name]:
        np.testing.assert_allclose(r["out"], want.numpy().reshape(shape), atol=ATOL)
        np.testing.assert_allclose(r["out"], jout.reshape(shape), atol=ATOL)
        assert r["aux"] == pytest.approx(float(waux), abs=ATOL)
        assert r["stats"]["moe_dropped_frac"] == float(wstats["moe_dropped_frac"])
        assert r["stats"]["moe_dropped_frac"] == jstats["moe_dropped_frac"]


def test_tight_cases_drop(world):
    results, _ = world
    for name in MESH_CASES:
        if name.startswith("tight"):
            assert results[name][0]["stats"]["moe_dropped_frac"] > 0.1, name


def test_model_with_moe_and_onehot_embed_matches_jax():
    """A TransformerLM with an MoE block and the ``onehot`` embedding
    scores and loses what the JAX model does from the same weights."""
    from kubeflow_tpu.models import transformer as jtf
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.models.bridge import params_to_state_dict

    kw = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              moe_every=2, embed_impl="onehot", attn_impl="reference")
    jm = jtf.TransformerLM(jtf.TransformerConfig(
        **kw, moe=jexp.MoEConfig(4, 16, 2), dtype=jnp.float32))
    toks = np.random.RandomState(0).randint(0, 97, (2, 12)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(toks))["params"]
    jloss, jmet = jax.jit(jtf.make_loss_fn(jm))(
        params, {"inputs": toks[:, :-1], "targets": toks[:, 1:]}, None)
    tm = ttf.TransformerLM(ttf.TransformerConfig(**kw, moe=texp.MoEConfig(4, 16, 2)),
                           device="cpu")
    tm.load_state_dict(params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    loss, met = ttf.make_loss_fn()(tm, {"inputs": torch.tensor(toks[:, :-1]),
                                        "targets": torch.tensor(toks[:, 1:])})
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=ATOL)
    assert float(met["moe_aux"]) == pytest.approx(float(jmet["moe_aux"]), abs=ATOL)
