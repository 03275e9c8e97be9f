"""The port's ``parallel/pipeline.py`` against the JAX package's: the cases
of ``tests/test_moe_pipeline.py``'s pipeline sections (GPipe against the
sequential stages for each microbatch count, its gradients, validation,
1F1B against GPipe with and without a ``data`` axis, the stash bound), in
one gloo world of 8 CPU ranks. A 4-stage mesh without a data axis takes
``expert=2`` to fill 8 ranks: the pipeline splits nothing over it.
Tolerances: outputs and losses 1e-5, gradients 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_worlds as tw
from kubeflow_tpu.core.mesh import MeshSpec, build_mesh
from kubeflow_tpu.parallel import pipeline as jpipe
from kubeflow_tpu_torch.core.mesh import Mesh
from kubeflow_tpu_torch.core.mesh import MeshSpec as TMeshSpec
from kubeflow_tpu_torch.parallel import pipeline as tpipe

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
PIPE4_DATA2, PIPE4 = dict(pipe=4, data=2), dict(pipe=4, expert=2)


def _params(rng, n_stages, d):
    return {"w": (rng.randn(n_stages, d, d) * 0.3).astype(np.float32),
            "b": (rng.randn(n_stages, d) * 0.1).astype(np.float32)}


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _sequential(params, x, n_stages):
    for s in range(n_stages):
        x = np.tanh(x @ params["w"][s] + params["b"][s])
    return x


SEQ_CASES = {m: (_params(np.random.RandomState(0), 4, 16),
                 np.random.RandomState(0).randn(32, 16).astype(np.float32))
             for m in (4, 8)}
GRAD_IN = (_params(np.random.RandomState(1), 4, 8),
           np.random.RandomState(1).randn(16, 8).astype(np.float32))
F1B_IN = {name: (_params(np.random.RandomState(seed), 4, 8),
                 np.random.RandomState(seed).randn(m * mb, 8).astype(np.float32), m)
          for name, seed, m, mb in (("pipe4", 3, 16, 2), ("pipe4_data2", 4, 8, 4))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(f"seq_{m}", dict(fn="pipeline", spec=PIPE4_DATA2, params=p, x=x,
                               n_micro=m, what="apply"))
             for m, (p, x) in SEQ_CASES.items()]
    cases.append(("grad", dict(fn="pipeline", spec=PIPE4, params=GRAD_IN[0],
                               x=GRAD_IN[1], n_micro=4, what="grad")))
    for name, (p, x, m) in F1B_IN.items():
        spec = PIPE4 if name == "pipe4" else PIPE4_DATA2
        for sched in ("gpipe", "1f1b"):
            cases.append((f"{name}_{sched}", dict(
                fn="pipeline", spec=spec, params=p, x=x, n_micro=m,
                what="value_and_grad", schedule=sched)))
    return tw.world(8, cases, tmp_path_factory.mktemp("world"))


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_sequential(world, n_micro, devices8):
    params, x = SEQ_CASES[n_micro]
    want = _sequential(params, x, 4)
    jout = jpipe.pipeline_apply(_jstage, jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(x), build_mesh(MeshSpec(**PIPE4_DATA2)),
                                n_microbatches=n_micro)
    np.testing.assert_allclose(np.asarray(jout), want, atol=OUT_ATOL)
    for got in world[f"seq_{n_micro}"]:
        np.testing.assert_allclose(got, want, atol=OUT_ATOL)
        np.testing.assert_allclose(got, np.asarray(jout), atol=OUT_ATOL)


def test_pipeline_gradients_match(world, devices8):
    params, x = GRAD_IN
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    mesh = build_mesh(MeshSpec(pipe=4), devices=jax.devices()[:4])

    def loss_pipe(p):
        return (jpipe.pipeline_apply(_jstage, p, jnp.asarray(x), mesh,
                                     n_microbatches=4) ** 2).sum()

    def loss_seq(p):
        h = jnp.asarray(x)
        for s in range(4):
            h = _jstage(jax.tree_util.tree_map(lambda a: a[s], p), h)
        return (h ** 2).sum()

    gp, gs = jax.grad(loss_pipe)(jp), jax.grad(loss_seq)(jp)
    for got in world["grad"]:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(gs[k]), atol=GRAD_ATOL, err_msg=k)
            np.testing.assert_allclose(got[k], np.asarray(gp[k]), atol=GRAD_ATOL, err_msg=k)


def test_pipeline_validation():
    rng = np.random.RandomState(2)
    import torch

    params = {k: torch.tensor(v) for k, v in _params(rng, 4, 8).items()}
    mesh = Mesh(TMeshSpec(pipe=4), 0, device="cpu")
    x = torch.zeros(10, 8)
    stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(stage, params, x, mesh, n_microbatches=3)
    bad = {k: torch.tensor(v) for k, v in _params(rng, 2, 8).items()}
    with pytest.raises(ValueError, match="stacked param"):
        tpipe.pipeline_apply(stage, bad, x[:8], mesh, n_microbatches=2)
    with pytest.raises(ValueError, match="schedule"):
        tpipe.pipeline_value_and_grad(stage, lambda y: y.mean(), params, x[:8],
                                      mesh, n_microbatches=2, schedule="zb")


@pytest.mark.parametrize("name", list(F1B_IN))
def test_1f1b_matches_gpipe_and_jax(world, name, devices8):
    """1F1B's loss and gradients equal GPipe's (same per-microbatch
    cotangents and stage VJPs, another accumulation order), and the JAX
    1F1B's."""
    params, x, m = F1B_IN[name]
    spec = dict(pipe=4) if name == "pipe4" else PIPE4_DATA2
    devices = jax.devices()[:4] if name == "pipe4" else None
    jl, jg = jpipe.pipeline_value_and_grad(
        _jstage, lambda y: (y ** 2).mean(), jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x), build_mesh(MeshSpec(**spec), devices=devices),
        n_microbatches=m, schedule="1f1b")
    for g, f in zip(world[f"{name}_gpipe"], world[f"{name}_1f1b"]):
        assert f["loss"] == pytest.approx(g["loss"], abs=OUT_ATOL)
        assert f["loss"] == pytest.approx(float(jl), abs=OUT_ATOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(f["grads"][k], g["grads"][k], atol=GRAD_ATOL)
            np.testing.assert_allclose(f["grads"][k], np.asarray(jg[k]),
                                       atol=GRAD_ATOL, err_msg=k)


def test_1f1b_stash_is_bounded_by_the_stage_count(world):
    """The point of 1F1B: at 16 microbatches on 4 stages no rank held more
    than 2(n-1)+1 = 7 stage inputs for the backward; GPipe holds one a
    microbatch."""
    assert tpipe.live_activation_buffers("1f1b", 4, 16) == 7
    assert tpipe.live_activation_buffers("gpipe", 4, 16) == 16
    for n, m in ((4, 16), (4, 8), (2, 3)):
        for sched in ("1f1b", "gpipe"):
            assert (tpipe.live_activation_buffers(sched, n, m)
                    == jpipe.live_activation_buffers(sched, n, m))
    one = [r["live_buffers"] for r in world["pipe4_1f1b"]]
    assert max(one) == 7 and min(one) >= 1
    assert all(r["live_buffers"] == 16 for r in world["pipe4_gpipe"])
