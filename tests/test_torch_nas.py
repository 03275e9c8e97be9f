"""The port's NAS (``kubeflow_tpu_torch/tune/nas.py``) against the JAX
package's ``kubeflow_tpu/tune/nas.py`` on the CPU, on the JAX searchers'
own weights bridged in (``models/bridge.py``) and ``tests/
test_nas_pbt.py``'s synthetic data.

- ``SuperNet`` forward within ``FWD_ATOL`` (both mixing modes).
- DARTS: after ``K`` bilevel steps each loss within ``LOSS_RTOL``, alpha
  within ``ALPHA_ATOL``, the same ``derive()``.
- The ENAS controller: for the same key the same inputs and ops, logp
  and entropy within ``LOGP_ATOL``; over ``K`` ENAS steps the same
  sampled architectures (weight step and controller step), rewards
  equal, losses within ``LOSS_RTOL``, the baseline within
  ``LOSS_RTOL``, the same greedy ``derive()``; invalid inputs masked.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.tune import nas as J
from kubeflow_tpu_torch.models.bridge import (
    controller_params_to_state_dict,
    supernet_params_to_state_dict,
)
from kubeflow_tpu_torch.tune import nas as T

FWD_ATOL = 1e-5
#: f32 losses and the ENAS baseline after K steps, relative
LOSS_RTOL = 1e-5
#: DARTS alpha after K adam steps at lr 3e-3 (adam scales every
#: gradient to about lr, so alpha's f32 error is absolute)
ALPHA_ATOL = 1e-4
LOGP_ATOL = 1e-5
K = 6

SMALL = dict(ops=("conv3", "skip", "zero"), nodes=2, channels=8, num_classes=4)


def _data(step):
    protos = np.random.RandomState(0).randn(4, 8, 8, 1).astype(np.float32)

    def batch(seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 4, size=16)
        x = protos[y] + 0.3 * r.randn(16, 8, 8, 1).astype(np.float32)
        return {"image": x.astype(np.float32), "label": y}

    return batch(step * 2), batch(step * 2 + 1)


def _params(tree):
    return jax.device_get(tree["params"])


def test_nas_space_validation_and_edges():
    for M in (J, T):
        sp = M.NASSpace(nodes=3)
        assert sp.edges == J.NASSpace(nodes=3).edges and len(sp.edges) == 6
        with pytest.raises(ValueError, match="unknown ops"):
            M.NASSpace(ops=("conv3", "wormhole"))
    assert sorted(T.OPS) == sorted(J.OPS)


@pytest.mark.parametrize("probs", [False, True])
@pytest.mark.parametrize("space", [{}, SMALL, dict(nodes=2, input_shape=(6, 5, 3))],
                         ids=["default", "small", "rect"])
def test_supernet_forward_matches_jax(space, probs):
    sj, st = J.NASSpace(**space), T.NASSpace(**space)
    net = J.SuperNet(sj, weights_are_probs=probs)
    r = np.random.RandomState(1)
    x = r.randn(3, *sj.input_shape).astype(np.float32)
    alpha = r.rand(len(sj.edges), len(sj.ops)).astype(np.float32)
    w = net.init(jax.random.PRNGKey(0), jnp.zeros((1, *sj.input_shape)), alpha)
    mine = T.SuperNet(st, weights_are_probs=probs, device="cpu")
    mine.load_state_dict(supernet_params_to_state_dict(_params(w)))
    got = mine(torch.tensor(x), torch.tensor(alpha)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(net.apply(w, x, alpha)), atol=FWD_ATOL)
    assert sorted(mine.state_dict()) == sorted(
        supernet_params_to_state_dict(_params(w)))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: T.DARTSSearcher(T.NASSpace(**SMALL)),
                 lambda: T.ENASSearcher(T.NASSpace(**SMALL)),
                 lambda: T.SuperNet(T.NASSpace(**SMALL))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make()


def test_darts_steps_match_jax():
    j = J.DARTSSearcher(J.NASSpace(**SMALL), seed=0)
    t = T.DARTSSearcher(T.NASSpace(**SMALL), seed=0, device="cpu")
    t.net.load_state_dict(supernet_params_to_state_dict(_params(j.w)))
    assert t.alpha_entropy() == pytest.approx(j.alpha_entropy(), rel=1e-6)
    for i in range(K):
        want, got = j.step(*_data(i)), t.step(*_data(i))
        for k in ("w_loss", "alpha_loss"):
            assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), (i, k)
    np.testing.assert_allclose(t.alpha.detach().numpy(), np.asarray(j.alpha),
                               atol=ALPHA_ATOL)
    assert t.derive().edges == j.derive().edges and t.derive().to_dict() == j.derive().to_dict()
    assert t.alpha_entropy() == pytest.approx(j.alpha_entropy(), rel=LOSS_RTOL)
    assert t.derive(keep_per_node=1).edges == j.derive(keep_per_node=1).edges


def _controllers(space_kw, seed=0):
    sj, st = J.NASSpace(**space_kw), T.NASSpace(**space_kw)
    c = J.ControllerNet(sj)
    params = c.init(jax.random.PRNGKey(seed), jax.random.PRNGKey(0))
    mine = T.ControllerNet(st, device="cpu")
    mine.load_state_dict(controller_params_to_state_dict(_params(params)))
    return c, params, mine


@pytest.mark.parametrize("space", [{}, SMALL], ids=["default", "small"])
def test_controller_rollout_matches_jax(space):
    c, params, mine = _controllers(space, seed=3)
    roll = jax.jit(lambda rng, greedy: c.apply(params, rng, greedy=greedy),
                   static_argnums=1)
    for s in range(8):
        for greedy in (False, True):
            ji, jo, jl, je = roll(jax.random.PRNGKey(s), greedy)
            key = np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
            ti, to, tl, te = mine(torch.tensor(key.astype(np.int64)), greedy=greedy)
            assert ti.tolist() == np.asarray(ji).tolist(), (s, greedy)
            assert to.tolist() == np.asarray(jo).tolist(), (s, greedy)
            assert tl.item() == pytest.approx(float(jl), abs=LOGP_ATOL)
            assert te.item() == pytest.approx(float(je), abs=LOGP_ATOL)


def test_enas_controller_masks_invalid_inputs():
    """Node j may only take inputs from nodes < j, across many sampled
    rollouts (the JAX test's rule, on the port's controller)."""
    space = T.NASSpace(nodes=3, channels=8)
    ctrl = T.ControllerNet(space, device="cpu")
    for s in range(20):
        inputs, ops, logp, ent = ctrl((0, s))
        for j in range(1, space.nodes + 1):
            assert (inputs[j - 1] < j).all(), (j, inputs)
        assert ent.item() > 0.0 and logp.item() < 0.0
        assert ((ops >= 0) & (ops < len(space.ops))).all()


def test_enas_steps_match_jax():
    j = J.ENASSearcher(J.NASSpace(**SMALL), seed=0)
    t = T.ENASSearcher(T.NASSpace(**SMALL), seed=0, device="cpu")
    t.net.load_state_dict(supernet_params_to_state_dict(_params(j.w)))
    t.controller.load_state_dict(controller_params_to_state_dict(_params(j.ctrl)))
    for i in range(K):
        # the JAX step's two rollouts, replayed from its keys before it runs
        _, k1, k2 = jax.random.split(j._rng, 3)
        want_arch = {
            name: [np.asarray(a).tolist() for a in j.controller.apply(j.ctrl, k)[:2]]
            for name, k in (("w", k1), ("ctrl", k2))}
        want, got = j.step(*_data(i)), t.step(*_data(i))
        assert t.sampled[i] == want_arch, i
        assert got["reward"] == want["reward"]
        for k in ("w_loss", "ctrl_loss", "baseline"):
            assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL, abs=1e-7), (i, k)
    assert t.derive().edges == j.derive().edges
    assert t.derive().to_dict() == t.derive().to_dict()  # greedy: deterministic


def test_enas_arch_weights_match_jax():
    """Hard one-hot rows, max not sum, over every decision pattern a
    rollout can give (random ones, repeated picks included)."""
    j = J.ENASSearcher(J.NASSpace(nodes=3), seed=0)
    t = T.ENASSearcher(T.NASSpace(nodes=3), seed=0, device="cpu")
    r = np.random.RandomState(0)
    for _ in range(30):
        inputs = np.stack([r.randint(0, n, size=2) for n in (1, 2, 3)])
        ops = r.randint(0, 5, size=(3, 2))
        want = np.asarray(j._arch_weights(jnp.asarray(inputs), jnp.asarray(ops)))
        got = t.arch_weights(torch.tensor(inputs), torch.tensor(ops)).numpy()
        np.testing.assert_array_equal(got, want)
