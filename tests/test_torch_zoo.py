"""The port's training model zoo against the JAX package's: the MNIST
CNN, ResNet, ``ClassPrototypeDataset`` and the decoder LM's ``remat``.

The same numpy batches (bit-equal datasets) and bridged weights
(``models/bridge.py`` ``cnn_params_to_state_dict``,
``params_to_state_dict``) go through ``kubeflow_tpu/models/mnist_cnn.py``
/ ``resnet.py`` / ``transformer.py`` and the port's. Sizes: the MNIST
CNN at batch 16, ``resnet18_cifar(num_filters=16, groups=8)`` at batch
8 (both stems), the LM at 2 layers, d_model 64. Tolerances, f32: logits
within 2e-5 absolute (sums in another order; logits of magnitude up to
about 5), losses of a 2-step fit within rtol 1e-5 (ResNet's second
within 2e-4: see the test), LM gradients within
2e-6 absolute against JAX and bit-equal between the port's remat
policies and no remat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.core.mesh import MeshSpec
from kubeflow_tpu.data import synthetic as jsyn
from kubeflow_tpu.models import mnist_cnn as jmnist
from kubeflow_tpu.models import resnet as jresnet
from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.train.loop import TrainConfig as JTrainConfig
from kubeflow_tpu.train.loop import Trainer as JTrainer
from kubeflow_tpu_torch.data import synthetic as tsyn
from kubeflow_tpu_torch.models import mnist_cnn as tmnist
from kubeflow_tpu_torch.models import resnet as tresnet
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.models.bridge import (
    cnn_params_to_state_dict,
    cnn_state_dict_to_params,
    params_to_state_dict,
    state_dict_to_params,
)
from kubeflow_tpu_torch.train import TrainConfig, Trainer, adam

LOGIT_ATOL = 2e-5
RESNET_KW = dict(num_filters=16, groups=8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the module shares the CPU with concurrent
    test processes, some of them timing-bound."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_compilation_cache(monkeypatch):
    """The JAX trainer would turn on the process-wide persistent cache."""
    monkeypatch.setenv("KFT_NO_COMPILATION_CACHE", "1")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("kw,step,offset", [
    (dict(), 0, 0), (dict(seed=3, noise=0.5), 7, 2),
    (dict(image_shape=(32, 32, 3)), 4, 1)])
def test_class_prototype_batches_bit_equal_to_jax(kw, step, offset):
    want = jsyn.ClassPrototypeDataset(**kw).batch(6, step=step, offset=offset)
    got = tsyn.ClassPrototypeDataset(**kw).batch(6, step=step, offset=offset)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    it = tsyn.local_shard_iterator(tsyn.ClassPrototypeDataset(**kw), 8,
                                   start_step=step)
    jit_ = jsyn.local_shard_iterator(jsyn.ClassPrototypeDataset(**kw), 8,
                                     start_step=step)
    for _ in range(2):
        for g, w in zip(next(it), next(jit_)):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- models

def _random_params(init_fn, seed):
    """A param tree of ``init_fn``'s shapes drawn with numpy (the shapes by
    ``jax.eval_shape``: compiling flax's init costs seconds a model):
    kernels N(0, 1/fan-in), biases N(0, 0.1), GroupNorm scales 1 + N(0,
    0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _mnist():
    jmodel = jmnist.MnistCNN()
    return jmodel, _random_params(jmnist.make_init_fn(jmodel), 0)


def _resnet(**kw):
    jmodel = jresnet.ResNet(jresnet.resnet18_cifar(**RESNET_KW, **kw))
    return jmodel, _random_params(jresnet.make_init_fn(jmodel), 1)


def test_mnist_cnn_logits_match_jax():
    """NHWC input, SAME convs, VALID pools and the (H, W, C) flatten before
    ``Dense_0``; the bridge round-trips the param tree."""
    jmodel, params = _mnist()
    x, _ = jsyn.ClassPrototypeDataset().batch(16, step=0)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x))
    model = tmnist.MnistCNN(device="cpu")
    model.load_state_dict(cnn_params_to_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    back = dict(_leaves(cnn_state_dict_to_params(model.state_dict())))
    assert set(back) == set(dict(_leaves(params)))
    for path, w in _leaves(params):
        np.testing.assert_array_equal(back[path], w)


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_resnet18_logits_match_jax(cifar_stem):
    """GroupNorm (ε = 1e-6, f32 statistics), stride-2 SAME convs padded
    (0, 1) on even sizes, the projection and the H/W mean; the 7×7 stem
    with its SAME max pool."""
    jmodel, params = _resnet(cifar_stem=cifar_stem)
    x, _ = jsyn.ClassPrototypeDataset(image_shape=(32, 32, 3)).batch(8, step=0)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x))
    model = tresnet.ResNet(tresnet.resnet18_cifar(**RESNET_KW,
                                                  cifar_stem=cifar_stem),
                           device="cpu")
    model.load_state_dict(cnn_params_to_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name,loss_rtol", [("mnist", 1e-5),
                                             ("resnet18", 2e-4)])
def test_two_step_fit_matches_jax(name, loss_rtol):
    """Two steps of ``adam(1e-3)`` through both trainers from the same
    bridged weights on the same batches: step-1 losses within rtol 1e-5,
    step-2 losses within ``loss_rtol``, accuracies equal. ResNet's f32
    gradients are ill-conditioned: the fast-variance GroupNorm (E[x²] −
    E[x]²) cancels in its backward, and JAX's own jitted and eager
    gradients differ by up to 0.3% in norm for some parameters (the
    port's by up to 0.4%); Adam's first update, about ``lr · sign(g)``,
    passes that on, and the second losses land 5.7e-5 apart."""
    if name == "mnist":
        jmodel, params = _mnist()
        ds_kw, batch = {}, 16
        jloss = jmnist.make_loss_fn(jmodel)
        port = tmnist.MnistCNN
    else:
        jmodel, params = _resnet()
        ds_kw, batch = dict(image_shape=(32, 32, 3)), 8
        jloss = jresnet.make_loss_fn(jmodel)
        port = lambda device: tresnet.ResNet(  # noqa: E731
            tresnet.resnet18_cifar(**RESNET_KW), device=device)
    jt = JTrainer(
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, params),
        loss_fn=jloss, optimizer=optax.adam(1e-3),
        config=JTrainConfig(mesh=MeshSpec.data_parallel(len(jax.devices())),
                            global_batch=batch, steps=2, log_every=1),
    )
    _, jhist = jt.fit(lambda s: jsyn.local_shard_iterator(
        jsyn.ClassPrototypeDataset(**ds_kw), batch, start_step=s))

    def init_params(seed, device):
        model = port(device=device)
        model.load_state_dict(cnn_params_to_state_dict(params))
        return model

    tt = Trainer(init_params=init_params, loss_fn=tmnist.make_loss_fn(),
                 optimizer=adam(1e-3),
                 config=TrainConfig(mesh=None, global_batch=batch, steps=2,
                                    log_every=1),
                 device="cpu")
    _, thist = tt.fit(lambda s: tsyn.local_shard_iterator(
        tsyn.ClassPrototypeDataset(**ds_kw), batch, start_step=s))
    tl, jl = [h["loss"] for h in thist], [h["loss"] for h in jhist]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=loss_rtol)
    assert [h["accuracy"] for h in thist] == pytest.approx(
        [h["accuracy"] for h in jhist], abs=1e-6)


def test_adam_matches_optax():
    """Five updates of the port's ``adam(1e-2)`` against ``optax.adam``
    on the same parameters and gradients, f32 within 1e-6."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(5)]
    tx = optax.adam(1e-2)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam(1e-2)([tp])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- remat

LM_KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=64)


def _lm_batch():
    return jsyn.TokenLMDataset(vocab_size=128, seq_len=32).batch(4, step=0)


@pytest.fixture(scope="module")
def lm_init():
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(**LM_KW,
                                                     attn_impl="reference"))
    return _np_tree(jax.jit(jtf.make_init_fn(jmodel, 32))(jax.random.PRNGKey(0)))


def _port_loss_grads(init, **knobs):
    model = ttf.TransformerLM(ttf.TransformerConfig(**LM_KW, attn_impl="flash",
                                                    **knobs),
                              device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_to_state_dict(init))
    b = _lm_batch()
    loss, _ = ttf.make_loss_fn()(model, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    loss.backward()
    grads = state_dict_to_params({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), dict(_leaves(grads))


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_loss_and_grads_match_no_remat_and_jax(lm_init, policy):
    """``remat=True`` (each block under ``torch.utils.checkpoint``) gives
    no-remat's loss and gradients bit for bit, and the JAX remat model's
    (``nn.remat(Block, policy)``) within 2e-6."""
    loss0, g0 = _port_loss_grads(lm_init)
    loss, g = _port_loss_grads(lm_init, remat=True, remat_policy=policy)
    assert loss == loss0
    for path, v in g0.items():
        np.testing.assert_array_equal(g[path], v, err_msg="/".join(path))
    jmodel = jtf.TransformerLM(jtf.TransformerConfig(
        **LM_KW, attn_impl="reference", remat=True, remat_policy=policy))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.make_loss_fn(jmodel)(p, b, None)[0]))(
            jax.tree_util.tree_map(jnp.asarray, lm_init), _lm_batch())
    assert abs(loss - float(jl)) <= 2e-6
    for path, w in _leaves(_np_tree(jg)):
        np.testing.assert_allclose(g[path], w, rtol=0, atol=2e-6,
                                   err_msg="/".join(path))


def test_remat_recomputes_the_attention_forward(monkeypatch, lm_init):
    """Under either policy the attention forward runs again in the
    backward: 2 calls a layer a step, against 1 without remat (the card's
    count is ``chip_smoke.py``'s ``mlm`` phase (c))."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for knobs, want in ((dict(), 2), (dict(remat=True), 4),
                        (dict(remat=True, remat_policy="dots"), 4)):
        calls.clear()
        _port_loss_grads(lm_init, **knobs)
        assert len(calls) == want, knobs


@pytest.mark.parametrize("knobs", [dict(remat_policy="dots"),
                                   dict(remat=True, remat_policy="all")])
def test_remat_policy_validation_matches_jax(knobs):
    with pytest.raises(ValueError) as want:
        jtf.TransformerLM(jtf.TransformerConfig(**LM_KW, **knobs)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError) as got:
        ttf.TransformerLM(ttf.TransformerConfig(**LM_KW, **knobs), device="cpu")
    assert str(got.value) == str(want.value)


def test_dropout_rate_is_accepted_and_inert():
    """JAX's ``dropout_rate`` is a field nothing reads; the port's too."""
    torch.manual_seed(0)
    plain = ttf.TransformerLM(ttf.TransformerConfig(**LM_KW), device="cpu")
    ttf.init_weights(plain, 0)
    drop = ttf.TransformerLM(ttf.TransformerConfig(**LM_KW, dropout_rate=0.5),
                             device="cpu")
    drop.load_state_dict(plain.state_dict())
    toks = torch.from_numpy(_lm_batch()["inputs"])
    torch.testing.assert_close(drop.train()(toks), plain.train()(toks),
                               rtol=0, atol=0)
