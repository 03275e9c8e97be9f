"""BERT MLM training in the port against the JAX package's.

``kubeflow_tpu_torch/models/bert.py``'s ``make_mlm_loss_fn`` /
``make_mlm_init_fn`` and the port's ``Trainer`` step key are held
against ``kubeflow_tpu/models/bert.py`` and the JAX ``Trainer`` on the
CPU: the masks bit for bit (the port's threefry against
``jax.random.bernoulli`` under ``fold_in(PRNGKey(seed), step)`` and, per
microbatch, ``fold_in(., i)``), then the loss and ``masked_accuracy``
from the same bridged weights and batches, per step through
``Trainer.fit``. Sizes: 2 layers, hidden 64, 4 heads, intermediate 128,
vocab 512, S=32; the loss case at B=4, the trainer cases at B=8 (16 with
two microbatches), since the JAX trainer shards the batch over the
8-device CPU mesh. Tolerances, f32: the loss of one call within 2e-6
(sums in another order), per-step losses and accuracies over 3 steps of
adamw within rtol 1e-5, the masked accuracy (a count over the same
masked positions) exactly.
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
from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.train.loop import TrainConfig as JTrainConfig
from kubeflow_tpu.train.loop import Trainer as JTrainer
from kubeflow_tpu_torch.data import synthetic as tsyn
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.models.bridge import bert_params_to_state_dict
from kubeflow_tpu_torch.serve import threefry
from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw

KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
          intermediate_size=128, max_position=64)
SEQ = 32
DS = dict(vocab_size=KW["vocab_size"], seq_len=SEQ)


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


def _jax_init(attn_impl="reference", **extra):
    jcfg = jbert.BertConfig(**KW, attn_impl=attn_impl, **extra)
    jmodel = jbert.BertForMaskedLM(jcfg)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(
        jbert.make_mlm_init_fn(jmodel, SEQ))(jax.random.PRNGKey(0)))
    return jmodel, init


def _port_init(init, attn_impl="reference"):
    cfg = tbert.BertConfig(**KW, attn_impl=attn_impl)

    def init_params(seed, device):
        model = tbert.BertForMaskedLM(cfg, device=device,
                                      param_dtype=torch.float32)
        model.load_state_dict(bert_params_to_state_dict(init))
        return model

    return init_params


@pytest.mark.parametrize("seed,step,micro", [(0, 0, None), (0, 5, None),
                                             (3, 17, 1), (7, 2, 0)])
def test_mlm_mask_bit_equal_to_jax(seed, step, micro):
    """The mask under the trainer's step key (and microbatch key) is
    ``jax.random.bernoulli``'s, bit for bit; under partitionable threefry
    (JAX's default here) the (B, S) draw is the flat draw reshaped."""
    assert jax.config.jax_threefry_partitionable
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    data = (step,) if micro is None else (step, micro)
    if micro is not None:
        key = jax.random.fold_in(key, micro)
    tkey = threefry.key_of(seed, *data)
    np.testing.assert_array_equal(tkey.numpy(),
                                  np.asarray(jax.random.key_data(key)))
    want = np.asarray(jax.random.bernoulli(key, 0.15, (4, SEQ)))
    got = threefry.bernoulli(tkey, 0.15, (4, SEQ), "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    flat = np.asarray(jax.random.uniform(key, (4 * SEQ,))).reshape(4, SEQ)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, (4, SEQ))),
                                  flat)
    np.testing.assert_array_equal(
        threefry.uniform_one_key(tkey, (4, SEQ), "cpu").numpy(), flat)


def test_mlm_loss_matches_jax():
    """One loss call from the same weights, batch and key: the loss within
    2e-6 and the masked accuracy exactly."""
    jmodel, init = _jax_init()
    batch = jsyn.TokenLMDataset(**DS).batch(4, step=0)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jloss, jaux = jax.jit(jbert.make_mlm_loss_fn(jmodel))(
        jax.tree_util.tree_map(jnp.asarray, init), batch, key)
    model = _port_init(init)(0, "cpu")
    tloss, taux = tbert.make_mlm_loss_fn()(
        model, {"inputs": torch.from_numpy(batch["inputs"])},
        threefry.key_of(0, 3))
    assert abs(tloss.item() - float(jloss)) <= 2e-6
    assert taux["masked_accuracy"].item() == pytest.approx(
        float(jaux["masked_accuracy"]), abs=1e-7)


def _fit_both(attn_impl, *, batch, steps=3, accum=1, **jextra):
    jmodel, init = _jax_init(attn_impl, **jextra)
    jt = JTrainer(
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, init),
        loss_fn=jbert.make_mlm_loss_fn(jmodel), optimizer=optax.adamw(1e-3),
        config=JTrainConfig(mesh=MeshSpec.data_parallel(len(jax.devices())),
                            global_batch=batch, steps=steps, log_every=1,
                            grad_accum_steps=accum),
    )
    _, jhist = jt.fit(lambda s: jsyn.local_shard_iterator(
        jsyn.TokenLMDataset(**DS), batch, start_step=s))
    tt = Trainer(
        init_params=_port_init(init, attn_impl),
        loss_fn=tbert.make_mlm_loss_fn(), optimizer=adamw(1e-3),
        config=TrainConfig(mesh=None, global_batch=batch, steps=steps,
                           log_every=1, grad_accum_steps=accum),
        device="cpu",
    )
    _, thist = tt.fit(lambda s: tsyn.local_shard_iterator(
        tsyn.TokenLMDataset(**DS), batch, start_step=s))
    return jhist, thist


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_mlm_fit_matches_jax_trainer(attn_impl):
    """Three steps of ``Trainer.fit`` with the MLM loss: per-step loss
    within rtol 1e-5 and masked accuracy within 1e-6. The flash case runs
    the JAX Pallas kernels in interpret mode against the port's flash
    autograd function (its plain twins on the CPU)."""
    extra = {"interpret_kernels": True} if attn_impl == "flash" else {}
    jhist, thist = _fit_both(attn_impl, batch=8, **extra)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["masked_accuracy"] for h in thist],
                               [h["masked_accuracy"] for h in jhist],
                               rtol=0, atol=1e-6)


def test_mlm_grad_accum_microbatch_keys_follow_jax():
    """Two microbatches a step: each draws its mask from
    ``fold_in(step key, i)``, as the JAX scan does, so the per-step loss
    (the mean of the microbatch losses) matches within rtol 1e-5."""
    jhist, thist = _fit_both("reference", batch=16, steps=2, accum=2)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["masked_accuracy"] for h in thist],
                               [h["masked_accuracy"] for h in jhist],
                               rtol=0, atol=1e-6)


def test_make_mlm_init_fn_keeps_f32_master_weights():
    """The init builds f32 master weights; a bf16 model over them computes
    what the bf16 serving layout (projections stored in bf16) computes,
    bit for bit, since both cast the same f32 weights the same way."""
    cfg = tbert.BertConfig(**KW, dtype=torch.bfloat16, attn_impl="reference")
    model = tbert.make_mlm_init_fn(cfg)(0, "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    serving = tbert.BertForMaskedLM(cfg, device="cpu")
    serving.load_state_dict(model.state_dict())
    assert serving.encoder.layers[0].up_proj.weight.dtype == torch.bfloat16
    ids = torch.from_numpy(jsyn.TokenLMDataset(**DS).batch(2, step=1)["inputs"])
    with torch.no_grad():
        torch.testing.assert_close(model(ids), serving(ids), rtol=0, atol=0)
    loss, aux = tbert.make_mlm_loss_fn()(model, {"inputs": ids},
                                         threefry.key_of(0, 0))
    loss.backward()
    assert torch.isfinite(loss) and 0 <= aux["masked_accuracy"].item() <= 1
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for n, p in model.named_parameters() if "pooler" not in n)
