"""The port's ``Trainer`` under a mesh against the JAX ``Trainer``.

``dryrun_multichip``'s flagship model (vocab 512, d_model 128, 2 layers,
8 heads, d_ff 256, an MoE block every 2nd layer with ``MoEConfig(4, 128,
2)``, the ``onehot`` embedding, f32) trains 2 steps under
``transformer_rules()`` with each mesh below, in both packages, from the
same JAX-initialised weights (bridged) on the same batches. The JAX
trainer runs on the 8 CPU devices (Pallas kernels in interpret mode); the
port runs one gloo world of 8 CPU ranks (``tests/torch_worlds.py``), one
rank a device. A 4-device mesh takes ``pipe=2`` in both packages to fill
8 devices: neither trainer splits anything over ``pipe``.

Tolerances (f32): per-step losses within 1e-5 (relative); parameters after
the last step within 1e-4 absolute, a tenth of the learning rate: Adam's
first steps move a weight by about ``lr * m / sqrt(v)``, so a gradient
element near 0 whose rounding differs between the packages (a sum over
ranks against XLA's fused reduction) moves by up to ``lr`` either way;
nearly all elements agree within 1e-6.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import torch_worlds as tw

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
STEPS, GLOBAL_BATCH, SEQ_LEN, LR = 2, 8, 64, 1e-3
MODEL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=8, d_ff=256,
             moe_every=2, moe=dict(num_experts=4, expert_dim=128, top_k=2),
             embed_impl="onehot")
DATA = dict(vocab_size=512, seq_len=SEQ_LEN)
#: (name, MeshSpec fields, attention strategy)
MESHES = [
    ("model2_seq2_ring", dict(model=2, seq=2, pipe=2), "ring"),
    ("fsdp2_seq2_ulysses", dict(fsdp=2, seq=2, pipe=2), "ulysses"),
    ("data2_expert2_flash", dict(data=2, expert=2, pipe=2), "flash"),
    ("model2_seq2_fsdp2_ring", dict(model=2, seq=2, fsdp=2), "ring"),
    ("dcn2_fsdp2_model2_flash", dict(dcn_data=2, fsdp=2, model=2), "flash"),
]


def _jax_params():
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.transformer import (
        TransformerConfig, TransformerLM, make_init_fn)
    from kubeflow_tpu.parallel.expert import MoEConfig

    kw = dict(MODEL, moe=MoEConfig(**MODEL["moe"]))
    model = TransformerLM(TransformerConfig(**kw, attn_impl="reference",
                                            dtype=jnp.float32))
    params = make_init_fn(model, SEQ_LEN, 1)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _global_batches(spec):
    """The global batch the port's ranks hold between them: partition p's
    rows are ``batch(G/P, step, offset=p)``."""
    from kubeflow_tpu.data.synthetic import TokenLMDataset

    ds = TokenLMDataset(**DATA)
    parts = spec.batch_partitions
    step = 0
    while True:
        rows = [ds.batch(GLOBAL_BATCH // parts, step=step, offset=p)
                for p in range(parts)]
        yield {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        step += 1


def _jax_fit(params, spec_kw, attn_impl):
    import jax.numpy as jnp
    import optax

    from kubeflow_tpu.core.mesh import MeshSpec
    from kubeflow_tpu.models.transformer import (
        TransformerConfig, TransformerLM, make_loss_fn)
    from kubeflow_tpu.parallel.expert import MoEConfig
    from kubeflow_tpu.parallel.sharding import transformer_rules
    from kubeflow_tpu.train.loop import TrainConfig, Trainer

    spec = MeshSpec(**spec_kw)
    kw = dict(MODEL, moe=MoEConfig(**MODEL["moe"]))
    model = TransformerLM(TransformerConfig(
        **kw, attn_impl=attn_impl, interpret_kernels=True, dtype=jnp.float32))
    trainer = Trainer(
        init_params=lambda rng: params, loss_fn=make_loss_fn(model),
        optimizer=optax.adamw(LR),
        config=TrainConfig(mesh=spec, global_batch=GLOBAL_BATCH, steps=STEPS,
                           log_every=1, prefetch_depth=0),
        param_spec_fn=transformer_rules())
    state, hist = trainer.fit(_global_batches(spec))
    import jax

    return ([h["loss"] for h in hist],
            jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import os

    os.environ["KFT_NO_COMPILATION_CACHE"] = "1"
    params = _jax_params()
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    cases = [(name, dict(fn="train", spec=spec, model_cfg=MODEL, params=params,
                         data=DATA, steps=STEPS, lr=LR,
                         global_batch=GLOBAL_BATCH, attn_impl=impl,
                         ckpt_dir=ckpt if name == MESHES[0][0] else None))
             for name, spec, impl in MESHES]
    box: dict = {}

    def torch_side():
        try:
            box["torch"] = tw.world(8, cases, tmp_path_factory.mktemp("world"))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=torch_side)
    th.start()  # the ranks run while JAX compiles here
    jax_runs = {name: _jax_fit(params, spec, impl) for name, spec, impl in MESHES}
    th.join()
    if "error" in box:
        raise box["error"]
    return {"params": params, "jax": jax_runs, "torch": box["torch"],
            "ckpt": ckpt}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_losses_match_jax_trainer(runs, name):
    want, _ = runs["jax"][name]
    ranks = runs["torch"][name]
    got = ranks[0]["losses"]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # every rank logs the same global loss
    for r in ranks[1:]:
        assert r["losses"] == got


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_final_params_match_jax_trainer(runs, name):
    from kubeflow_tpu_torch.models.bridge import state_dict_to_params

    _, want = runs["jax"][name]
    full = runs["torch"][name][0]["params"]
    got = state_dict_to_params({k: torch.tensor(v) for k, v in full.items()})
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    close = []
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=path)
        close.append(np.abs(got[path] - w) <= 1e-6)
    assert np.concatenate([c.ravel() for c in close]).mean() > 0.999
    # the weights moved: the comparison is not of the initial weights
    init = dict(_flat(runs["params"]))
    assert np.abs(got["layers_0/attn/q_proj/kernel"]
                  - init["layers_0/attn/q_proj/kernel"]).max() > 1e-4


def test_moe_dropped_frac_is_logged(runs):
    for name, _, _ in MESHES:
        fr = runs["torch"][name][0]["moe_dropped_frac"]
        assert all(f is not None and 0.0 <= f < 1.0 for f in fr), (name, fr)


def test_mesh_checkpoint_resumes_on_one_device(runs):
    """The ring mesh saved its final state; a single-device trainer
    resumes it at step 2 with the mesh's parameters and takes step 3 as
    a single-device run of 3 steps from the same weights does."""
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.models.bridge import params_to_state_dict
    from kubeflow_tpu_torch.parallel.expert import MoEConfig
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adamw

    name, spec, impl = MESHES[0]
    kw = dict(MODEL, moe=MoEConfig(**MODEL["moe"]))
    cfg = ttf.TransformerConfig(**kw, attn_impl="flash")
    sd = params_to_state_dict(runs["params"])

    def init(seed, device):
        model = ttf.TransformerLM(cfg, device=device, param_dtype=torch.float32)
        model.load_state_dict(sd)
        return model

    def data(start):
        gen = _global_batches_port(spec)
        for _ in range(start):
            next(gen)
        return gen

    def trainer(steps, ckpt=None):
        return Trainer(
            init_params=init, loss_fn=ttf.make_loss_fn(), optimizer=adamw(LR),
            config=TrainConfig(mesh=None, global_batch=GLOBAL_BATCH,
                               steps=steps, log_every=1, prefetch_depth=0,
                               checkpoint=ckpt),
            device="cpu")

    t = trainer(STEPS + 1, CheckpointConfig(runs["ckpt"], save_every_steps=100,
                                            async_save=False))
    state = t.init_state()
    from kubeflow_tpu_torch.train.checkpoint import Checkpointer

    ck = Checkpointer(CheckpointConfig(runs["ckpt"]))
    assert ck.latest_step() == STEPS
    t._load_full(state, ck.restore())
    full = runs["torch"][name][0]["params"]
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), full[k], err_msg=k)
    resumed_state, resumed = t.fit(data)
    assert resumed_state.step == STEPS + 1 and [h["step"] for h in resumed] == [3]
    _, fresh = trainer(STEPS + 1).fit(data(0))
    np.testing.assert_allclose(resumed[0]["loss"], fresh[-1]["loss"], rtol=1e-4)


def _global_batches_port(spec_kw):
    from kubeflow_tpu_torch.core.mesh import MeshSpec
    from kubeflow_tpu_torch.data.synthetic import TokenLMDataset

    spec = MeshSpec(**spec_kw)
    ds = TokenLMDataset(**DATA)
    parts = spec.batch_partitions
    step = 0
    while True:
        rows = [ds.batch(GLOBAL_BATCH // parts, step=step, offset=p)
                for p in range(parts)]
        yield {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        step += 1


def test_ranks_stage_nothing_on_the_cpu(runs):
    """Host staging is for CUDA tensors under gloo; CPU ranks move none."""
    for name, _, _ in MESHES:
        assert all(r["staged"] == 0 for r in runs["torch"][name])
