"""The port's ``Trainer`` under a mesh against the JAX ``Trainer``.

``dryrun_multichip``'s flagship model (vocab 512, d_model 128, 2 layers,
8 heads, d_ff 256, an MoE block every 2nd layer with ``MoEConfig(4, 128,
2)``, the ``onehot`` embedding, f32) trains 2 steps under
``transformer_rules()`` with each mesh below, in both packages, from the
same JAX-initialised weights (bridged) on the same batches. The JAX
trainer runs on the 8 CPU devices (Pallas kernels in interpret mode); the
port runs one gloo world of 8 CPU ranks (``tests/torch_worlds.py``), one
rank a device. A 4-device mesh takes ``pipe=2`` in both packages to fill
8 devices: neither trainer splits anything over ``pipe``. One more case
takes two microbatches a step (``grad_accum_steps=2``) on a mesh of 4
batch partitions, with an MoE capacity tight enough to drop tokens, and
holds the losses, ``moe_aux`` and the drops a step against JAX's.

Tolerances (f32): per-step losses within 1e-5 (relative); parameters after
the last step within 1e-4 absolute, a tenth of the learning rate: Adam's
first steps move a weight by about ``lr * m / sqrt(v)``, so a gradient
element near 0 whose rounding differs between the packages (a sum over
ranks against XLA's fused reduction) moves by up to ``lr`` either way;
nearly all elements agree within 1e-6.
"""

from __future__ import annotations

import os

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

#: gradient accumulation under a mesh with 4 batch partitions: the MoE
#: layer's tight capacity drops tokens, and its capacity, drops and aux
#: loss are counted a microbatch, so they follow which rows a microbatch
#: holds
ACCUM = ("data2_fsdp2_expert2_accum2", dict(data=2, fsdp=2, expert=2),
         "reference")
ACCUM_STEPS = 2
ACCUM_MODEL = dict(MODEL, moe=dict(MODEL["moe"], capacity_factor=0.5))


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


def _loss_with_drops(model):
    """The JAX LM loss with each MoE layer's ``moe_dropped_frac`` (mean
    over the layers) among its metrics: the JAX ``Experts`` block keeps
    its stats to itself, so an interceptor recomputes them from the
    block's input and weights."""
    import flax.linen as nn

    from kubeflow_tpu.models.transformer import Experts, make_loss_fn
    from kubeflow_tpu.parallel.expert import moe_ffn

    base = make_loss_fn(model)

    def loss_fn(params, batch, rng):
        drops = []

        def spy(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, Experts) and context.method_name == "__call__":
                p = mod.variables["params"]
                _, _, st = moe_ffn(args[0], p["router_kernel"], p["up_kernel"],
                                   p["down_kernel"], mod.cfg.moe)
                drops.append(st["moe_dropped_frac"])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(spy):
            loss, metrics = base(params, batch, rng)
        return loss, {**metrics, "moe_dropped_frac": sum(drops) / len(drops)}

    return loss_fn


def _jax_fit(params, spec_kw, attn_impl, model_cfg=MODEL, accum=1):
    import jax.numpy as jnp
    import optax

    from kubeflow_tpu.core.mesh import MeshSpec
    from kubeflow_tpu.models.transformer import TransformerConfig, TransformerLM
    from kubeflow_tpu.parallel.expert import MoEConfig
    from kubeflow_tpu.parallel.sharding import transformer_rules
    from kubeflow_tpu.train.loop import TrainConfig, Trainer

    spec = MeshSpec(**spec_kw)
    kw = dict(model_cfg, moe=MoEConfig(**model_cfg["moe"]))
    model = TransformerLM(TransformerConfig(
        **kw, attn_impl=attn_impl, interpret_kernels=True, dtype=jnp.float32))
    trainer = Trainer(
        init_params=lambda rng: params, loss_fn=_loss_with_drops(model),
        optimizer=optax.adamw(LR),
        config=TrainConfig(mesh=spec, global_batch=GLOBAL_BATCH, steps=STEPS,
                           log_every=1, prefetch_depth=0,
                           grad_accum_steps=accum),
        param_spec_fn=transformer_rules())
    state, hist = trainer.fit(_global_batches(spec))
    import jax

    return ({k: [float(h[k]) for h in hist]
             for k in ("loss", "moe_aux", "moe_dropped_frac")},
            jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of every mesh: the JAX trainers first, with the
    persistent compilation cache off for them alone, then the 8-rank world,
    so that no JAX compile shares the host's cores with the ranks."""
    params = _jax_params()
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    cases = [(name, dict(fn="train", spec=spec, model_cfg=MODEL, params=params,
                         data=DATA, steps=STEPS, lr=LR,
                         global_batch=GLOBAL_BATCH, attn_impl=impl,
                         ckpt_dir=ckpt if name == MESHES[0][0] else None))
             for name, spec, impl in MESHES]
    name, spec, impl = ACCUM
    cases.append((name, dict(fn="train", spec=spec, model_cfg=ACCUM_MODEL,
                             params=params, data=DATA, steps=STEPS, lr=LR,
                             global_batch=GLOBAL_BATCH, attn_impl=impl,
                             accum=ACCUM_STEPS)))
    prev = os.environ.get("KFT_NO_COMPILATION_CACHE")
    os.environ["KFT_NO_COMPILATION_CACHE"] = "1"
    try:
        jax_runs = {name: _jax_fit(params, spec, impl)
                    for name, spec, impl in MESHES}
        name, spec, impl = ACCUM
        jax_runs[name] = _jax_fit(params, spec, impl, ACCUM_MODEL, ACCUM_STEPS)
    finally:
        if prev is None:
            del os.environ["KFT_NO_COMPILATION_CACHE"]
        else:
            os.environ["KFT_NO_COMPILATION_CACHE"] = prev
    torch_runs = tw.world(8, cases, tmp_path_factory.mktemp("world"))
    return {"params": params, "jax": jax_runs, "torch": torch_runs,
            "ckpt": ckpt}


def _ranks(runs, name):
    """Every rank's result of case ``name``; a rank that raised fails the
    test with its traceback."""
    ranks = runs["torch"][name]
    for i, r in enumerate(ranks):
        assert not isinstance(r, tw.RaisedInRank), f"{name}: rank {i} raised {r!r}"
    return ranks


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_losses_match_jax_trainer(runs, name):
    want = runs["jax"][name][0]["loss"]
    ranks = _ranks(runs, name)
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
    full = _ranks(runs, name)[0]["params"]
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


def test_moe_microbatches_match_jax_under_a_mesh(runs):
    """Gradient accumulation under a mesh: microbatch i holds JAX's global
    rows ``[i*B/A, (i+1)*B/A)`` on every rank, so the MoE layer's drops
    and aux loss, counted a microbatch, and the loss are JAX's."""
    name = ACCUM[0]
    want, _ = runs["jax"][name]
    ranks = _ranks(runs, name)
    got = ranks[0]
    assert all(f > 0.1 for f in want["moe_dropped_frac"]), want
    np.testing.assert_allclose(got["moe_dropped_frac"],
                               want["moe_dropped_frac"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want["loss"], rtol=LOSS_RTOL)
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]


def test_moe_dropped_frac_is_logged(runs):
    for name, _, _ in MESHES:
        fr = _ranks(runs, name)[0]["moe_dropped_frac"]
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
    full = _ranks(runs, name)[0]["params"]
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
        assert all(r["staged"] == 0 for r in _ranks(runs, name))
