"""The port's training path against the JAX package's.

``kubeflow_tpu_torch.train`` (``Trainer``, ``TrainConfig``, ``adamw``,
``Checkpointer``, ``MetricWriter``, the prefetch/drain layer) and
``kubeflow_tpu_torch.data`` are held against their JAX counterparts on the
CPU: the same numpy batches (bit-equal), the same bridged initial
parameters, optax's ``adamw`` against the port's. Then the JAX trainer's
contracts of ``tests/test_train.py`` are re-run on the port: gradient
accumulation, prefetch on/off, checkpoint resume, corrupt-step walk-back,
preemption, the NaN alarm, thread joins, and every unported knob
raising. Sizes: 2 layers, d_model 64, 4 heads, 2 kv heads, vocab 128,
sequence 32.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.core.mesh import MeshSpec
from kubeflow_tpu.data import synthetic as jsyn
from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.train import metrics as jmetrics
from kubeflow_tpu.train.loop import TrainConfig as JTrainConfig
from kubeflow_tpu.train.loop import Trainer as JTrainer
from kubeflow_tpu_torch.data import synthetic as tsyn
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.models.bridge import (
    params_to_state_dict,
    state_dict_to_params,
)
from kubeflow_tpu_torch.train import metrics as tmetrics
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from kubeflow_tpu_torch.train.loop import (
    PREEMPTED_EXIT_CODE,
    Preempted,
    TrainConfig,
    Trainer,
)
from kubeflow_tpu_torch.train.optim import adamw
from kubeflow_tpu_torch.train.prefetch import live_kft_threads

KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128, max_seq_len=64)
SEQ, BATCH = 32, 8
DS = dict(vocab_size=KW["vocab_size"], seq_len=SEQ)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _trainer(steps=6, *, loss_fn=None, **cfg_kw):
    cfg = ttf.TransformerConfig(**KW)
    return Trainer(
        init_params=ttf.make_init_fn(cfg), loss_fn=loss_fn or ttf.make_loss_fn(),
        optimizer=adamw(1e-3),
        config=TrainConfig(mesh=None, global_batch=BATCH, steps=steps,
                           log_every=1, **cfg_kw),
        device="cpu",
    )


def _data(start_step=0):
    return tsyn.local_shard_iterator(tsyn.TokenLMDataset(**DS), BATCH,
                                     start_step=start_step)


def _params(state):
    return dict(_paths(state_dict_to_params(state.model.state_dict())))


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step,offset", [(0, 0, 0), (0, 5, 1), (3, 17, 2)])
def test_token_lm_batches_bit_equal_to_jax(seed, step, offset):
    kw = dict(vocab_size=97, seq_len=24, seed=seed)
    want = jsyn.TokenLMDataset(**kw).batch(6, step=step, offset=offset)
    got = tsyn.TokenLMDataset(**kw).batch(6, step=step, offset=offset)
    for key in ("inputs", "targets"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_local_shard_iterator_bit_equal_to_jax():
    kw = dict(process_index=1, process_count=2, start_step=3)
    want = jsyn.local_shard_iterator(jsyn.TokenLMDataset(**DS), 8, **kw)
    got = tsyn.local_shard_iterator(tsyn.TokenLMDataset(**DS), 8, **kw)
    for _ in range(3):
        w, g = next(want), next(got)
        assert g["inputs"].shape == (4, SEQ)
        np.testing.assert_array_equal(g["inputs"], w["inputs"])
        np.testing.assert_array_equal(g["targets"], w["targets"])
    with pytest.raises(ValueError, match="not divisible"):
        next(tsyn.local_shard_iterator(tsyn.TokenLMDataset(**DS), 15,
                                       process_count=2))


# --------------------------------------------------------- writer, optim

def test_metric_writer_same_lines_as_jax(tmp_path):
    rows = [(1, {"loss": 2.5, "accuracy": 0.5}),
            (2, {"loss": 1.25, "accuracy": 0.75, "steps_per_sec": 3.0})]
    outs = []
    for mod, d in ((jmetrics, "j"), (tmetrics, "t")):
        out = io.StringIO()
        with mod.MetricWriter(tmp_path / d, stdout=out) as w:
            for step, m in rows:
                w.write(step, m)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "step=1 loss=2.5 accuracy=0.5" in outs[1]
    assert tmetrics.parse_stdout_metrics(outs[1]) == \
        jmetrics.parse_stdout_metrics(outs[0])
    assert (tmp_path / "t" / "metrics.jsonl").read_text().count("\n") == 2
    silent = io.StringIO()
    tmetrics.MetricWriter(tmp_path / "s", is_writer=False, stdout=silent).write(
        1, {"loss": 1.0})
    assert silent.getvalue() == "" and not (tmp_path / "s").exists()


def test_adamw_matches_optax_defaults():
    """Five updates of the port's ``adamw(1e-2)`` against
    ``optax.adamw(1e-2)`` (weight decay 1e-4, not torch's 0.01) on the
    same parameters and gradients. f32: the two spell the update in a
    different order (torch divides by sqrt of the bias correction, optax
    corrects the moments first), so atol 1e-6 on parameters of order 1."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(5)]
    tx = optax.adamw(1e-2)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adamw(1e-2)([tp])
    assert opt.defaults["weight_decay"] == 1e-4
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


# ------------------------------------------------ the trainer against JAX

def test_trainer_matches_jax_trainer():
    """Six steps from the same bridged initial parameters on the same
    batches: per-step losses within rtol 1e-4, final parameters within
    atol 1e-4 (f32; optax's adamw against the port's). The JAX trainer is
    built as tests/test_train.py builds one, on the 8-device CPU mesh; both
    models run flash attention (JAX its Pallas kernels in interpret mode,
    the port its autograd function over the CPU twins)."""
    jcfg = jtf.TransformerConfig(**KW, dtype=jnp.float32, interpret_kernels=True)
    jmodel = jtf.TransformerLM(jcfg)
    init = jax.tree_util.tree_map(
        np.asarray, jtf.make_init_fn(jmodel, SEQ)(jax.random.PRNGKey(0)))
    jt = JTrainer(
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, init),
        loss_fn=jtf.make_loss_fn(jmodel), optimizer=optax.adamw(1e-3),
        config=JTrainConfig(mesh=MeshSpec.data_parallel(len(jax.devices())),
                            global_batch=BATCH, steps=6, log_every=1),
    )
    jstate, jhist = jt.fit(
        lambda s: jsyn.local_shard_iterator(jsyn.TokenLMDataset(**DS), BATCH,
                                            start_step=s))

    def init_params(seed, device):
        model = ttf.TransformerLM(ttf.TransformerConfig(**KW), device=device,
                                  param_dtype=torch.float32)
        model.load_state_dict(params_to_state_dict(init))
        return model

    tt = Trainer(init_params=init_params, loss_fn=ttf.make_loss_fn(),
                 optimizer=adamw(1e-3),
                 config=TrainConfig(mesh=None, global_batch=BATCH, steps=6,
                                    log_every=1),
                 device="cpu")
    tstate, thist = tt.fit(_data)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == list(range(1, 7))
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    assert thist[-1]["loss"] < thist[0]["loss"]
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, jstate.params)))
    got = _params(tstate)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-4, rtol=0,
                                   err_msg="/".join(path))


# ------------------------------------------- the JAX trainer's contracts

def test_grad_accum_matches_single_batch():
    hists = []
    for accum in (1, 2):
        state, hist = _trainer(steps=4, grad_accum_steps=accum).fit(_data())
        assert state.step == 4
        hists.append([h["loss"] for h in hist])
    np.testing.assert_allclose(hists[0], hists[1], rtol=2e-5, atol=1e-6)


def test_prefetch_on_off_identical_per_step_metrics():
    runs = []
    for depth in (0, 3):
        _, hist = _trainer(steps=5, prefetch_depth=depth).fit(_data())
        runs.append(hist)
    for h0, h3 in zip(*runs):
        assert h0["step"] == h3["step"]
        assert h0["loss"] == h3["loss"] and h0["accuracy"] == h3["accuracy"]
    for key in ("data_stall_ms", "h2d_ms", "device_step_ms", "steps_per_sec"):
        assert key in runs[1][-1], key
    assert "compile_ms" in runs[1][0] and "compile_ms" not in runs[1][-1]


def test_resume_with_prefetch_neither_loses_nor_replays_batches(tmp_path, capsys):
    """A checkpointed 4+4 run lands bit-for-bit where an unbroken 8-step
    run lands (model and optimizer state), and the factory is asked for
    the streams starting at 0 and 4."""
    starts: list[int] = []

    def factory(start_step):
        starts.append(start_step)
        return _data(start_step)

    ckpt = CheckpointConfig(directory=str(tmp_path / "ckpt"), save_every_steps=2,
                            async_save=True)
    _trainer(steps=4, checkpoint=ckpt, prefetch_depth=3).fit(factory)
    resumed, hist = _trainer(steps=8, checkpoint=ckpt, prefetch_depth=3).fit(factory)
    assert starts == [0, 4]
    assert "resume_step=4" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [5, 6, 7, 8]
    unbroken, _ = _trainer(steps=8, prefetch_depth=3).fit(factory)
    a, b = _params(resumed), _params(unbroken)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg="/".join(path))
    assert Checkpointer(ckpt).all_steps() == [4, 6, 8]  # max_to_keep=3


def test_corrupt_latest_checkpoint_is_walked_past(tmp_path):
    ckpt = CheckpointConfig(directory=str(tmp_path / "c"), save_every_steps=2,
                            async_save=False)
    _trainer(steps=4, checkpoint=ckpt).fit(_data())
    c = Checkpointer(ckpt)
    assert c.all_steps() == [2, 4] and c.verify_step(4) is True
    blob = tmp_path / "c" / "4" / "state.pt"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blob.write_bytes(bytes(raw))
    assert c.verify_step(4) is False and c.latest_valid_step() == 2
    assert c.restore()["step"] == 2
    from kubeflow_tpu_torch.train.checkpoint import CorruptCheckpointError

    with pytest.raises(CorruptCheckpointError):
        c.restore(4)
    state, hist = _trainer(steps=5, checkpoint=ckpt).fit(lambda s: _data(s))
    assert [h["step"] for h in hist] == [3, 4, 5] and state.step == 5


def test_request_preemption_raises_preempted_with_checkpoint(tmp_path):
    ckpt = CheckpointConfig(directory=str(tmp_path / "p"), save_every_steps=100,
                            async_save=True)
    trainer = _trainer(steps=50, checkpoint=ckpt)

    def hook(step, m):
        if step == 3:
            trainer.request_preemption()

    with pytest.raises(Preempted) as exc:
        trainer.fit(_data(), hooks=[hook])
    assert exc.value.code == PREEMPTED_EXIT_CODE == 143
    step = exc.value.step
    assert 3 <= step < 50
    c = Checkpointer(ckpt)
    assert c.latest_valid_step() == step
    assert c.restore()["step"] == step
    assert live_kft_threads() == []


def test_nan_loss_raises_non_finite_metric_error():
    base = ttf.make_loss_fn()

    def poisoned(model, batch, gen):
        loss, aux = base(model, batch, gen)
        return loss * float("nan"), aux

    with pytest.raises(tmetrics.NonFiniteMetricError):
        _trainer(steps=3, loss_fn=poisoned).fit(_data())
    assert live_kft_threads() == []


def test_fit_joins_overlap_threads():
    state, hist = _trainer(steps=4, prefetch_depth=2).fit(_data())
    assert state.step == 4 and len(hist) == 4
    assert live_kft_threads() == []


def test_trainer_keeps_f32_master_weights():
    cfg = ttf.TransformerConfig(**KW, dtype=torch.bfloat16)
    t = Trainer(init_params=lambda seed, dev: ttf.TransformerLM(cfg, device=dev),
                loss_fn=ttf.make_loss_fn(), optimizer=adamw(1e-3),
                config=TrainConfig(mesh=None, global_batch=BATCH, steps=1),
                device="cpu")
    with pytest.raises(TypeError, match="f32 master weights"):
        t.init_state()
    state = Trainer(init_params=ttf.make_init_fn(cfg), loss_fn=ttf.make_loss_fn(),
                    optimizer=adamw(1e-3),
                    config=TrainConfig(mesh=None, global_batch=BATCH, steps=1),
                    device="cpu").init_state()
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}


def test_train_config_validation_matches_jax():
    for bad in (dict(check_numerics="loud"), dict(grad_accum_steps=0),
                dict(prefetch_depth=-1), dict(resume="maybe"),
                dict(grad_accum_steps=3)):
        with pytest.raises(ValueError):
            TrainConfig(mesh=None, global_batch=BATCH, steps=1, **bad)
        with pytest.raises(ValueError):
            JTrainConfig(mesh=MeshSpec.data_parallel(1), global_batch=BATCH,
                         steps=1, **bad)
    assert _trainer().local_batch_size(process_count=2) == BATCH // 2
    with pytest.raises(ValueError, match="not divisible"):
        _trainer().local_batch_size(process_count=3)


UNPORTED = [
    ("mesh", lambda: TrainConfig(mesh=object(), global_batch=BATCH, steps=1)),
    ("checkify", lambda: TrainConfig(mesh=None, global_batch=BATCH, steps=1,
                                     check_numerics="checkify")),
    ("debug_nans", lambda: TrainConfig(mesh=None, global_batch=BATCH, steps=1,
                                       debug_nans=True)),
    ("param_spec_fn", lambda: Trainer(
        init_params=None, loss_fn=None, optimizer=None,
        config=TrainConfig(mesh=None, global_batch=BATCH, steps=1),
        param_spec_fn=lambda p: None, device="cpu")),
    ("register", lambda: Checkpointer(CheckpointConfig(directory="unused")).save(
        1, {}, force=True, register=object())),
]


@pytest.mark.parametrize("name,make", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_knobs_raise(name, make, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()


def test_orchestrator_heartbeat_wiring_raises(monkeypatch, tmp_path):
    for key, val in (("KFT_WORKDIR", str(tmp_path)), ("KFT_REPLICA_TYPE", "worker"),
                     ("KFT_REPLICA_INDEX", "0")):
        monkeypatch.setenv(key, val)
    with pytest.raises(NotImplementedError, match="heartbeat"):
        _trainer(steps=1).fit(_data())


def test_fit_sets_the_overlap_gauges_on_the_registry():
    """``MetricsDrain`` mirrors every logged line onto the
    ``kubeflow_tpu_train_*`` gauges, the JAX trainer's names."""
    from kubeflow_tpu_torch.obs import prom

    _, hist = _trainer(steps=4).fit(_data())
    want = {g.name for g in jmetrics._overlap_gauges().values()}
    assert {g.name for g in tmetrics._OVERLAP_GAUGES.values()} == want
    text = prom.REGISTRY.expose()
    values = {ln.split(" ")[0]: float(ln.split(" ")[1])
              for ln in text.splitlines() if ln and not ln.startswith("#")}
    assert want <= set(values)
    last = hist[-1]
    for key, gauge in tmetrics._OVERLAP_GAUGES.items():
        if key in last:
            assert values[gauge.name] == pytest.approx(last[key])
    assert values["kubeflow_tpu_train_steps_per_sec"] > 0
