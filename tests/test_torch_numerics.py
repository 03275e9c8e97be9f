"""Checked numerics in the port's trainer: ``tests/test_numerics.py``'s
contracts re-run on ``kubeflow_tpu_torch`` (the MNIST CNN at batch 16,
one poisoned pixel), plus what the port adds: the located error names the
module or parameter, a failed checked step leaves the weights as they
were, ``debug_nans`` raises ``FloatingPointError`` as ``jax_debug_nans``
does, and every hook is gone after ``fit``. The JAX trainer's own
contracts are ``tests/test_numerics.py``'s; this file runs no JAX (its
``debug_nans`` would set a process-wide flag).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.data.synthetic import (
    ClassPrototypeDataset,
    local_shard_iterator,
)
from kubeflow_tpu_torch.models.mnist_cnn import make_init_fn, make_loss_fn
from kubeflow_tpu_torch.train import TrainConfig, Trainer, adam
from kubeflow_tpu_torch.train.metrics import NonFiniteMetricError
from kubeflow_tpu_torch.train.numerics import CheckifyError
from kubeflow_tpu_torch.train.prefetch import live_kft_threads


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


def _trainer(models=None, loss_fn=None, **overrides):
    """The port's MNIST trainer; ``models`` collects every model it builds."""
    init = make_init_fn()

    def init_params(seed, device):
        model = init(seed, device)
        if models is not None:
            models.append(model)
        return model

    cfg = dict(mesh=None, global_batch=16, steps=4, log_every=1)
    cfg.update(overrides)
    return Trainer(init_params=init_params, loss_fn=loss_fn or make_loss_fn(),
                   optimizer=adam(1e-3), config=TrainConfig(**cfg),
                   device="cpu")


def _poisoned_stream(poison_at: int):
    ds = ClassPrototypeDataset()

    def factory(start_step):
        def gen():
            it = local_shard_iterator(ds, 16, start_step=start_step)
            for step, (x, y) in enumerate(it, start=start_step):
                if step == poison_at:
                    x = x.copy()
                    x[0, 0, 0, 0] = np.nan  # one poisoned pixel
                yield x, y

        return gen()

    return factory


CLEAN = 10**9


def _no_hooks(model):
    return all(not m._forward_hooks for m in model.modules())


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """No test leaves anomaly mode, TF32 flags or the default dtype set."""
    before = (torch.is_anomaly_enabled(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, torch.get_default_dtype())
    yield
    assert (torch.is_anomaly_enabled(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_default_dtype()) == before


def test_clean_run_unchanged():
    state, history = _trainer().fit(_poisoned_stream(CLEAN))
    assert state.step == 4
    assert all(np.isfinite(h["loss"]) for h in history)


def test_poisoned_batch_fails_fast_default_mode():
    with pytest.raises(NonFiniteMetricError, match="step 3"):
        _trainer().fit(_poisoned_stream(poison_at=2))
    assert live_kft_threads() == []


def test_poisoned_batch_checkify_locates_the_nan():
    """The first module whose output went NaN is the first conv; the step
    raised before its update, so the weights are those of a clean 1-step
    run, and the hooks are gone."""
    models: list = []
    with pytest.raises(CheckifyError, match="(?i)nan") as exc:
        _trainer(models, check_numerics="checkify").fit(_poisoned_stream(1))
    assert "'Conv_0'" in str(exc.value) and "step 2" in str(exc.value)
    clean: list = []
    _trainer(clean, steps=1).fit(_poisoned_stream(CLEAN))
    (failed,), (one,) = models, clean
    for (name, a), b in zip(failed.state_dict().items(), one.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert _no_hooks(failed)


def test_checkify_names_a_non_finite_gradient():
    """A loss that is finite while one gradient is not (d sqrt(0) = inf,
    times 0): checkify names the parameter."""
    base = make_loss_fn()

    def loss_fn(model, batch, key):
        loss, aux = base(model, batch, key)
        b = model.Dense_1.bias
        return loss + 0.0 * torch.sqrt(b - b.detach()).sum(), aux

    with pytest.raises(CheckifyError, match="gradient of parameter 'Dense_1.bias'"):
        _trainer(loss_fn=loss_fn, check_numerics="checkify").fit(
            _poisoned_stream(CLEAN))


def test_checkify_clean_run_matches_default():
    """checkify instrumentation must not change the math."""
    _, h1 = _trainer().fit(_poisoned_stream(CLEAN))
    models: list = []
    _, h2 = _trainer(models, check_numerics="checkify").fit(_poisoned_stream(CLEAN))
    np.testing.assert_allclose([h["loss"] for h in h1], [h["loss"] for h in h2],
                               rtol=1e-6)
    assert _no_hooks(models[0])


def test_debug_nans_raises_floating_point_error():
    """``debug_nans`` on the poisoned stream: ``FloatingPointError`` at the
    first module output that went NaN, as ``jax_debug_nans`` raises at
    the first primitive; the hooks are gone after ``fit``."""
    models: list = []
    with pytest.raises(FloatingPointError,
                       match="nan in the output of module 'Conv_0'"):
        _trainer(models, debug_nans=True).fit(_poisoned_stream(1))
    assert _no_hooks(models[0])
    assert live_kft_threads() == []


@pytest.mark.parametrize("mode", ["checkify", "debug_nans"])
def test_checked_modes_leave_nothing_installed(mode):
    """A clean run in either mode trains as the default does; afterwards
    no hook is left on the model and anomaly mode is off."""
    knob = {"check_numerics": "checkify"} if mode == "checkify" else {"debug_nans": True}
    models: list = []
    state, hist = _trainer(models, steps=2, **knob).fit(_poisoned_stream(CLEAN))
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert _no_hooks(models[0]) and not torch.is_anomaly_enabled()
