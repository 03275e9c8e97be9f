"""Checked numerics for the trainer: ``check_numerics="checkify"`` and
``debug_nans``, the port's counterparts of the JAX trainer's
``checkify.float_checks`` step and ``jax_debug_nans``.

Both work by hooks that :class:`NumericsGuard` installs on a model for
the length of one ``fit`` and removes on every exit:

- a forward hook on every submodule tests each floating output for a
  non-finite value; forward hooks run in post-order, so the first
  flagged call is the innermost module that first produced one, in
  forward order;
- after the backward, every parameter's gradient is tested, in
  ``named_parameters`` order, and so is the loss.

Under ``"checkify"`` each test leaves a device flag, the step's flags
are stacked and read back once (one sync a step), and a non-finite value
raises :class:`CheckifyError` naming where it first appeared (the
module, or the parameter whose gradient went non-finite) before
``optimizer.step()``: a failed step leaves the weights as they were, as
the JAX step does. JAX names the primitive and its source line; the port
names the module. Under ``debug_nans`` each test is read at once and the
first non-finite value raises ``FloatingPointError``, as
``jax_debug_nans`` does at the first primitive that produced one.

JAX sets ``jax_debug_nans`` for the whole process; the guard's hooks
live only as long as the ``fit`` that installed them.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.train.prefetch import batch_leaves


class CheckifyError(RuntimeError):
    """A checked step produced a NaN or inf; the message says where."""


class NumericsGuard:
    """Non-finite checks on ``model``'s forward outputs, gradients and
    loss; ``mode`` is ``"checkify"`` or ``"debug_nans"``. Call
    :meth:`remove` when done."""

    def __init__(self, model: torch.nn.Module, mode: str):
        if mode not in ("checkify", "debug_nans"):
            raise ValueError(f"unknown numerics mode {mode!r}")
        self.mode = mode
        self._flags: list[torch.Tensor] = []
        self._where: list[str] = []
        root = type(model).__name__
        self._handles = [
            module.register_forward_hook(self._hook(
                f"module {name or root!r} ({type(module).__name__})"))
            for name, module in model.named_modules()
        ]

    def _hook(self, where: str):
        def on_output(module, args, output):  # noqa: ARG001
            for t in batch_leaves(output):
                if torch.is_tensor(t) and t.is_floating_point():
                    self._test(t.detach(), f"the output of {where}")

        return on_output

    def _test(self, t: torch.Tensor, where: str) -> None:
        flag = torch.stack([t.isnan().any(), ~t.isfinite().all()])
        if self.mode == "debug_nans":
            nan, bad = flag.tolist()
            if bad:
                raise FloatingPointError(
                    f"{'nan' if nan else 'inf'} in {where} (debug_nans)")
            return
        self._flags.append(flag)
        self._where.append(where)

    def check_step(self, model: torch.nn.Module, loss: torch.Tensor,
                   step: int) -> None:
        """After the backward, before the update: test the loss and every
        gradient, then (checkify) read the step's flags back once and
        raise at the first non-finite value. Clears the step's flags."""
        self._test(loss.detach(), "the loss")
        for name, p in model.named_parameters():
            if p.grad is not None:
                self._test(p.grad, f"the gradient of parameter {name!r}")
        if self.mode != "checkify":
            return
        flags, where = self._flags, self._where
        self._flags, self._where = [], []
        hits = torch.stack(flags).tolist()
        for (nan, bad), w in zip(hits, where):
            if bad:
                raise CheckifyError(
                    f"{'nan' if nan else 'inf'} first appeared in {w} at step "
                    f"{step + 1} (check_numerics='checkify'); the step's "
                    "update was not applied")

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
