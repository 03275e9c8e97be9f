"""The training loop of the port: eager steps on one CUDA device.

Counterpart of the JAX package's ``train/loop.py``, with the same
``TrainConfig`` fields and defaults, the same ``Trainer`` lifecycle
(``fit`` over an iterator or a ``start_step -> iterator`` factory,
checkpoint resume from the newest valid step, the SIGTERM /
``request_preemption`` protocol with ``Preempted`` and exit code 143) and
the same overlap layer (``train/prefetch.py``). A step is the torch
spelling of the JAX one: the forward in ``cfg.dtype`` over f32 master
weights, ``loss.backward()``, ``optimizer.step()``; the optimizer updates
the weights in place, which is what ``donate_state`` buys in JAX.

Only the single-device layout is ported: ``mesh`` must be ``None``.
Sharding (``param_spec_fn``), checkify, ``debug_nans`` and the
orchestrator heartbeat raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal as _signal
import threading
import time
from collections.abc import Iterator
from typing import Any, Callable, Iterable, Mapping

import torch

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from kubeflow_tpu_torch.train.metrics import MetricWriter
from kubeflow_tpu_torch.train.prefetch import (
    MetricsDrain,
    device_placer,
    make_fetcher,
)

logger = logging.getLogger(__name__)

#: the container convention for SIGTERM death (128 + 15): retryable, so a
#: preempted job restarts and resumes
PREEMPTED_EXIT_CODE = 143

#: the orchestrator's gang wiring; under it the JAX trainer beats a
#: heartbeat file, which the port does not write yet
_HEARTBEAT_ENV = ("KFT_WORKDIR", "KFT_REPLICA_TYPE", "KFT_REPLICA_INDEX")


class Preempted(SystemExit):
    """Raised out of ``fit`` after a preemption notice was honoured: the
    final checkpoint is on disk and the process should exit ``code``."""

    def __init__(self, step: int, code: int = PREEMPTED_EXIT_CODE):
        super().__init__(code)
        self.step = step


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the step count: what
    the JAX ``TrainState`` holds, mutable in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


@dataclasses.dataclass
class TrainConfig:
    #: the device layout; only ``None`` (one device) is ported
    mesh: Any
    global_batch: int
    steps: int
    log_every: int = 10
    seed: int = 0
    checkpoint: CheckpointConfig | None = None
    #: True/"auto": restore from the newest checkpoint step whose sha256
    #: manifest verifies; False: always start from step 0
    resume: bool | str = True
    metrics_logdir: str | None = None
    #: install a SIGTERM handler for the duration of ``fit`` (main thread
    #: only; elsewhere ``Trainer.request_preemption`` delivers the notice)
    handle_sigterm: bool = True
    #: no effect: the optimizer already updates the weights in place
    donate_state: bool = True
    #: microbatches per step: equal slices of the batch, each backward
    #: scaled by 1/accum, one optimizer step
    grad_accum_steps: int = 1
    #: placed batches the background producer keeps ahead (0 = inline);
    #: each holds device memory
    prefetch_depth: int = 2
    #: "metrics": the MetricWriter raises NonFiniteMetricError on a NaN/inf
    #: logged metric; "off": no checks; "checkify" is not ported
    check_numerics: str = "metrics"
    debug_nans: bool = False

    def __post_init__(self) -> None:
        if self.check_numerics not in ("off", "metrics", "checkify"):
            raise ValueError(
                f"check_numerics={self.check_numerics!r}; expected "
                "'off', 'metrics', or 'checkify'"
            )
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}"
            )
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}"
            )
        if not isinstance(self.resume, bool) and self.resume != "auto":
            raise ValueError(
                f"resume={self.resume!r}; expected True, False, or 'auto'"
            )
        if self.global_batch % self.grad_accum_steps:
            raise ValueError(
                f"global batch {self.global_batch} not divisible by "
                f"grad_accum_steps={self.grad_accum_steps}"
            )
        if self.mesh is not None:
            raise NotImplementedError(
                "TrainConfig.mesh: only mesh=None (one device) is ported; "
                "meshes are ROADMAP queue 1 item 10"
            )
        if self.check_numerics == "checkify":
            raise NotImplementedError(
                "check_numerics='checkify' is not ported (ROADMAP queue 1 "
                "item 9, the rest of the training path)"
            )
        if self.debug_nans:
            raise NotImplementedError(
                "debug_nans is not ported (ROADMAP queue 1 item 9, the rest "
                "of the training path)"
            )


class Trainer:
    """Single-device trainer.

    ``init_params(seed, device) -> nn.Module`` builds the model with f32
    parameters; ``loss_fn(model, batch, generator) -> (loss, aux_dict)``;
    ``optimizer(parameters) -> torch.optim.Optimizer`` (``train/optim.py``).
    ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        *,
        init_params: Callable[[int, torch.device], torch.nn.Module],
        loss_fn: Callable[..., tuple[torch.Tensor, Mapping[str, Any]]],
        optimizer: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
        config: TrainConfig,
        param_spec_fn: Callable[[Any], Any] | None = None,
        device=None,
    ):
        if param_spec_fn is not None:
            raise NotImplementedError(
                "param_spec_fn (sharded parameters) is not ported "
                "(ROADMAP queue 1 item 10)"
            )
        self.config = config
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.init_params_fn = init_params
        self.device = resolve_device(device)
        #: preemption notice (SIGTERM or an explicit call), checked between
        #: steps
        self._preempt = threading.Event()

    def request_preemption(self) -> None:
        """Deliver a preemption notice in-process (what the SIGTERM handler
        calls): the loop saves a final checkpoint and raises ``Preempted``
        at the next step boundary. Safe from any thread."""
        self._preempt.set()

    # ------------------------------------------------------------------ #

    def init_state(self) -> TrainState:
        """The model from ``init_params(seed, device)``, with f32 master
        weights, in train mode, and its optimizer."""
        model = self.init_params_fn(self.config.seed, self.device)
        low = sorted({str(p.dtype) for p in model.parameters()
                      if p.dtype != torch.float32})
        if low:
            raise TypeError(
                f"parameters in {low}: the trainer keeps f32 master weights "
                "(build the model with param_dtype=torch.float32)"
            )
        model.train()
        return TrainState(model, self.optimizer(model.parameters()), 0)

    def _generator(self, *key: int) -> torch.Generator:
        """A generator for (seed, step[, microbatch]): ``fold_in``'s role."""
        seed = self.config.seed
        for k in key:
            seed = (seed * 1_000_003 + k + 1) % (2**63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _step(self, state: TrainState, batch: Mapping[str, torch.Tensor]) -> dict:
        """One optimizer step; returns the step's metric tensors (not
        synchronised)."""
        accum = self.config.grad_accum_steps
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        if accum == 1:
            loss, aux = self.loss_fn(model, batch, self._generator(state.step))
            loss.backward()
            aux = dict(aux)
        else:
            micro = {k: v.chunk(accum) for k, v in batch.items()}
            loss, aux = 0.0, {}
            for i in range(accum):
                mb = {k: v[i] for k, v in micro.items()}
                loss_i, aux_i = self.loss_fn(
                    model, mb, self._generator(state.step, i))
                (loss_i / accum).backward()
                loss = loss + loss_i.detach()
                for k, v in aux_i.items():
                    aux[k] = aux.get(k, 0.0) + v
            loss = loss / accum
            aux = {k: v / accum for k, v in aux.items()}
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def _stage(self, metrics: Mapping[str, torch.Tensor]) -> dict:
        """Metric tensors → host scalars the drain may read once the step's
        event has fired: on the card one non-blocking copy into pinned
        memory, queued behind the step."""
        if self.device.type != "cuda":
            return dict(metrics)
        keys = list(metrics)
        vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
        host = torch.empty(len(keys), dtype=torch.float32, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        return {k: host[i] for i, k in enumerate(keys)}

    def local_batch_size(self, process_count: int | None = None) -> int:
        n = 1 if process_count is None else process_count
        if self.config.global_batch % n:
            raise ValueError(
                f"global batch {self.config.global_batch} not divisible by "
                f"{n} processes — floor division would silently drop "
                f"{self.config.global_batch % n} examples per step"
            )
        return self.config.global_batch // n

    # ------------------------------------------------------------------ #

    def fit(
        self,
        data: Iterator[Any] | Iterable[Any] | Callable[[int], Iterator[Any]],
        *,
        writer: MetricWriter | None = None,
        hooks: list[Callable[[int, Mapping[str, float]], None]] | None = None,
    ) -> tuple[TrainState, list[dict]]:
        """Train for ``config.steps``; returns ``(state, history)``.

        ``data`` is ideally a factory ``start_step -> iterator``, so that a
        checkpoint resume continues the stream where training resumes; a
        plain iterator is accepted for runs that do not resume.
        """
        cfg = self.config
        if all(os.environ.get(k) is not None for k in _HEARTBEAT_ENV):
            raise NotImplementedError(
                "running under the orchestrator's gang wiring "
                f"({', '.join(_HEARTBEAT_ENV)}): the heartbeat writer is not "
                "ported (ROADMAP queue 1 item 10)"
            )
        own_writer = writer is None
        writer = writer or MetricWriter(
            cfg.metrics_logdir, nan_alarm=cfg.check_numerics != "off",
        )

        self._preempt.clear()
        prev_sigterm = None
        sigterm_installed = False
        if (
            cfg.handle_sigterm
            and threading.current_thread() is threading.main_thread()
        ):
            def _on_sigterm(signum, frame):  # noqa: ARG001
                logger.warning(
                    "SIGTERM received: taking a preemption checkpoint, "
                    "then exiting %d", PREEMPTED_EXIT_CODE,
                )
                self._preempt.set()

            try:
                prev_sigterm = _signal.signal(_signal.SIGTERM, _on_sigterm)
                sigterm_installed = True
            except (ValueError, OSError):
                sigterm_installed = False

        ckpt: Checkpointer | None = None
        try:
            state = self.init_state()
            start_step = 0
            if cfg.checkpoint is not None:
                ckpt = Checkpointer(cfg.checkpoint)
                if cfg.resume and ckpt.latest_step() is not None:
                    # the newest step whose sha256 manifest verifies: a
                    # corrupt latest checkpoint costs one save interval
                    state.load_state_dict(ckpt.restore())
                    start_step = state.step
                    logger.info("resumed from checkpoint at step %d", start_step)
                    print(f"resume_step={start_step}", flush=True)
            if callable(data) and not hasattr(data, "__next__"):
                it = iter(data(start_step))
            else:
                if start_step and not isinstance(data, Iterator):
                    logger.warning(
                        "resuming at step %d with a plain iterable: the data "
                        "stream restarts from its beginning; pass a "
                        "start_step->iterator factory for a faithful resume",
                        start_step,
                    )
                it = iter(data)
            history: list[dict] = []
            return self._fit_loop(state, it, ckpt, writer, hooks, history,
                                  start_step)
        finally:
            if sigterm_installed:
                try:
                    _signal.signal(
                        _signal.SIGTERM,
                        prev_sigterm if prev_sigterm is not None
                        else _signal.SIG_DFL,
                    )
                except (ValueError, OSError):
                    pass
            if ckpt is not None:
                ckpt.close()  # blocks until the last save is durable
            if own_writer:
                writer.close()

    def _fit_loop(self, state, it, ckpt, writer, hooks, history, start_step):
        """The overlapped hot loop: batches are placed ``prefetch_depth``
        ahead by a producer thread, each step's metrics go to a drain
        thread with an event recorded after the step, and the loop thread
        synchronises with the card once, after the first step
        (``compile_ms``: kernel builds, cuBLAS and allocator warm-up)."""
        cfg = self.config
        cuda = self.device.type == "cuda"
        fetcher = make_fetcher(it, device_placer(self.device),
                               depth=cfg.prefetch_depth)
        drain = MetricsDrain(writer, history=history, hooks=hooks)
        compile_ms = None
        t_last = time.perf_counter()
        last_logged = start_step
        try:
            for step in range(start_step, cfg.steps):
                drain.poll()  # bounded-lag NaN alarm / drain-error surface
                if self._preempt.is_set():
                    self._preemption_save(ckpt, state, step)
                    raise Preempted(step)
                batch = next(fetcher).claim()
                if compile_ms is None:
                    t0 = time.perf_counter()
                    metrics = self._step(state, batch)
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    compile_ms = (time.perf_counter() - t0) * 1e3
                else:
                    metrics = self._step(state, batch)
                if ckpt is not None and ckpt.should_save(step + 1):
                    ckpt.save(step + 1, state.state_dict())
                is_log = (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps
                extra = None
                if is_log:
                    now = time.perf_counter()
                    extra = {
                        "fallback_steps_per_sec": max(
                            step + 1 - last_logged, 1
                        ) / max(now - t_last, 1e-9),
                        **fetcher.window_stats(),
                    }
                    if compile_ms:
                        extra["compile_ms"] = compile_ms  # once
                        compile_ms = 0.0
                    t_last, last_logged = now, step + 1
                staged = self._stage(metrics) if is_log else {}
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
                drain.put(step + 1, staged, log=is_log, event=event, extra=extra)
            drain.close()  # flush; surfaces a pending NaN alarm
        finally:
            fetcher.close()
            drain.shutdown()
            if ckpt is not None:
                self._final_save(ckpt, state)
        drain.poll()
        return state, history

    @staticmethod
    def _preemption_save(ckpt: Checkpointer | None, state: TrainState,
                         step: int) -> None:
        """Force-save the current state (the loop-top invariant is
        ``state.step == step``) so the restart resumes at exactly
        ``step``; ``fit``'s ``ckpt.close()`` makes it durable."""
        if ckpt is not None and ckpt.latest_step() != step:
            ckpt.save(step, state.state_dict(), force=True)
        logger.warning(
            "preempted at step %d: final checkpoint %s; exiting %d",
            step,
            "saved" if ckpt is not None else "unavailable (no checkpoint "
            "config)",
            PREEMPTED_EXIT_CODE,
        )

    @staticmethod
    def _final_save(ckpt: Checkpointer, state: TrainState) -> None:
        if ckpt.latest_step() != state.step:
            ckpt.save(state.step, state.state_dict(), force=True)
