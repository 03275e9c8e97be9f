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

The loss's third argument is the JAX step key: ``fold_in(PRNGKey(seed),
step)``, folded again with the microbatch index under gradient
accumulation, from the port's own threefry (``serve/threefry.py``), so a
loss that draws from it (the BERT MLM mask) draws what the JAX loss
draws. ``check_numerics="checkify"`` and ``debug_nans`` run the step
under ``train/numerics.py``'s hooks for the length of ``fit``.

**Under a mesh** (``TrainConfig.mesh``, a ``MeshSpec``) the trainer is
SPMD across processes, one rank each, brought up from the JAX env
contract (``core/distributed.py``): ``Trainer`` builds this rank's
``core/mesh.py`` mesh and runs every step under it. ``init_state``
builds the full model and keeps this rank's shard of each parameter by
its spec (``param_spec_fn``, e.g. ``parallel/sharding.py``
``transformer_rules()``; replicated without one): dims over ``fsdp``
are gathered at use (their gradient reduce-scattered back), ``model``
and ``expert`` slices are computed with as they are. Each rank feeds its
block of the batch (``data/synthetic.py`` ``local_shard_iterator(...,
mesh=)``); the loss is the global mean, every rank's backward yields its
share of the gradient, and the shares are summed over the token axes a
parameter is not gathered over, one bucket a set of axes. Under
gradient accumulation the step's rows are gathered over the batch axes
and each rank keeps its partition of every microbatch, so microbatch i
holds JAX's global rows ``[i*B/accum, (i+1)*B/accum)``. Logged loss
and metrics are global, as the JAX jitted step's are. A checkpoint
under a mesh holds the full state (parameters and optimizer state
gathered, written by rank 0) in the single-device format, so it
resumes on one device or under another mesh.

Under the orchestrator's gang wiring (``KFT_WORKDIR``,
``KFT_REPLICA_TYPE``, ``KFT_REPLICA_INDEX``) ``fit`` runs the heartbeat
writer of ``obs/heartbeat.py`` and stamps every completed step into it,
as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import logging
import signal as _signal
import threading
import time
from collections.abc import Iterator
from typing import Any, Callable, Iterable, Mapping

import torch

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import (
    Axis, Mesh, MeshSpec, build_mesh, mesh_context, per_device_batch,
)
from kubeflow_tpu_torch.obs.heartbeat import HeartbeatWriter
from kubeflow_tpu_torch.parallel.sharding import (
    P, check_spec, gathered_axes, shard_module, shard_tensor, unshard_tensor,
)
from kubeflow_tpu_torch.serve.threefry import key_of
from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from kubeflow_tpu_torch.train.metrics import MetricWriter
from kubeflow_tpu_torch.train.numerics import NumericsGuard
from kubeflow_tpu_torch.train.prefetch import (
    MetricsDrain,
    device_placer,
    make_fetcher,
    map_batch,
)

logger = logging.getLogger(__name__)

#: the container convention for SIGTERM death (128 + 15): retryable, so a
#: preempted job restarts and resumes
PREEMPTED_EXIT_CODE = 143

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
    #: the device layout: a ``MeshSpec`` over the ranks of the default
    #: process group, or ``None`` for one device
    mesh: MeshSpec | None
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
    #: microbatches per step: equal slices of the global batch, each
    #: backward scaled by 1/accum, one optimizer step
    grad_accum_steps: int = 1
    #: placed batches the background producer keeps ahead (0 = inline);
    #: each holds device memory
    prefetch_depth: int = 2
    #: "metrics": the MetricWriter raises NonFiniteMetricError on a NaN/inf
    #: logged metric; "checkify": every step's outputs, gradients and loss
    #: are tested on the card, read back once a step, and the first
    #: non-finite one raises ``CheckifyError`` naming its module or
    #: parameter before the update; "off": no checks
    check_numerics: str = "metrics"
    #: raise FloatingPointError at the first non-finite module output or
    #: gradient (a sync per test), for the length of ``fit``
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
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            raise TypeError(
                f"TrainConfig.mesh must be a MeshSpec or None, got {self.mesh!r}")


class Trainer:
    """Trainer on one device or, under ``config.mesh``, one rank of a mesh.

    ``init_params(seed, device) -> nn.Module`` builds the model with f32
    parameters; ``loss_fn(model, batch, key) -> (loss, aux_dict)``, with
    ``key`` the JAX step key as a ``(2,)`` int64 CPU tensor;
    ``optimizer(parameters) -> torch.optim.Optimizer`` (``train/optim.py``).
    ``param_spec_fn(model) -> {parameter name: spec}`` lays the
    parameters out over the mesh (``parallel/sharding.py``).
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
        self.config = config
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.init_params_fn = init_params
        self.param_spec_fn = param_spec_fn
        self.device = resolve_device(device)
        #: this rank's mesh (``None`` without ``config.mesh``)
        self.mesh: Mesh | None = None
        if config.mesh is not None:
            self.mesh = build_mesh(config.mesh, device=self.device)
        #: parameter name -> spec, set by ``init_state``
        self.specs: dict[str, P] = {}
        #: the step of the newest checkpoint this run wrote or resumed
        #: (under a mesh every rank decides saves from it alike)
        self._last_saved: int | None = None
        #: preemption notice (SIGTERM or an explicit call), checked between
        #: steps
        self._preempt = threading.Event()
        #: checkify / debug_nans hooks, installed for the length of ``fit``
        self._guard: NumericsGuard | None = None

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
        if self.param_spec_fn is not None or self.mesh is not None:
            self._shard(model)
        model.train()
        return TrainState(model, self.optimizer(model.parameters()), 0)

    # -- the mesh layout ------------------------------------------------- #

    def _shard(self, model: torch.nn.Module) -> None:
        """Keep this rank's shard of every parameter (``kft_spec`` names
        its spec) and group the parameters by the axes their gradient
        shares are summed over."""
        specs = dict(self.param_spec_fn(model)) if self.param_spec_fn else {}
        if self.mesh is not None:
            self.specs = shard_module(model, specs, self.mesh)
        else:
            self.specs = {}
            for name, p in model.named_parameters():
                spec = P(*specs.get(name, P())).padded(p.dim())
                check_spec(spec)
                self.specs[name] = spec
        self._buckets: dict[tuple[str, ...], list[str]] = {}
        if self.mesh is not None:
            for name in self.specs:
                axes = tuple(a for a in Axis.TOKENS
                             if a not in gathered_axes(self.specs[name]))
                self._buckets.setdefault(axes, []).append(name)

    def _sync_grads(self, model: torch.nn.Module) -> None:
        """Sum each parameter's gradient share over the token axes it was
        not gathered over: one all-reduce a bucket."""
        params = dict(model.named_parameters())
        for axes, names in self._buckets.items():
            if self.mesh.group(axes) is None:
                continue
            ps = [params[n] for n in names]
            flat = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1) for p in ps])
            flat = coll._all_reduce(flat, self.mesh, axes)
            for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad = g.view_as(p)

    def _full(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """The full tensor from every rank's shard (a collective)."""
        return unshard_tensor(t, spec, self.mesh)

    def full_state_dict(self, state: TrainState) -> dict:
        """The state in the single-device checkpoint format: under a mesh
        every parameter and optimizer-state tensor gathered to its full
        shape (a collective: every rank calls it)."""
        sd = state.state_dict()
        if self.mesh is None:
            return sd
        names = [n for n, _ in state.model.named_parameters()]
        sd["model"] = {k: self._full(v, self.specs[k]) if k in self.specs else v
                       for k, v in sd["model"].items()}
        for idx, st in sd["optimizer"]["state"].items():
            spec = self.specs[names[idx]]
            sd["optimizer"]["state"][idx] = {
                k: self._full(v, spec) if torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
        return sd

    def _load_full(self, state: TrainState, sd: Mapping[str, Any]) -> None:
        """Restore a single-device (full) state, keeping this rank's shards."""
        if self.mesh is not None:
            names = [n for n, _ in state.model.named_parameters()]
            sd = dict(sd)
            sd["model"] = {k: shard_tensor(v, self.specs[k], self.mesh)
                           if k in self.specs else v for k, v in sd["model"].items()}
            opt = dict(sd["optimizer"])
            opt["state"] = {
                idx: {k: shard_tensor(v, self.specs[names[idx]], self.mesh)
                      if torch.is_tensor(v) and v.dim() else v
                      for k, v in st.items()}
                for idx, st in sd["optimizer"]["state"].items()}
            sd["optimizer"] = opt
        state.load_state_dict(sd)

    def _step(self, state: TrainState, batch: Any) -> dict:
        """One optimizer step; returns the step's metric tensors (not
        synchronised, unless checked numerics read them back)."""
        accum = self.config.grad_accum_steps
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        key = key_of(self.config.seed, state.step)
        if accum == 1:
            loss, aux = self.loss_fn(model, batch, key)
            loss.backward()
            aux = dict(aux)
        else:
            loss, aux = 0.0, {}
            micro = map_batch(lambda v: self._microbatches(v, accum), batch)
            for i in range(accum):
                mb = map_batch(lambda v: v[i], micro)
                loss_i, aux_i = self.loss_fn(
                    model, mb, key_of(self.config.seed, state.step, i))
                (loss_i / accum).backward()
                loss = loss + loss_i.detach()
                for k, v in aux_i.items():
                    aux[k] = aux.get(k, 0.0) + v
            loss = loss / accum
            aux = {k: v / accum for k, v in aux.items()}
        if self.mesh is not None:
            self._sync_grads(model)
        if self._guard is not None:
            self._guard.check_step(model, loss, state.step)
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def _microbatches(self, v: torch.Tensor, accum: int) -> torch.Tensor:
        """This rank's rows of each microbatch, stacked on a new dim 0.

        JAX reshapes the global batch to ``[accum, B/accum, ...]`` and
        shards each microbatch over the batch axes, so microbatch i holds
        the global rows ``[i*B/accum, (i+1)*B/accum)``. Under a mesh the
        step's rows are gathered over the batch axes first, and this rank
        keeps its partition of each microbatch: the same rows as JAX's,
        which an MoE layer's capacity and drops (counted a microbatch)
        depend on."""
        if self.mesh is not None:
            v = coll._all_gather(v, self.mesh, Axis.BATCH, 0)
            parts = self.mesh.spec.batch_partitions
            return v.reshape(accum, parts, -1, *v.shape[1:])[:, self.mesh.batch_index]
        return v.reshape(accum, -1, *v.shape[1:])

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
        if self.mesh is not None:
            per_device_batch(cfg.global_batch, cfg.mesh)
            per_device_batch(cfg.global_batch // cfg.grad_accum_steps, cfg.mesh)
        own_writer = writer is None
        writer = writer or MetricWriter(
            cfg.metrics_logdir, nan_alarm=cfg.check_numerics != "off",
            is_writer=self.mesh is None or self.mesh.rank == 0,
        )
        # liveness under the orchestrator's gang wiring: a background beat
        # and a stamp a completed step (no-op outside a gang)
        hb = HeartbeatWriter.from_env()
        if hb is not None:
            hb.start()

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
            mode = ("debug_nans" if cfg.debug_nans else
                    "checkify" if cfg.check_numerics == "checkify" else None)
            if mode is not None:
                self._guard = NumericsGuard(state.model, mode)
            start_step = 0
            if cfg.checkpoint is not None:
                ckpt = Checkpointer(cfg.checkpoint)
                self._last_saved = ckpt.latest_step()
                if cfg.resume and ckpt.latest_step() is not None:
                    # the newest step whose sha256 manifest verifies: a
                    # corrupt latest checkpoint costs one save interval
                    self._load_full(state, ckpt.restore())
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
            with mesh_context(self.mesh):
                return self._fit_loop(state, it, ckpt, writer, hooks, history,
                                      start_step, hb)
        finally:
            if hb is not None:
                hb.stop()
            if self._guard is not None:
                self._guard.remove()
                self._guard = None
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

    def _fit_loop(self, state, it, ckpt, writer, hooks, history, start_step,
                  hb=None):
        """The overlapped hot loop: batches are placed ``prefetch_depth``
        ahead by a producer thread, each step's metrics go to a drain
        thread with an event recorded after the step, and the loop thread
        synchronises with the card once, after the first step
        (``compile_ms``: kernel builds, cuBLAS and allocator warm-up)."""
        cfg = self.config
        cuda = self.device.type == "cuda"
        fetcher = make_fetcher(it, device_placer(self.device),
                               depth=cfg.prefetch_depth)
        drain = MetricsDrain(writer, history=history, hooks=hooks, heartbeat=hb)
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
                if ckpt is not None and self._due(ckpt, step + 1):
                    self._save(ckpt, step + 1, state)
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

    def _due(self, ckpt: Checkpointer, step: int) -> bool:
        """``Checkpointer.should_save`` on this run's own record of the
        newest step, which every rank of a mesh keeps alike (rank 0's
        write may still be in flight)."""
        return (step % ckpt.config.save_every_steps == 0
                and (self._last_saved is None or step > self._last_saved))

    def _save(self, ckpt: Checkpointer, step: int, state: TrainState) -> None:
        if self.mesh is None:
            ckpt.save(step, state.state_dict(), force=True)
        else:
            full = self.full_state_dict(state)  # every rank gathers
            if self.mesh.rank == 0:
                ckpt.save(step, full, force=True)
        self._last_saved = (step if self._last_saved is None
                            else max(self._last_saved, step))

    def _preemption_save(self, ckpt: Checkpointer | None, state: TrainState,
                         step: int) -> None:
        """Force-save the current state (the loop-top invariant is
        ``state.step == step``) so the restart resumes at exactly
        ``step``; ``fit``'s ``ckpt.close()`` makes it durable."""
        if ckpt is not None and self._last_saved != step:
            self._save(ckpt, step, state)
        logger.warning(
            "preempted at step %d: final checkpoint %s; exiting %d",
            step,
            "saved" if ckpt is not None else "unavailable (no checkpoint "
            "config)",
            PREEMPTED_EXIT_CODE,
        )

    def _final_save(self, ckpt: Checkpointer, state: TrainState) -> None:
        if self._last_saved != state.step:
            self._save(ckpt, state.step, state)
