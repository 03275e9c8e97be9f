"""Rank bootstrap from the orchestrator's env contract: the port of
``kubeflow_tpu/core/distributed.py``.

The port reads the same variables the JAX workers read (the orchestrator
writes them, ``kubeflow_tpu/orchestrator/envwire.py``):

- ``JAX_COORDINATOR_ADDRESS`` — ``host:port`` of rank 0 (here the
  ``torch.distributed`` TCP store; a ``file://`` URL names a file store);
- ``JAX_NUM_PROCESSES`` — the world size;
- ``JAX_PROCESS_ID`` — this process's rank;
- ``JAX_LOCAL_DEVICE_IDS`` — optional, comma-separated: the card(s) this
  process drives;

with the GKE ``TPU_WORKER_*`` fallback, and calls
``torch.distributed.init_process_group`` once.

:func:`choose_backend` is the one place the backend is picked: ``nccl``
only when every rank on this host has a card of its own, else ``gloo``,
whose collectives on CUDA tensors ``core/collectives.py`` stages through
pinned host memory (several ranks on one card: NCCL refuses two ranks on
one device). The ranks on this host are ``LOCAL_WORLD_SIZE`` where the
env sets it (:func:`launch` does, as torchrun does); the world size spans
every host and says nothing of them. :func:`launch` starts ``n`` rank
processes with that env, as the orchestrator would, and gathers what each
returns: a failed rank or a timeout kills the others and raises with the
rank's traceback.
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import logging
import os
import socket
import time
import traceback

logger = logging.getLogger(__name__)

ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_LOCAL_DEVICE_IDS = "JAX_LOCAL_DEVICE_IDS"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
#: the ranks on this host (torchrun's name; :func:`launch` sets it)
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

#: the default process-group timeout: a collective that waits longer
#: fails the rank instead of hanging the gang
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Resolved multi-process rendezvous parameters."""

    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0
    local_device_ids: tuple[int, ...] | None = None

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "DistributedConfig":
        """Explicit ``JAX_*`` contract > GKE ``TPU_WORKER_*`` vars >
        single process, as the JAX package resolves it."""
        e = os.environ if env is None else env
        if ENV_NUM_PROCESSES in e:
            cfg = cls(
                coordinator_address=e.get(ENV_COORDINATOR_ADDRESS),
                num_processes=int(e[ENV_NUM_PROCESSES]),
                process_id=int(e.get(ENV_PROCESS_ID, "0")),
                local_device_ids=_parse_device_ids(e.get(ENV_LOCAL_DEVICE_IDS)),
            )
        elif ENV_TPU_WORKER_HOSTNAMES in e:
            hosts = [h for h in e[ENV_TPU_WORKER_HOSTNAMES].split(",") if h]
            if len(hosts) > 1 and ENV_TPU_WORKER_ID not in e:
                raise ValueError(
                    f"{ENV_TPU_WORKER_HOSTNAMES} lists {len(hosts)} workers "
                    f"but {ENV_TPU_WORKER_ID} is unset; every worker would "
                    "claim rank 0"
                )
            cfg = cls(
                coordinator_address=f"{hosts[0]}:8476" if hosts else None,
                num_processes=max(len(hosts), 1),
                process_id=int(e.get(ENV_TPU_WORKER_ID, "0")),
            )
        else:
            cfg = cls()
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >=1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range "
                f"[0, {self.num_processes})"
            )
        if self.is_multiprocess and not self.coordinator_address:
            raise ValueError(
                f"{ENV_COORDINATOR_ADDRESS} required when "
                f"{ENV_NUM_PROCESSES} > 1"
            )


def _parse_device_ids(raw: str | None) -> tuple[int, ...] | None:
    if not raw:
        return None
    return tuple(int(x) for x in raw.split(",") if x.strip())


def local_world_size(env: dict[str, str] | None = None) -> int | None:
    """The ranks on this host, from ``LOCAL_WORLD_SIZE``; ``None`` when the
    env does not say (a gang of one rank a host, as JAX runs one process
    a host)."""
    e = os.environ if env is None else env
    raw = e.get(ENV_LOCAL_WORLD_SIZE)
    return int(raw) if raw else None


def choose_backend(device, local_world_size: int | None,
                   local_device_ids: tuple[int, ...] | None = None) -> str:
    """``nccl`` only when ``device`` is CUDA and every rank on this host
    drives a card of its own; ``gloo`` otherwise. A rank that names one
    card (``JAX_LOCAL_DEVICE_IDS``, the orchestrator gives each local rank
    its own) has its own when that card exists and the host's ranks
    (``local_world_size``, ``None`` when unknown) are no more than its
    cards; a rank that names none takes card 0, its own only when it is
    alone on the host (``None`` counts as alone: one rank a host). With
    several ranks on one card, gloo's collectives on CUDA tensors are
    staged through pinned host memory (``core/collectives.py``)."""
    import torch

    if torch.device(device).type != "cuda":
        return "gloo"
    if local_device_ids is None:
        return "nccl" if local_world_size in (None, 1) else "gloo"
    cards = torch.cuda.device_count()
    own = (len(local_device_ids) == 1 and local_device_ids[0] < cards
           and (local_world_size is None or local_world_size <= cards))
    return "nccl" if own else "gloo"


def rank_device(cfg: DistributedConfig, device=None):
    """The device this rank computes on: ``cpu`` when asked; on CUDA the
    first of its ``JAX_LOCAL_DEVICE_IDS`` (card 0 when unset)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (cfg.local_device_ids or (0,))[0])
    return dev


_initialized = False


def initialize(cfg: DistributedConfig, *, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Bring up the default process group once (idempotent); returns the
    backend, or ``None`` for a single process (nothing to bring up). The
    backend is printed with the rank, so nothing falls back unseen."""
    import torch
    import torch.distributed as dist

    global _initialized
    if _initialized or dist.is_initialized():
        return dist.get_backend()
    if not cfg.is_multiprocess:
        return None
    dev = rank_device(cfg, device)
    backend = choose_backend(dev, local_world_size(), cfg.local_device_ids)
    addr = cfg.coordinator_address
    init_method = addr if addr.startswith("file://") else f"tcp://{addr}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=cfg.num_processes,
        rank=cfg.process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    _initialized = True
    logger.info("torch.distributed up: rank %d/%d via %s, backend %s%s",
                cfg.process_id, cfg.num_processes, addr, backend,
                " (host-staged)" if backend == "gloo" and dev.type == "cuda"
                else "")
    return backend


def initialize_from_env(*, device=None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> DistributedConfig:
    """The bootstrap every worker calls first."""
    cfg = DistributedConfig.from_env()
    initialize(cfg, device=device, timeout_s=timeout_s)
    return cfg


def shutdown() -> None:
    """Tear the default process group down (the launcher's ranks call it)."""
    import torch.distributed as dist

    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


# --------------------------------------------------------------------------- #
# local launcher
# --------------------------------------------------------------------------- #

def free_port() -> int:
    """A TCP port free on localhost now (the OS's next ephemeral one)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, inputs, rank, env, device, timeout_s, results,
               world_timeout_s):
    os.environ.update(env)
    # a rank still running when the world's time is nearly up prints
    # where each of its threads is before the launcher kills it
    faulthandler.dump_traceback_later(max(world_timeout_s - 3.0, 1.0))
    try:
        import torch

        torch.set_num_threads(1)  # ranks share the host's cores
        args = inputs.get(timeout=timeout_s)
        initialize_from_env(device=device, timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, who fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown()
        except Exception:  # noqa: BLE001 — the rank is ending either way
            pass


def launch(fn, nprocs: int, *, args: tuple = (), timeout_s: float = 120.0,
           rendezvous: str | None = None, device=None,
           pg_timeout_s: float | None = None) -> list:
    """Run ``fn(*args)`` in ``nprocs`` fresh (``spawn``) processes with the
    JAX env contract set for ranks ``0..nprocs-1`` and their default
    process group up; return what each rank returned, by rank.

    ``fn`` must be importable by module name (a top-level function of a
    module that imports no test harness). ``rendezvous`` is the
    coordinator address (``host:port`` or ``file://<path>``; default a
    free localhost port). ``device`` is each rank's device (``None`` =
    card 0, all ranks on it). A rank that raises or exits, or a world that
    outlives ``timeout_s``, kills every rank and raises ``RuntimeError``
    with the failed rank's traceback. Build the CUDA kernels before
    calling (``ops/_build.build``): a rank that finds a library missing
    compiles it itself (a rename keeps every library whole, but each
    such rank pays the build)."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # the arguments go through a queue, not the process object: spawn
    # writes that through a pipe, and one larger than the pipe's buffer
    # would make each start wait for its child to boot
    inputs = ctx.Queue()
    addr = rendezvous or f"127.0.0.1:{free_port()}"
    pg_timeout = pg_timeout_s if pg_timeout_s is not None else timeout_s
    procs = []
    for rank in range(nprocs):
        renv = {ENV_COORDINATOR_ADDRESS: addr,
                ENV_NUM_PROCESSES: str(nprocs),
                ENV_PROCESS_ID: str(rank),
                ENV_LOCAL_WORLD_SIZE: str(nprocs)}  # every rank on this host
        p = ctx.Process(
            target=_rank_main,
            args=(fn, inputs, rank, renv, device, pg_timeout, results,
                  timeout_s),
            name=f"kft-rank-{rank}", daemon=True,
        )
        p.start()
        procs.append(p)
    for _ in procs:
        inputs.put(args)
    got: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nprocs and failure is None:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except _queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)
                        and int(p.name.rsplit("-", 1)[1]) not in got]
                if dead:
                    failure = (f"rank {dead[0].name.rsplit('-', 1)[1]} exited "
                               f"with code {dead[0].exitcode}")
                elif time.monotonic() > deadline:
                    failure = (f"world of {nprocs} ranks timed out after "
                               f"{timeout_s:.0f} s; ranks done: {sorted(got)}")
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
        if failure is None:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        inputs.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(nprocs)]
