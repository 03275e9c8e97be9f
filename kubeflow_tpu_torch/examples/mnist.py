"""JAXJob MNIST worker on the port: the twin of ``kubeflow_tpu/examples/mnist.py``.

Each worker process is one rank. It brings ``torch.distributed`` up from
the env contract the orchestrator writes (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; ``core/distributed.py``)
before it touches a device, builds a data-parallel mesh over the ranks
and trains the MNIST CNN with ``adam``; the gradient sum is one
all-reduce a step. Rank 0 alone prints the metrics and the
``final_loss=... final_accuracy=... steps_per_sec=...`` line.

Run under the orchestrator:

    JobSpec(replicas={"worker": ReplicaSpec(replicas=N, command=(python,
        "-m", "kubeflow_tpu_torch.examples.mnist", "--device", "cpu", ...))})

or standalone as one rank. The device is the CUDA card unless ``--device
cpu`` asks for the CPU; nothing reads ``JAX_PLATFORMS``.

One difference from the JAX worker: the port runs one rank a process, so
a process drives one device. Under the orchestrator's ``cpu_sim`` wiring
with ``devices_per_worker=4`` the JAX job of two workers has "4 local / 8
global" devices, and the port's has two ranks, "1 local / 2 global".

Several ranks on one card must say so with ``LOCAL_WORLD_SIZE`` (the
ranks on this host, as torchrun sets it): the backend is then gloo, its
collectives staged through pinned host memory. Unset, each rank counts
as alone on its host and takes NCCL, which refuses two ranks on one
device.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument(
        "--checkpoint-sync", action="store_true",
        help="synchronous saves: every saved step is durable (with its "
             "sha256 manifest) before the next step runs",
    )
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--metrics-logdir", type=str, default=None)
    p.add_argument(
        "--grad-accum-steps", type=int, default=1,
        help="microbatch accumulation (one optimizer update)",
    )
    p.add_argument(
        "--prefetch-depth", type=int, default=2,
        help="device-prefetch depth; 0 runs the input pipeline inline",
    )
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)

    # rendezvous before any device work
    from kubeflow_tpu_torch.core.distributed import (
        initialize_from_env, rank_device, shutdown)

    cfg = initialize_from_env(device=args.device)
    try:
        return _train(args, cfg, rank_device(cfg, args.device))
    finally:
        shutdown()


def _train(args, cfg, device) -> int:
    import torch.distributed as dist

    from kubeflow_tpu_torch.core.mesh import MeshSpec
    from kubeflow_tpu_torch.data.synthetic import (
        ClassPrototypeDataset,
        local_shard_iterator,
    )
    from kubeflow_tpu_torch.models.mnist_cnn import make_init_fn, make_loss_fn
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adam

    backend = dist.get_backend() if dist.is_initialized() else "none"
    print(
        f"process {cfg.process_id}/{cfg.num_processes}: "
        f"1 local / {cfg.num_processes} global {device.type} devices "
        f"(backend {backend})",
        flush=True,
    )

    trainer = Trainer(
        init_params=make_init_fn(),
        loss_fn=make_loss_fn(),
        optimizer=adam(args.lr),
        config=TrainConfig(
            mesh=MeshSpec.data_parallel(cfg.num_processes),
            global_batch=args.global_batch,
            steps=args.steps,
            log_every=args.log_every,
            seed=args.seed,
            checkpoint=(
                CheckpointConfig(
                    directory=args.checkpoint_dir,
                    save_every_steps=args.checkpoint_every,
                    async_save=not args.checkpoint_sync,
                )
                if args.checkpoint_dir
                else None
            ),
            resume=not args.no_resume,
            metrics_logdir=args.metrics_logdir,
            grad_accum_steps=args.grad_accum_steps,
            prefetch_depth=args.prefetch_depth,
        ),
        device=device,
    )
    # factory form: on checkpoint resume the stream continues at the
    # restored step instead of replaying batch 0
    data = lambda start_step: local_shard_iterator(  # noqa: E731
        ClassPrototypeDataset(seed=args.seed),
        args.global_batch,
        start_step=start_step,
        mesh=trainer.mesh,
    )
    _state, history = trainer.fit(data)

    if cfg.process_id == 0 and history:
        first, last = history[0], history[-1]
        print(
            f"final_loss={last['loss']:.6g} final_accuracy={last['accuracy']:.6g} "
            f"steps_per_sec={last['steps_per_sec']:.6g}",
            flush=True,
        )
        if not (last["loss"] < first["loss"] or last["accuracy"] > 0.9):
            print("WARNING: loss did not improve", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
