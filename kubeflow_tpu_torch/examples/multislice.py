"""Multislice worker on the port: the twin of ``kubeflow_tpu/examples/multislice.py``.

Each worker process stands in for one slice: the mesh gets a leading
``dcn_data`` axis equal to the process count, so data parallelism runs
across slices while tensor and FSDP parallelism would stay within one.
The script asserts the placement (every ``dcn_data`` block of the mesh
holds exactly one slice's ranks), runs a cross-slice sum through
``core/collectives.py``, then trains the same small LM as the JAX worker
(vocab 256, d_model 64, 2 layers, 4 heads, the ``onehot`` embedding,
f32, ``attn_impl="reference"`` as in JAX: plain attention, no kernel)
under ``transformer_rules()``. It prints the JAX worker's three ``ok``
lines; a failed check raises.

The port runs one rank a process, so a slice is one rank: ``model`` and
``fsdp`` are 1 and the mesh is ``MeshSpec(dcn_data=processes)``. Tensor
parallelism within a slice is covered by the trainer's own tests
(``MeshSpec(dcn_data=2, fsdp=2, model=2)`` in
``tests/test_torch_parallel_train.py``).

Run under the orchestrator as a JAXJob of N workers, or standalone as one
rank (``dcn_data=1``). The device is the CUDA card unless ``--device
cpu`` asks for the CPU; ranks that share a card set ``LOCAL_WORLD_SIZE``
(``examples/mnist.py`` says why).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--log-every", type=int, default=2)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)

    from kubeflow_tpu_torch.core.distributed import (
        initialize_from_env, rank_device, shutdown)

    cfg = initialize_from_env(device=args.device)
    try:
        return _run(args, cfg, rank_device(cfg, args.device))
    finally:
        shutdown()


def _run(args, dcfg, device) -> int:
    import torch

    from kubeflow_tpu_torch.core import collectives as coll
    from kubeflow_tpu_torch.core.mesh import Axis, MeshSpec, build_mesh
    from kubeflow_tpu_torch.data.synthetic import TokenLMDataset, local_shard_iterator
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        make_init_fn,
        make_loss_fn,
    )
    from kubeflow_tpu_torch.parallel.sharding import transformer_rules
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adamw

    n_slices, rank = dcfg.num_processes, dcfg.process_id
    print(f"devices: 1 local / {n_slices} global, process {rank}", flush=True)

    # one rank a process: a slice is one rank, so nothing splits within it
    spec = MeshSpec(dcn_data=n_slices)
    mesh = build_mesh(spec, device=device)

    # -- placement: each dcn_data block is exactly one slice's ranks ----- #
    for i in range(n_slices):
        held = sorted(int(r) for r in mesh.grid[i].flat)
        if held != [i]:
            raise RuntimeError(
                f"dcn block {i} holds ranks {held}, not slice {i}'s; "
                "cross-slice traffic would ride axes meant for the slice's "
                "own links")
    print(f"dcn placement ok: {n_slices} slices x 1 devices", flush=True)

    # -- cross-slice collective ------------------------------------------ #
    local = torch.tensor(float(rank + 1), device=device)
    total = float(coll.psum(local, Axis.DATA, mesh=mesh))
    want = sum(i + 1 for i in range(n_slices))
    if total != want:
        raise RuntimeError(f"cross-slice sum {total}, want {want}")
    print(f"cross-slice psum ok: {total}", flush=True)

    # -- data parallel across slices ------------------------------------- #
    cfg = TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        attn_impl="reference", dtype=torch.float32, embed_impl="onehot",
    )
    global_batch = 2 * spec.batch_partitions
    trainer = Trainer(
        init_params=make_init_fn(cfg),
        loss_fn=make_loss_fn(),
        optimizer=adamw(1e-3),
        config=TrainConfig(mesh=spec, global_batch=global_batch,
                           steps=args.steps, log_every=args.log_every),
        param_spec_fn=transformer_rules(),
        device=device,
    )
    ds = TokenLMDataset(vocab_size=256, seq_len=args.seq_len)
    state, _history = trainer.fit(
        lambda s: local_shard_iterator(ds, global_batch, start_step=s,
                                       mesh=trainer.mesh))
    if state.step != args.steps:
        raise RuntimeError(f"trained {state.step} steps of {args.steps}")
    if rank == 0:
        print(f"multislice training ok: steps={state.step}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
