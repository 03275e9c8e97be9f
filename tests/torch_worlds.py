"""Rank bodies for the port's multi-process CPU tests (gloo worlds).

Spawned ranks unpickle their target by module name, so the bodies live
here, in a module that imports no JAX and no test harness: a child that
imported a test module would import JAX and the conftest's XLA flags.
``kubeflow_tpu_torch.core.distributed.launch`` runs :func:`run` in every
rank with the default process group up; each case builds its mesh over
the world, computes on this rank's block and returns numpy arrays, which
the test gathers and holds against the JAX package in its own process.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, MeshSpec, build_mesh, mesh_context

#: every world's join timeout (seconds): a hang fails the file's tests
WORLD_TIMEOUT_S = 110.0


def world(nprocs: int, cases: list[tuple[str, dict]], tmp_path) -> dict:
    """Run ``cases`` in one world of ``nprocs`` CPU ranks; returns
    ``{case name: [rank 0's result, rank 1's, ...]}`` (an ``Exception``
    string as a rank's result when that case raised)."""
    from kubeflow_tpu_torch.core.distributed import launch

    store = f"file://{os.path.join(str(tmp_path), 'rendezvous')}"
    per_rank = launch(run, nprocs, args=(cases,), timeout_s=WORLD_TIMEOUT_S,
                      rendezvous=store, device="cpu", pg_timeout_s=60.0)
    return {name: [r[name] for r in per_rank] for name, _ in cases}


def run(cases: list[tuple[str, dict]]) -> dict:
    out = {}
    for name, kw in cases:
        fn = globals()[kw.pop("fn", name)]
        try:
            out[name] = fn(**kw)
        except Exception as e:  # noqa: BLE001 — the test decides
            out[name] = RaisedInRank(type(e).__name__, str(e),
                                     traceback.format_exc())
    return out


class RaisedInRank:
    """What a case raised in a rank (the tests assert on it)."""

    def __init__(self, kind: str, message: str, tb: str):
        self.kind, self.message, self.tb = kind, message, tb

    def __repr__(self) -> str:
        return f"RaisedInRank({self.kind}: {self.message})\n{self.tb}"


def _mesh(spec: dict):
    return build_mesh(MeshSpec(**spec), device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------- #
# mesh
# --------------------------------------------------------------------------- #

def mesh_coords(spec):
    """This rank's coordinates, batch index and, per axis, the sum of the
    ranks in its group (an all-reduce over each axis's group)."""
    m = _mesh(spec)
    sums = {}
    for a in Axis.GRID:
        sums[a] = int(coll._all_reduce(torch.tensor([m.rank]), m, a)[0])
    return {"coords": m.coords, "batch_index": m.batch_index,
            "peer_sums": sums, "jax_shape": m.shape}


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #

def collective(spec, kind, x, axis, **kw):
    """One raw collective's result on this rank's shard of ``x`` (rows
    split over ``axis``)."""
    m = _mesh(spec)
    shard = _t(x).chunk(m.size(axis), 0)[m.index(axis)].contiguous()
    with mesh_context(m):
        if kind == "grad_allreduce":
            return _np(coll.grad_allreduce({"g": shard}, axis)["g"])
        if kind == "ring_shift":
            return _np(coll.ring_shift(shard, axis))
        if kind == "gather_scatter":
            full = coll.all_gather(shard, axis)
            return _np(coll.reduce_scatter(full, axis))
        if kind == "all_to_all_swap":
            ys = coll.all_to_all(shard, axis, split_axis=1, concat_axis=0)
            return _np(coll.all_to_all(ys, axis, split_axis=0, concat_axis=1))
    raise ValueError(kind)


def collective_grad(spec, kind, x, w, axis):
    """``d/dx`` of this rank's objective through one differentiable
    collective, this rank holding rows ``x`` of its shard and weights
    ``w`` (this rank's row of ``w`` for per-rank objectives)."""
    m = _mesh(spec)
    n, i = m.size(axis), m.index(axis)
    xs = _t(x).chunk(n, 0)[i].contiguous().requires_grad_(True)
    ws = _t(w)
    with mesh_context(m):
        if kind == "psum":        # replicated objective of the sum
            y = (coll.psum(xs, axis) * ws).sum()
        elif kind == "enter":     # per-rank objectives of replicated x
            y = (coll.enter(xs, axis) * ws[i]).sum()
        elif kind == "all_gather":
            y = (coll.all_gather(xs, axis) * ws[i]).sum()
        elif kind == "reduce_scatter":
            y = (coll.reduce_scatter(xs, axis, scatter_axis=1)
                 * ws[i].chunk(n, 1)[i]).sum()
        elif kind == "ring_shift":
            y = (coll.ring_shift(xs, axis) * ws[i]).sum()
        elif kind == "all_to_all":
            y = (coll.all_to_all(xs, axis, split_axis=1, concat_axis=0)
                 * ws[i]).sum()
        else:
            raise ValueError(kind)
    y.backward()
    return _np(xs.grad)


def bench(spec, axis, suite):
    m = _mesh(spec)
    if suite:
        return coll.benchmark_suite(m, axis, mb_per_shard=0.05, iters=1, warmup=1)
    return coll.benchmark_collective(m, axis, "psum", mb_per_shard=0.1,
                                     iters=2, warmup=1)


def staged_counts(spec):
    """Collective counters after one all-reduce (CPU tensors: no staging)."""
    m = _mesh(spec)
    coll.reset_counters()
    coll._all_reduce(torch.ones(4), m, Axis.DATA)
    return {"staged": coll.STAGED_BYTES, "calls": dict(coll.COLLECTIVE_CALLS)}


# --------------------------------------------------------------------------- #
# ring and Ulysses attention
# --------------------------------------------------------------------------- #

def attention(spec, impl, q, k, v, causal, seg=None, dout=None, heads=None):
    """This rank's block of the output (and, with ``dout``, its block of
    dq, dk, dv) of ring or Ulysses attention on global ``q, k, v``."""
    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_attention_local, shard_global)
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention_local

    m = _mesh(spec)
    q, k, v = (_t(a) for a in (q, k, v))
    if heads is not None:
        q, k, v = q[:, :heads], k[:, :heads], v[:, :heads]
    blk = [shard_global(t, m, Axis.SEQ).contiguous().requires_grad_(True)
           for t in (q, k, v)]
    sg = None if seg is None else shard_global(_t(seg), m, Axis.SEQ, seq_dim=1)
    fn = ring_attention_local if impl == "ring" else ulysses_attention_local
    with mesh_context(m):
        out = fn(*blk, causal=causal, segment_ids=sg)
    res = {"out": _np(out), "where": (m.index(Axis.BATCH), m.index(Axis.MODEL),
                                      m.index(Axis.SEQ))}
    if dout is not None:
        (out * shard_global(_t(dout), m, Axis.SEQ)).sum().backward()
        res.update(dq=_np(blk[0].grad), dk=_np(blk[1].grad), dv=_np(blk[2].grad))
    return res


def attention_global(spec, impl, q, k, v, causal):
    """The global wrappers' output and the gradient of ``sum(out**2)``
    with respect to the global q (every rank holds the global one)."""
    from kubeflow_tpu_torch.parallel.ring_attention import ring_attention
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    m = _mesh(spec)
    q = _t(q).requires_grad_(True)
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(q, _t(k), _t(v), m, causal=causal)
    (out ** 2).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad)}


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #

def moe(spec, x, router, up, down, cfg, rows):
    """This rank's output block, aux loss and stats of ``moe_ffn`` on the
    global ``x`` (B, S, d), its rows over the batch axes and its chunk
    over ``seq``, and the expert weights sharded over ``expert``."""
    from kubeflow_tpu_torch.parallel.expert import MoEConfig, moe_ffn
    from kubeflow_tpu_torch.parallel.sharding import P, shard_tensor

    m = _mesh(spec)
    x = _t(x)
    B, S, d = x.shape
    xb = x.chunk(m.size(Axis.BATCH), 0)[m.index(Axis.BATCH)]
    xb = xb.chunk(m.size(Axis.SEQ), 1)[m.index(Axis.SEQ)].contiguous()
    Bl, Sl = xb.shape[:2]
    upl = shard_tensor(_t(up), P(Axis.EXPERT, None, Axis.MODEL), m)
    downl = shard_tensor(_t(down), P(Axis.EXPERT, Axis.MODEL, None), m)
    xr = xb.reshape(Bl * Sl, d).requires_grad_(True)
    with mesh_context(m):
        out, aux, stats = moe_ffn(xr, _t(router), upl, downl,
                                  MoEConfig(**cfg), rows=Bl)
    (out.sum() + aux).backward()
    return {"out": _np(out).reshape(Bl, Sl, d), "aux": float(aux),
            "stats": {k: float(v) for k, v in stats.items()},
            "dx": _np(xr.grad).reshape(Bl, Sl, d),
            "where": (m.index(Axis.BATCH), m.index(Axis.SEQ))}


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #

def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline(spec, params, x, n_micro, what, schedule=None):
    from kubeflow_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_value_and_grad)

    m = _mesh(spec)
    p = {k: _t(v) for k, v in params.items()}
    x = _t(x)
    if what == "apply":
        return _np(pipeline_apply(_stage_fn, p, x, m, n_microbatches=n_micro))
    if what == "grad":
        p = {k: v.requires_grad_(True) for k, v in p.items()}
        y = pipeline_apply(_stage_fn, p, x, m, n_microbatches=n_micro)
        (y ** 2).sum().backward()
        return {k: _np(v.grad) for k, v in p.items()}
    stats = {}
    loss, grads = pipeline_value_and_grad(
        _stage_fn, lambda y: (y ** 2).mean(), p, x, m,
        n_microbatches=n_micro, schedule=schedule, stats=stats)
    return {"loss": float(loss), "grads": {k: _np(v) for k, v in grads.items()},
            "live_buffers": stats["live_buffers"]}


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #

def train(spec, model_cfg, params, data, steps, lr, global_batch,
          attn_impl, ckpt_dir=None, accum=1):
    """``Trainer.fit`` of the port's LM under ``spec`` and
    ``transformer_rules()`` from the bridged JAX ``params``; returns the
    history's losses, the final full parameters (rank 0) and, with
    ``ckpt_dir``, saves the final state there."""
    from kubeflow_tpu_torch.data.synthetic import (
        TokenLMDataset, local_shard_iterator)
    from kubeflow_tpu_torch.models import transformer as ttf
    from kubeflow_tpu_torch.models.bridge import params_to_state_dict
    from kubeflow_tpu_torch.parallel.expert import MoEConfig
    from kubeflow_tpu_torch.parallel.sharding import transformer_rules
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.train.loop import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.optim import adamw

    kw = dict(model_cfg)
    kw["moe"] = MoEConfig(**kw.pop("moe"))
    cfg = ttf.TransformerConfig(**kw, attn_impl=attn_impl)
    sd = params_to_state_dict(params)

    def init(seed, device):
        model = ttf.TransformerLM(cfg, device=device, param_dtype=torch.float32)
        model.load_state_dict(sd)
        return model

    trainer = Trainer(
        init_params=init, loss_fn=ttf.make_loss_fn(), optimizer=adamw(lr),
        config=TrainConfig(
            mesh=MeshSpec(**spec), global_batch=global_batch, steps=steps,
            log_every=1, prefetch_depth=0, grad_accum_steps=accum,
            checkpoint=None if ckpt_dir is None else CheckpointConfig(
                ckpt_dir, save_every_steps=steps, async_save=False)),
        param_spec_fn=transformer_rules(), device="cpu")
    ds = TokenLMDataset(**data)
    state, hist = trainer.fit(lambda s: local_shard_iterator(
        ds, global_batch, start_step=s, mesh=trainer.mesh))
    full = trainer.full_state_dict(state)
    return {"losses": [h["loss"] for h in hist],
            "moe_dropped_frac": [h.get("moe_dropped_frac") for h in hist],
            "params": None if full is None else
            {k: _np(v) for k, v in full["model"].items()},
            "staged": coll.STAGED_BYTES}


def refuse(bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a barrier for it."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} refuses")
    dist.barrier()
