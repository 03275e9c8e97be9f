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


def moe_serving(spec, x, router, up, down, cfg):
    """``moe_ffn(local_tokens=True)`` as tensor-parallel serving calls it:
    every rank holds the whole batch ``x`` (B, S, d), replicated over the
    batch axes too, and its shard of the expert weights; returns this
    rank's output, aux loss and stats."""
    from kubeflow_tpu_torch.parallel.expert import MoEConfig, moe_ffn
    from kubeflow_tpu_torch.parallel.sharding import P, shard_tensor

    m = _mesh(spec)
    x = _t(x)
    B, S, d = x.shape
    upl = shard_tensor(_t(up), P(Axis.EXPERT, None, Axis.MODEL), m)
    downl = shard_tensor(_t(down), P(Axis.EXPERT, Axis.MODEL, None), m)
    with torch.no_grad(), mesh_context(m):
        out, aux, stats = moe_ffn(x.reshape(B * S, d), _t(router), upl, downl,
                                  MoEConfig(**cfg), rows=B, local_tokens=True)
    return {"out": _np(out).reshape(B, S, d), "aux": float(aux),
            "stats": {k: float(v) for k, v in stats.items()}}


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
    history's losses and MoE metrics, the final full parameters (rank 0)
    and, with ``ckpt_dir``, saves the final state there."""
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
            "moe_aux": [h.get("moe_aux") for h in hist],
            "params": None if full is None else
            {k: _np(v) for k, v in full["model"].items()},
            "staged": coll.STAGED_BYTES}


def refuse(bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a barrier for it."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} refuses")
    dist.barrier()


# --------------------------------------------------------------------------- #
# tensor-parallel serving
# --------------------------------------------------------------------------- #

def _tp_model(cfg_kw, sd, dtype="float32"):
    """The port's LM with the bridged full weights ``sd`` (each rank cuts
    its own shard when an engine takes it)."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.parallel.expert import MoEConfig

    cfg_kw = dict(cfg_kw)
    if "moe" in cfg_kw:
        cfg_kw["moe"] = MoEConfig(**cfg_kw["moe"])
    cfg = TransformerConfig(**cfg_kw, dtype=getattr(torch, dtype))
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    return model


def _tp_drive(eng, prompts, max_new, concurrent=False, **sample):
    """Leader: start the engine, serve ``prompts`` (one after another, or
    all at once) and stop it; follower: follow until that stop. Returns
    the leader's token streams (None on a follower)."""
    import threading

    if not eng.is_leader:
        eng.start()
        return None
    eng.start()
    try:
        if not concurrent:
            return [eng.submit(p, max_new_tokens=max_new, timeout_s=60, **sample)
                    for p in prompts]
        out = [None] * len(prompts)

        def one(i):
            out[i] = eng.submit(prompts[i], max_new_tokens=max_new,
                                timeout_s=60, **sample)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(90)
        return out
    finally:
        eng.stop()


def tp_serve(spec, cfg, sd, prompts, max_new, runs):
    """Each run ``(name, engine kwargs)`` on one tensor-parallel engine over
    ``spec`` (every rank), then on rank 0 the one-rank engine with the
    same kwargs and weights. Run kwargs ``dtype``, ``concurrent`` and
    ``sample`` (submit's ``temperature``/``seed``) go to the model and
    to :func:`_tp_drive`, not to the engine; ``one_rank`` overrides
    engine kwargs of the one-rank engine alone."""
    from kubeflow_tpu_torch.serve.engine import LMEngine

    m = _mesh(spec)
    out = {}
    for name, kw in runs:
        kw = dict(kw)
        dtype = kw.pop("dtype", "float32")
        drive = dict(concurrent=kw.pop("concurrent", False), **kw.pop("sample", {}))
        one_kw = dict(kw, **kw.pop("one_rank", {}))
        eng = LMEngine(_tp_model(cfg, sd, dtype), mesh=m, **kw)
        got = {"tokens": _tp_drive(eng, prompts, max_new, **drive),
               "records": eng.tp_records, "stats": dict(eng.stats),
               "overlap": dict(eng.overlap),
               "kv_heads": next(iter(eng.cache.values()))["k"].shape[0]}
        if m.rank == 0:
            one = LMEngine(_tp_model(cfg, sd, dtype), **one_kw)
            got["one_rank"] = _tp_drive(one, prompts, max_new, **drive)
            got["one_rank_overlap"] = dict(one.overlap)
        out[name] = got
    return out


def tp_moe_forward(spec, cfg, sd, tokens, steps):
    """The MoE model's dense cached forward as tensor-parallel serving runs
    it (the weights cut by ``transformer_rules(fsdp=False)``, the rank's
    heads of the cache, the whole batch on every rank): a prefill of
    ``tokens`` (B, S) at slot 0, then ``steps`` (B, n) a token a step.
    Returns this rank's logits of every call and each MoE call's drops;
    rank 0 adds the one-rank model's."""
    from kubeflow_tpu_torch.models.transformer import init_kv_cache
    from kubeflow_tpu_torch.parallel.sharding import shard_module, transformer_rules

    def run(model, mesh, kv_heads):
        tok, nxt = _t(tokens).long(), _t(steps).long()
        B, S = tok.shape
        cache = init_kv_cache(model.cfg, B, S + nxt.shape[1], device="cpu",
                              kv_heads=kv_heads)
        moe: list = []
        with torch.no_grad(), mesh_context(mesh):
            logits = [model(tok, cache=cache, cache_index=0, moe_stats=moe)[0]]
            for i in range(nxt.shape[1]):
                logits.append(model(nxt[:, i:i + 1], cache=cache,
                                    cache_index=S + i, moe_stats=moe)[0])
        return {"logits": [_np(x) for x in logits],
                "dropped": [float(st["moe_dropped_frac"]) for _, st in moe]}

    m = _mesh(spec)
    model = _tp_model(cfg, sd)
    shard_module(model, transformer_rules(fsdp=False)(model), m)
    out = run(model, m, model.cfg.kv_heads // m.size(Axis.MODEL))
    if m.rank == 0:
        one = _tp_model(cfg, sd)
        out["one_rank"] = run(one, None, one.cfg.kv_heads)
    return out


def tp_draws(spec, cfg, sd, kw, prompts, max_new, temperature):
    """Unseeded sampling at ``temperature`` on a tensor-parallel engine:
    every rank records the tokens each prefill piece and decode chunk of
    its own emitted (and wrote KV for), in program order. Returns them
    with the rank's records and, on the leader, the streams and stats;
    every rank's list must be the leader's."""
    from kubeflow_tpu_torch.serve.engine import LMEngine

    eng = LMEngine(_tp_model(cfg, sd), mesh=_mesh(spec), **kw)
    emitted: list = []
    prefill, chunk = eng._run_prefill, eng._run_chunk

    def run_prefill(**kw):
        tok, qerr = prefill(**kw)
        emitted.append(("prefill", int(tok)))
        return tok, qerr

    def run_chunk(**kw):
        res = chunk(**kw)
        emitted.append(("chunk", _np(res["toks"]).tolist(),
                        _np(res["valid"]).tolist()))
        return res

    eng._run_prefill, eng._run_chunk = run_prefill, run_chunk
    streams = _tp_drive(eng, prompts, max_new, concurrent=True,
                        temperature=temperature)
    return {"emitted": emitted, "records": eng.tp_records, "streams": streams,
            "stats": dict(eng.stats) if eng.is_leader else None}


def tp_refusals(spec, cfg, sd, kw):
    """What a tensor-parallel engine refuses: on the leader the KV-span
    and prefix-entry movement (queue 1 item 14), on a follower a submit;
    returns ``{what: (exception type, message)}``."""
    from kubeflow_tpu_torch.serve.engine import LMEngine

    eng = LMEngine(_tp_model(cfg, sd), mesh=_mesh(spec), **kw)
    out = {}

    def attempt(what, fn):
        try:
            fn()
            out[what] = None
        except Exception as e:  # noqa: BLE001 — the test reads it
            out[what] = (type(e).__name__, str(e))

    if not eng.is_leader:
        attempt("submit", lambda: eng.submit([3, 4, 5], max_new_tokens=2))
        eng.start()
        return out
    eng.start()
    try:
        attempt("prefill_span", lambda: eng.prefill_span([3, 4, 5]))
        attempt("prepare_kv_span", lambda: eng.prepare_kv_span(
            [3, 4, 5], {}, {"real_len": 3, "first_tok": 7, "valid": True}))
        attempt("export_prefix_entries", lambda: eng.export_prefix_entries())
        attempt("import_prefix_entries", lambda: eng.import_prefix_entries([]))
        # the engine still serves after the refusals
        out["served"] = eng.submit([3, 4, 5], max_new_tokens=3, timeout_s=60)
    finally:
        eng.stop()
    return out


def tp_http(spec, cfg, sd, model_kw, prompts, max_new):
    """``LMEngineModel(mesh=)`` on every rank: rank 0 serves it behind
    ``ModelServer`` and answers ``/v2/models/lm/generate`` for each prompt
    over HTTP; the followers' ``load()`` returns when the server stops."""
    import json
    import urllib.request

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    m = _mesh(spec)
    lm = LMEngineModel("lm", config=TransformerConfig(**cfg), device="cpu",
                       state_dict={k: _t(v) for k, v in sd.items()},
                       max_new_tokens=max_new, mesh=m, watchdog=False,
                       **model_kw)
    if m.rank != 0:
        return {"loaded": lm.load(), "ready": lm.ready}
    server = ModelServer([lm], http_port=0).start()
    try:
        out = []
        for ids in prompts:
            body = json.dumps({"input_ids": ids}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v2/models/lm/generate",
                data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out.append(json.loads(resp.read())["token_ids"])
        return {"tokens": out, "ready": lm.ready}
    finally:
        server.stop()


def tp_drop_race(spec, cfg, sd, kw, prompts, max_new):
    """``drop_prefix_cache`` from another thread between a prefix hit and
    its implant: on the leader, a lookup that hits waits for a thread that
    drops the whole cache. Serves ``prompts`` one after another on the
    tensor-parallel engine, then on rank 0 on the one-rank engine with
    the same drop; returns the streams, the entries each drop reported,
    and every rank's stored prefix keys at the end (they must agree)."""
    import threading

    from kubeflow_tpu_torch.serve.engine import LMEngine

    def drop_at_first_hit(eng, dropped):
        lookup = eng._lookup_prefix

        def racing(ids):
            hit = lookup(ids)
            if hit is not None and not dropped:
                th = threading.Thread(
                    target=lambda: dropped.append(eng.drop_prefix_cache()))
                th.start()
                th.join(30)
            return hit

        eng._lookup_prefix = racing

    m = _mesh(spec)
    eng = LMEngine(_tp_model(cfg, sd), mesh=m, **kw)
    dropped: list = []
    if eng.is_leader:
        drop_at_first_hit(eng, dropped)
    out = {"tokens": _tp_drive(eng, prompts, max_new), "dropped": dropped,
           "keys": sorted(eng._prefix_cache), "hits": eng.stats["prefix_hits"]}
    if m.rank == 0:
        one = LMEngine(_tp_model(cfg, sd), **kw)
        one_dropped: list = []
        drop_at_first_hit(one, one_dropped)
        out["one_rank"] = _tp_drive(one, prompts, max_new)
        out["one_rank_dropped"] = one_dropped
    return out


def tp_follower_dies(spec, cfg, sd, kw, prompts, max_new, victim, after):
    """Rank ``victim`` (a follower) dies at its ``after``-th decode chunk:
    its group goes down, as a killed process's would. The leader's
    requests must fail through the engine's fatal path within the group's
    timeout; returns the leader's errors and seconds. Every rank ends its
    process group here, so this case comes last in its world."""
    import threading
    import time

    from kubeflow_tpu_torch.core.distributed import shutdown
    from kubeflow_tpu_torch.serve.engine import LMEngine

    m = _mesh(spec)
    eng = LMEngine(_tp_model(cfg, sd), mesh=m, **kw)
    try:
        if m.rank == victim:
            seen = {"chunks": 0}

            def die(engine, op):
                seen["chunks"] += op == "chunk"
                if seen["chunks"] >= after:
                    raise RuntimeError(f"rank {victim} dies")

            eng._fault_hooks["follower_op"] = die
            try:
                eng.start()
            except RuntimeError as e:
                return {"died": str(e)}
            return {"died": None}
        if not eng.is_leader:
            try:
                eng.start()
            except Exception as e:  # noqa: BLE001 — the leader went away
                return {"follower_error": type(e).__name__}
            return {"follower_error": None}
        eng.start()
        errors: dict = {}
        t0 = time.monotonic()

        def one(i):
            try:
                eng.submit(prompts[i], max_new_tokens=max_new, timeout_s=60)
            except Exception as e:  # noqa: BLE001 — the test reads it
                errors[i] = (type(e).__name__, str(e), time.monotonic() - t0)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(90)
        hung = sum(th.is_alive() for th in threads)
        fatal = repr(eng._fatal)
        eng.stop()
        return {"errors": errors, "hung": hung, "fatal": fatal,
                "seconds": time.monotonic() - t0}
    finally:
        shutdown()


def tp_cuts(spec, cfg, sd):
    """Cut the full weights by ``transformer_rules(fsdp=False)`` over the
    mesh (this rank's shards) and join the cuts again: the full state
    dict must come back on every rank."""
    from kubeflow_tpu_torch.parallel.sharding import (
        shard_module, transformer_rules, unshard_tensor)

    m = _mesh(spec)
    model = _tp_model(cfg, sd)
    specs = shard_module(model, transformer_rules(fsdp=False)(model), m)
    split = sum(1 for s in specs.values() if any(e is not None for e in s))
    unequal = []
    for name, p in model.named_parameters():
        full = unshard_tensor(p.data, specs[name], m)
        if not torch.equal(full, _t(sd[name])):
            unequal.append(name)
    return {"equal": not unequal, "unequal": unequal, "split": split}
