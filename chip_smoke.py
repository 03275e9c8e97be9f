#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``kubeflow_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``kubeflow_tpu_torch/ops/csrc/`` (nvcc,
sm_90a, into the git-ignored ``build/``) and runs twenty phases:

1. kernels — each kernel against its plain PyTorch twin on the card at
   the serving and training shapes, with device times (``time_ms``: the
   median of 20 calls, with the minimum, the spread and the samples
   dropped because the enqueue outran the timer's sleep) for kernel,
   plain version and (for flash, forward and backward)
   ``F.scaled_dot_product_attention`` as a yardstick only, and the body
   that ran (flash forward: ``"wgmma"``, TMA-fed warpgroup tensor-core
   products, for bf16/f16 with D a multiple of 16, else ``"fma"``,
   register-tiled f32 FMAs; its bf16/f16 cases launched twice and bitwise
   equal; dq and dk/dv: ``"wgmma"`` on the same rule, else ``"fma"``,
   register-tiled f32 FMAs too; every backward case launched twice and
   bitwise equal, rows that see no key with dq = 0 and keys that no query
   sees with dk = dv = 0 exactly;
   paged attention: ``"decode"``, one lane a key on f32 FMAs, for f32
   and for bf16/f16 spans of at most 4 rows a kv head, else ``"mma"``,
   tensor-core products, pages spread over a cluster of blocks; every
   paged case launched twice and bitwise equal, the speculative verify
   (S = K+1 = 5, a different ``pos0`` per row), a prefill piece at an
   offset, long GQA contexts, D=128 and f16 on both bodies; one row
   alone with a padded table bitwise equal to the same row in a batch,
   on both bodies; the build's paged instantiations with 0 spill bytes);
2. forward — the full-width bf16 ``TransformerLM`` no-cache forward with
   ``attn_impl="flash"`` against the same weights with ``"reference"``;
3. serving — ``ModelServer`` + ``LMEngineModel`` at full width in bf16 on
   the paged-attention kernel, answering 8 concurrent
   ``/v2/models/lm/generate`` requests with the pipelined loop
   (``pipeline_depth=1``, the default) and, from a second model in the
   same server, with the synchronous one (``pipeline_depth=0``), in
   turns 1, 0, 1, 0, 1, 0: each depth's median and spread; the paged
   launches of the counted burst by body, decode steps (S=1) on
   ``decode`` and prefill pieces (S=32) on ``mma``;
4. f32 parity — the same engine in f32: the ``kernel`` and ``gather``
   read paths must give token-identical greedy streams;
5. engine — the f32 engine on the kernel read path: (a) depth 1 gives
   depth 0's streams; (b) speculative decoding (K=4) gives K=0's greedy
   streams on repeating prompts, accepting drafts through verify
   launches at S=5 (the f32 decode body), and the same traffic on the
   bf16 model runs its verifies on the tensor-core body, K=4 against K=0
   judged by near ties; (c) chunked prefill with the prefix cache gives the
   streams of an engine with neither, and (c8) the same traffic on an
   int8 pool measures a ``kv_quant_error`` in (0, 0.05); (d) seeded
   sampling repeats, resumes from half a stream to its other half, and
   differs by seed;
6. contract — the replica's request contract over HTTP on the bf16
   model: warmup before ready, the burst over ``generate_stream``
   (token-identical to ``generate``, client TTFT), expired and foreign
   deadlines, an unmeetable-deadline shed, priority eviction, the
   watchdog restarting a model wedged mid-stream and the stream resumed
   with ``x-kft-resume-tokens``, and ``/metrics``;
7. disagg — KV movement between replicas on the bf16 model: a prefill
   and a decode ``ModelServer`` (``role``), the decode replica pulling
   every span over ``x-kft-prefill-peer`` and running no prefill piece,
   against a colocated replica, over ``generate`` and
   ``generate_stream`` (client TTFT); the same through the codec on an
   f32 pair (exact) and on int8 pools; a prefix-cache pull between two
   replicas; sessions parked in the host KV tier and swapped back in;
   a dropped ship and a dead peer falling back to a local prefill; one
   traced ship's ``kv.ship`` span split into the prefill replica's
   ``engine``/``queue.wait``/``prefill`` spans and the rest;
8. fleet — two bf16 replicas behind the port's ``InferenceGateway``
   (session affinity): the burst over ``generate_stream`` direct to a
   replica and through the gateway, in turns (the gateway's TTFT and
   tokens/s cost); a burst during which the replica's server is killed
   mid-stream (every stream resumed on the peer, no error frame, judged
   by near ties); the replica wedged mid-stream, restarted by its
   watchdog while the streams resume; one traced stream's span tree from
   the edge to the decode chunks; an f32 pair with one kill, identical;
9. dense — the dense KV cache at the same width, bf16: the ``causal-lm``
   runtime (``LMRuntimeModel``) behind ``ModelServer`` with the JAX
   ``bench_generate`` traffic (8 prompts of 128 tokens, 64 and 16 new
   tokens in turns: whole-generation ms, decode step ms, streams against
   the paged engine, text rows against their tokenizer ids), the dense
   ``LMEngine`` with ``bench_engine``'s traffic at depths 1 and 0 against
   the paged kernel engine (tokens/s, TTFT, decode gap), no paged kernel
   launched by a dense run; then in f32 the dense engine's K=4, chunked
   prefill with a prefix cache, seeded resume, a window and a paged
   prefill engine feeding it spans, each identical to the paged engine;
10. bert — the KServe BERT predictor on bert-base (random weights, seed
   0) through the flash forward, non-causal with padding segments:
   ``BertRuntimeModel`` behind ``ModelServer`` with the JAX
   ``bench_serving`` traffic (cold start, 3 + 40 sequential ``:predict``
   requests, p50/p99) in f32 and bf16; a burst of 32 concurrent clients
   through the dynamic batcher (requests/s, occupancy, each answer equal
   to the text served alone); f32 flash against plain attention and the
   padding invariance on the card; v2 ``/infer`` against v1; the flash
   launches (12 a forward, the ``fma`` body in f32 and ``wgmma`` in bf16)
   and no paged launch;
11. train — the full-width LM trained through the flash forward and
   backward kernels: 5 f32 steps against plain attention (gradients and
   losses), then ``Trainer.fit`` in bf16 over f32 weights, 3 + 20 steps,
   whose forward, dq and dk/dv launches must all run the tensor-core
   bodies;
12. mlm — the rest of the training path: (a) bert-base MLM in f32 (TF32
   off), flash against plain attention from the same weights, batches
   and threefry masks, 5 steps at B=8, S=128 (per-step losses, step-1
   gradients; 12 forward, dq and dk/dv launches a step on ``fma``,
   non-causal); (b) ``Trainer.fit`` of bert-base MLM in bf16 over f32
   weights at the bench's 32 × 128, 3 + 20 steps (finite, falling loss;
   12 launches of each kernel a step on ``wgmma``; step ms, tokens/s,
   MFU against 989 TFLOP/s by ``bench.py``'s FLOP count); (c) the train
   phase's LM in f32 with ``remat`` None and "dots" against no remat, 2
   steps (losses and gradients; the forward launched twice a layer a
   step, peak memory each); (d) ``check_numerics="checkify"`` and
   ``debug_nans`` on a poisoned MNIST batch (the located error, weights
   as the last update left them, hooks gone; clean runs equal the
   default; step ms a mode); (e) ``examples/mnist.py``'s fit (batch 64,
   ``adam(1e-3)``, 100 steps) and ResNet-50 CIFAR in bf16 at batch 64,
   ``adam(3e-5)``, 10 steps (step ms);
13. mesh — the parallel training path in one world of four ranks on
   this card, spawned once (``core/distributed.py`` ``launch``; gloo,
   collectives staged through pinned host memory): (a) ring and Ulysses
   attention over ``seq=4`` against one-rank flash at row 2's and row
   2d's shapes, forward and gradients, ring rank j launching each flash
   kernel 1 + j times; (b) ``Trainer.fit`` of the full-width LM in bf16,
   2 steps of 8 x 512 under ``MeshSpec(model=2, seq=2)``, ring attention,
   the ``onehot`` embedding and ``transformer_rules()`` (step ms,
   tokens/s, MFU, loss, launches a step by rank, bytes staged, peak
   memory); (c) the same LM with MoE every second block under
   ``MeshSpec(fsdp=2, expert=2)`` (``moe_dropped_frac``, aux loss);
   (d) f32 parity of both meshes at 2 layers against the one-rank
   trainer; (e) 1F1B against GPipe on ``MeshSpec(pipe=4)``. The flash
   launches of (a)-(c) are counted by shape too, and a launched shape
   that no kernels-phase case holds against the twin fails the phase;
14. load — the JAX ``bench_serving_load``'s three runs (``bench.py:
   625-660``: its mix, seeds, rates, durations and KPA shapes) through the
   port's ``run_serving_load``: an open-loop client, the gateway, the KPA
   autoscaler and a fleet of full-width bf16 replicas on the paged pool
   with the kernel, all in this process; steady (Poisson, 2 pinned
   replicas), chaos (an engine wedged for 3 s) and scale (on/off bursts
   from 1 replica, ``min_replicas=0``, then a timed cold request through
   the activator). A line a run: goodput, outcomes, TTFT p50/p99, TPOT
   p50, e2e p99, the chaos window, scale-up latency, cold recovery and
   fleet events, the client's lag against its schedule, the autoscaler's
   scrape ms a tick and the paged launches by body. It fails on an error
   in the steady run, a client-visible failure in the chaos run, a scale
   run that never reaches 2 replicas, never drains to 0 or does not
   complete its cold request, a completed request short of its budget,
   or a run without paged launches on both bodies;
15. tp — tensor-parallel serving in one world of two ranks on this card
   (gloo, collectives staged through pinned host memory): the full-width
   model in bf16 over ``MeshSpec(model=2)``, each rank holding half the
   heads of every layer and of the paged pool, on the paged kernel, the
   serving phase's burst held against the one-rank engine on the same
   weights by the near-tie rule, then at f32 and 2 layers, identical;
   then speculative decoding (K=4) on the engine phase's motif prompts
   and the MoE LM (every second FFN ``MoEConfig()``'s), each in bf16 and
   f32 against the one-rank engine of the same knobs likewise (drafts
   accepted and S=5 verifies on both ranks; the ranks' drop shares
   equal); tokens/s, TTFT p50, decode-step ms, bytes staged a step, the
   collective share, paged launches by rank, span and shape (each
   launched shape held by a kernels-phase case at the ranks' share of
   the heads) and peak memory by rank;
16. job — JAXJobs on the port's control plane (``LocalCluster`` with
   ``WiringConfig(platform="gpu")``), each worker a process on this card:
   ``examples/mnist.py`` as a two-worker job (conditions Created →
   Running → Succeeded, ``LOCAL_WORLD_SIZE=2`` and no card id in each
   worker's env, metrics on rank 0 only, a falling loss, a checkpoint, a
   second job resuming at the next step), ``examples/multislice.py`` (its
   three ``ok`` lines); Katib trials of the full-width LM as one-worker
   jobs under a ClusterQueue quota of two chips (at most two admitted,
   one queued, each scraped loss its worker's own, the optimum the
   argmin, each flash kernel once a layer a step over the trials); and a
   borrower preempted by a nominal-quota job (SIGTERM, a forced
   checkpoint, exit 143, requeued and resumed at the saved step, no
   restart counted);
17. tabular — the KServe tabular predictors, no kernel of the repo on
   their path: seeded checkpoints in the published formats (XGBoost JSON
   ``binary:logistic``, 1000 trees of depth 8 at HIGGS's 28 features, and
   ``multi:softprob``, 7 classes x 200 rounds at Covertype's 54; a
   LightGBM text model of the first one's shape; a PMML forest of 100
   depth-8 trees and a logistic ``RegressionModel``) served through
   ``ModelServer`` (v1 and v2) at 1, 64 and 4096 rows with about 1% NaN
   features, each answer within 1e-5 x (sum of |leaf value| on the row's
   paths) + 1e-6 of the plain walk, classes identical and the device
   walk's final cursors equal to the plain walk's leaves; the p50 of a
   predict by batch size, its launches under ``torch.profiler``, the busy
   share and the bytes resident; then a ModelMesh of 8 BERT-tiny
   predictors and the two boosters under a budget of 3 BERT-tiny models:
   every answer equal to the model's alone, residents as an LRU model of
   the requests says, ``resident_bytes`` the resident weights, each
   eviction freeing its bytes, a pinned model never evicted;
18. tune — Katib: ``ExperimentController`` runs a TPE search of the
   full-width LM's learning rate (4 ``Trainer.fit`` trials of 8 steps at
   8 x 512, bf16 over f32, 2 at a time in one process, a checkpoint at
   the last step, medianstop on): every trial terminal and finite, the
   optimum the argmin, each flash kernel launched once a layer a step;
   the winner registered in a ``ModelStore`` with its ``tune_trial``
   lineage, promoted, fetched by ``registry://lm-tuned@production``
   (the registered sha256) and served (the serving burst, paged) with
   tokens identical to serving the trial's checkpoint directly; then
   DARTS and ENAS at ``NASSpace`` defaults, f32 with TF32 off, on the
   card against the CPU from one seed (equal cells, ENAS samples equal
   step for step, losses and alphas within tolerance);
19. pipeline — Kubeflow Pipelines on the port: ``lm-pipeline``
   (``make-data`` → ``train-lm`` → ``eval-lm``, ``lr=1e-3``,
   ``steps=8``) compiled by the port's DSL and run by ``PipelineRunner``
   over a ``LocalCluster`` (``gpu`` wiring, one chip of the default
   label), with a step cache, a sqlite ``LineageStore`` and a
   ``ModelStore``: (a) the data step in process, the train and eval
   steps each a one-worker JAXJob on this card (conditions Created →
   Running → Succeeded; ``Trainer.fit`` of the full-width LM in bf16
   over f32 at 8 x 512, each flash kernel ``steps`` x 12 times on
   ``wgmma``; the held-out loss through the forward, 12 launches), the
   returned loss its worker's last, lineage of 3 executions, the Model
   registered as ``lm-pipeline`` v1 with its ``pipeline_run`` edge; (b)
   ``registry://lm-pipeline@v1`` fetched (the registered sha256) and
   served (the serving burst, paged) with tokens identical to serving
   the Model artifact's own directory; (c) the same run again: every
   step a cache hit, no job submitted, v2 registered with
   ``cache_hit`` and v1's blob;
20. isvc — the KServe InferenceService control plane: (a) kserve-bert
   from its manifest (``BERT_ISVC_MANIFEST``, the storage URI a
   directory of seeded f32 bert-base weights) through
   ``InferenceServiceController(default_registry())`` and a
   ``ModelServer``, each answer equal to a direct ``BertRuntimeModel`` on
   the same weights, 12 ``fma`` flash launches a forward; (b) a 30%
   canary of a second revision, 400 request ids split as ``canary_slot``
   says, then its promotion freeing the old weights on the card; (c)
   scale to zero (weights freed) and a cold start with the same answer;
   (d) a transformer component, ``:explain`` 501, an InferenceGraph
   Ensemble over both revisions and a ``RequestLogger``; (e) the
   controller feeding ``InferenceGateway``'s table, and a
   ``causal-lm-engine`` service of the serving phase's model through it,
   judged by near ties against a direct ``LMEngine``.

Each phase prints one JSON line (load: one a run, then its summary;
mlm, mesh, tp, job, tune, pipeline and isvc: one a part; tabular: one a
model, then the mesh and a total).
The line before the last lists every kernel with its launches on its
path, error, times and bound; the last line is ``{"ok": true,
"device": {...}}``. Any failed phase, or a host without CUDA or without
the package, exits non-zero and prints no result. ``--phases`` runs a subset (for debugging); ``--phases profile``
adds a ``torch.profiler`` breakdown of one served batch and of 3
training steps.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
import zlib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}  # dense, non-TF32 f32
PHASES = ("kernels", "forward", "serving", "parity", "engine", "contract",
          "disagg", "fleet", "dense", "bert", "train", "mlm", "mesh", "load",
          "tp", "job", "tabular", "tune", "pipeline", "isvc")

# the widest LM the repo serves (the engine_decode paged bench model)
MODEL = dict(vocab_size=32768, d_model=1024, n_layers=12, n_heads=16,
             d_ff=4096, causal=True, use_rope=True)
ENGINE = dict(max_batch=8, max_seq=128, chunk_steps=8, prefill_buckets=(32,),
              kv_pool_tokens=1152, page_size=32, eos_id=1)
N_REQ, MAX_NEW = 8, 48


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@functools.cache
def _sleep_cycles_per_ms(torch):
    """Cycles of ``torch.cuda._sleep`` per device millisecond, measured
    once with CUDA events."""
    n = 2_000_000
    torch.cuda._sleep(n)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(n)
    e.record()
    e.synchronize()
    return n / s.elapsed_time(e)


def time_ms(torch, fn, iters=20, flush=None):
    """Device time of ``fn``: ``{"ms": median, "min", "spread": max - min,
    "dropped", "samples"}`` over ``iters`` calls timed by CUDA events,
    after warm-up. ``flush`` (a tensor larger than L2) is rewritten before
    each call so inputs are read cold, as the engine's 12-layer pool would
    be. Between the flush and the start event a device-side sleep is
    queued that should outlast the host's time to enqueue ``fn`` (twice
    the slowest warm-up enqueue, plus 0.1 ms), so the card reaches the
    start event only after ``fn``'s work is queued behind it and the
    events time the device alone, not the wrappers' Python, checks and
    ctypes calls. A sample whose start event had already completed when
    ``fn`` returned on the host is dropped: its sleep ran out before the
    enqueue did, so it timed the host too. With more than half dropped
    the sleep doubles and the samples are taken again, once; then the
    timer fails."""
    host_ms = 0.0
    for i in range(3):
        t0 = time.perf_counter()
        fn()
        if i:  # the first call may build and load a kernel
            host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    sleep_ms = min(2 * host_ms + 0.1, 50.0)
    dropped = 0
    for _ in range(2):
        cycles = int(sleep_ms * _sleep_cycles_per_ms(torch))
        kept, late = [], 0
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            torch.cuda._sleep(cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            started = s.query()  # the card already passed the start event
            e.record()
            e.synchronize()
            if started:
                late += 1
            else:
                kept.append(s.elapsed_time(e))
        dropped += late
        if 2 * late <= iters:
            break
        sleep_ms *= 2
    else:
        raise RuntimeError(
            f"time_ms: {late} of {iters} samples outran a {sleep_ms / 2:.3f} "
            "ms sleep twice; the enqueue is slower than the timer allows")
    return {"ms": statistics.median(kept), "min": min(kept),
            "spread": max(kept) - min(kept), "dropped": dropped,
            "samples": len(kept)}


def _times(ms, plain, library=None):
    """A case's timing fields from its ``time_ms`` results: the medians
    under the kernels line's names, and every statistic under
    ``timing``."""
    t = {"ms": ms, "plain_ms": plain}
    if library is not None:
        t["library_ms"] = library
    out = {k: v["ms"] for k, v in t.items()}
    out["dropped"] = {k: v["dropped"] for k, v in t.items()}
    out["timing"] = t
    return out


def compare(out, ref, dt, atol=None):
    """``(max |out - ref|, tolerance, within)``. Every element must lie
    within ``atol + rtol * |ref|``: in f32 atol 2e-5 and no rtol (the sums
    run in another order); in bf16/f16 atol 2e-3 (or the caller's) and
    rtol 2**-6, two ulps of the output type, since both sides round an
    f32 result to it."""
    import torch

    if dt == torch.float32:
        atol, rtol = 2e-5, 0.0
    else:
        atol, rtol = (2e-3 if atol is None else atol), 2.0 ** -6
    diff = (out.float() - ref.float()).abs()
    within = bool((diff <= atol + rtol * ref.float().abs()).all())
    return diff.max().item(), f"atol {atol} + rtol {rtol}", within


def _dtname(torch, dt):
    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[dt]


# --------------------------------------------------------------------------- #
# phase 1: kernels against their plain twins
# --------------------------------------------------------------------------- #

def paged_cases(torch):
    """(name, kwargs) at the serving shapes: B=8 rows, H=16, D=64, page 32,
    windows of up to 4 pages; row 7 is dead (its table is all scratch
    page 0). A bf16/f16 span of G * S > 4 rows a kv head takes the
    tensor-core body (``mma``), every other span the ``decode`` body:
    decode and its f32 twins take ``decode``, the prefill pieces, the
    8-head GQA decode and the K=4 verify ``mma``. Then long contexts of
    64 pages with 4 kv heads (B * Hkv = 32 blocks, so a row's pages spread
    over a cluster of blocks), a decode that sees only its last page (the
    other groups are empty), D=128 and f16 on both bodies, and a window
    narrower than the span, so that for a tile's rows every group of one
    cluster block is empty."""
    base = dict(B=8, H=16, Hkv=16, D=64, P=32, T=1152, W=4)
    long = dict(base, Hkv=4, W=64, T=(8 * 64 + 1) * 32)
    d128 = dict(base, D=128)
    # one row, one kv head, 64 queries, a 16-token window over pages of 16:
    # the cluster has 2 blocks, and each tile sees 2 of the 5 pages
    narrow = dict(B=1, H=1, Hkv=1, D=64, P=16, T=144, W=8, S=64, window=16,
                  pos0_end=True, live_rows=True)
    return [
        ("decode_bf16", dict(base, S=1, dtype=torch.bfloat16)),
        ("decode_f32", dict(base, S=1, dtype=torch.float32)),
        ("prefill_bf16", dict(base, S=32, dtype=torch.bfloat16)),
        ("prefill_f32", dict(base, S=32, dtype=torch.float32)),
        ("gqa_prefill_bf16", dict(base, S=32, Hkv=4, dtype=torch.bfloat16)),
        ("gqa8_decode_bf16", dict(base, S=1, Hkv=2, dtype=torch.bfloat16)),
        ("window_prefill_bf16", dict(base, S=32, window=48, dtype=torch.bfloat16)),
        ("int8_decode_bf16", dict(base, S=1, quant=True, dtype=torch.bfloat16)),
        ("int8_prefill_bf16", dict(base, S=32, quant=True, dtype=torch.bfloat16)),
        ("int8_prefill_f32", dict(base, S=32, quant=True, dtype=torch.float32)),
        ("pos0_zero_decode_bf16", dict(base, S=1, pos0_zero=True, dtype=torch.bfloat16)),
        ("long_decode_gqa_bf16", dict(long, S=1, pos0_end=True, dtype=torch.bfloat16)),
        ("long_decode_gqa_f32", dict(long, S=1, pos0_end=True, dtype=torch.float32)),
        ("long_prefill_gqa_bf16", dict(long, S=32, pos0_end=True, dtype=torch.bfloat16)),
        ("long_int8_decode_gqa_bf16", dict(long, S=1, pos0_end=True, quant=True,
                                           dtype=torch.bfloat16)),
        ("long_window700_decode_gqa_bf16", dict(long, S=1, window=700,
                                                dtype=torch.bfloat16)),
        ("long_window700_prefill_gqa_f32", dict(long, S=32, window=700,
                                                dtype=torch.float32)),
        ("last_page_decode_bf16", dict(base, S=1, W=16, T=(8 * 16 + 1) * 32, window=32,
                                       pos0_end=True, dtype=torch.bfloat16)),
        # the engine's spans: a K=4 speculative verify (G * S = 5) with
        # each row's span at its own position, and a 16-token prefill
        # piece after a 64-token implanted prefix
        ("verify_bf16", dict(base, S=5, pos0_spread=(20, 120), dtype=torch.bfloat16)),
        ("verify_int8_bf16", dict(base, S=5, pos0_spread=(20, 120), quant=True,
                                  dtype=torch.bfloat16)),
        ("suffix_offset_bf16", dict(base, B=1, S=16, pos0_fixed=64, live_rows=True,
                                    dtype=torch.bfloat16)),
        ("verify_f16", dict(base, S=5, pos0_spread=(20, 120), dtype=torch.float16)),
        ("prefill_f16", dict(base, S=32, dtype=torch.float16)),
        ("decode_d128_bf16", dict(d128, S=1, dtype=torch.bfloat16)),
        ("verify_d128_bf16", dict(d128, S=5, pos0_spread=(20, 120), dtype=torch.bfloat16)),
        ("window_cluster_bf16", dict(narrow, dtype=torch.bfloat16)),
        ("window_cluster_f32", dict(narrow, dtype=torch.float32)),
    ] + tp_paged_cases(torch)


#: the tp phase's mesh: two ranks, the heads split over ``model``
TP_RANKS = 2
#: the speculative runs' draft tokens a step (the engine and tp phases)
SPEC_K = 4


def tp_paged_cases(torch):
    """The shapes a rank of the tp phase launches the paged kernel at: its
    share of the heads (16 / ``TP_RANKS``), the served decode (B=8, S=1)
    and the K=4 speculative verify (S=5, each row's span at its own
    position) at each table width the engine's pow2 horizon takes (1, 2
    and 4 pages of 32), and the prefill piece (B=1, S=32, one page), in
    bf16 (the served model) and f32 (the parity run)."""
    H = MODEL["n_heads"] // TP_RANKS
    decode = dict(B=8, H=H, Hkv=H, D=64, P=32, T=1152, S=1)
    piece = dict(decode, B=1, S=32, W=1, live_rows=True)
    out = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        out += [(f"tp_decode_{tag}_w{w}", dict(decode, W=w, dtype=dt))
                for w in (1, 2, 4)]
        out.append((f"tp_prefill_{tag}_w1", dict(piece, dtype=dt)))
        out += [(f"tp_verify_{tag}_w{w}", dict(decode, S=SPEC_K + 1, W=w, dtype=dt))
                for w in (1, 2, 4)]
    return out


def paged_case_key(torch, c):
    """A paged case's shape as the wrapper's ``LAUNCHES_BY_SHAPE`` names a
    launch."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    kv = torch.int8 if c.get("quant") else c["dtype"]
    return pa.shape_key(c["dtype"], kv, c["B"], c["H"], c["Hkv"], c["S"],
                        c["D"], c["P"], c["W"])


def paged_inputs(torch, name, c):
    """``(q, k_pool, v_pool, table, pos0, kwargs)`` of one paged case, made
    on the card from a generator seeded by the case's name."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    B, H, Hkv, S, D, P, T, W = (c[k] for k in ("B", "H", "Hkv", "S", "D", "P", "T", "W"))
    dt = c["dtype"]
    dev = "cuda"
    q = torch.randn(B, H, S, D, generator=g, device=dev).to(dt)
    kf = torch.randn(Hkv, T, D, generator=g, device=dev)
    vf = torch.randn(Hkv, T, D, generator=g, device=dev)
    ks = vs = None
    if c.get("quant"):
        kp, ks = pa.quantize_kv(kf)
        vp, vs = pa.quantize_kv(vf)
    else:
        kp, vp = kf.to(dt).contiguous(), vf.to(dt).contiguous()
    n_pages = T // P
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = perm[: B * W].reshape(B, W).to(torch.int32)
    if not c.get("live_rows"):
        table[B - 1] = 0  # dead row: every entry is the scratch page
    if c.get("pos0_spread"):  # each row's span at its own position
        lo, hi = c["pos0_spread"]
        pos0 = torch.linspace(lo, hi, B, device=dev).round().to(torch.int32)
    elif c.get("pos0_fixed") is not None:
        pos0 = torch.full((B,), c["pos0_fixed"], dtype=torch.int32, device=dev)
    elif c.get("pos0_zero"):
        pos0 = torch.zeros(B, dtype=torch.int32, device=dev)
    elif c.get("pos0_end"):  # every row's span ends on the last table slot
        pos0 = torch.full((B,), W * P - S, dtype=torch.int32, device=dev)
    else:
        pos0 = torch.randint(0, W * P - S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
    kw = dict(page_size=P, window=c.get("window"), k_scale=ks, v_scale=vs)
    return q, kp, vp, table, pos0, kw


def run_paged_case(torch, name, c, flush):
    from kubeflow_tpu_torch.ops import paged_attention as pa

    q, kp, vp, table, pos0, kw = paged_inputs(torch, name, c)
    B, H, Hkv, S, D, P, W = (c[k] for k in ("B", "H", "Hkv", "S", "D", "P", "W"))
    dt, window, ks = c["dtype"], kw["window"], kw["k_scale"]
    out = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    again = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    ref = pa.paged_attention_reference(q, kp, vp, table, pos0, **kw)
    torch.cuda.synchronize()
    err, tol, close = compare(out, ref, dt)
    repeat = torch.equal(out, again)
    ms = time_ms(torch, lambda: pa.paged_attention(q, kp, vp, table, pos0, **kw),
                 flush=flush)
    plain = time_ms(
        torch, lambda: pa.paged_attention_reference(q, kp, vp, table, pos0, **kw),
        flush=flush,
    )
    # bound: bytes of the pages each row's span actually visits, q, out,
    # table, pos0 (+ scales); flops 4*D per visible (query, key) pair
    # (a page several rows visit, as the dead row's scratch page, counts once)
    p0, tbl = pos0.tolist(), table.tolist()
    pages = set()
    visible = 0
    for b in range(B):
        for i in range(W):
            first = i * P
            run = first <= p0[b] + S - 1
            if window is not None:
                run = run and first + P - 1 >= p0[b] - window + 1
            if run:
                pages.add(tbl[b][i])
        for s in range(S):
            qp = p0[b] + s
            lo = 0 if window is None else max(0, qp - window + 1)
            visible += max(0, qp - lo + 1)
    page_bytes = 2 * Hkv * P * (D * kp.element_size() + (4 if ks is not None else 0))
    nbytes = len(pages) * page_bytes + 2 * q.numel() * q.element_size() + table.numel() * 4 + B * 4
    flops = 4 * D * H * visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtname(torch, dt)] * 1e3
    return {
        "kernel": "paged_attention", "case": name, "shape": [B, H, Hkv, S, D, P, W],
        "launch_shape": paged_case_key(torch, c),
        "dtype": _dtname(torch, dt), "body": pa.body(H // Hkv, S, dt),
        "kv": "int8" if ks is not None else _dtname(torch, dt),
        "window": window, "max_abs_err": err, "tol": tol, "bitwise_repeat": repeat,
        "ok": close and repeat,
        **_times(ms, plain), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def paged_invariance_cases(torch):
    """(name, dtype, S, W of the batch) for the batch-invariance check: the
    decode body in bf16 and f32 (S=1, and the f32 verify at S=5), the
    mma body in bf16 (S=5), at W=4 and at 64 pages."""
    bf, f32 = torch.bfloat16, torch.float32
    return [("decode_bf16", bf, 1, 4), ("decode_f32", f32, 1, 4),
            ("verify_f32", f32, 5, 4), ("verify_bf16", bf, 5, 4),
            ("long_decode_bf16", bf, 1, 64), ("long_decode_f32", f32, 1, 64),
            ("long_verify_bf16", bf, 5, 64)]


def run_paged_invariance(torch, name, dt, S, W):
    """One row decoded in a batch of 8 at table width W against the same
    row alone with its table padded to 64 pages (W=4), or to 96 (W=64):
    another grid, so another cluster size, must give the same bits."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    c = dict(B=8, H=16, Hkv=16, D=64, P=32, T=(8 * W + 1) * 32, W=W, S=S, dtype=dt,
             live_rows=True, pos0_spread=(W * 32 // 4, W * 32 - S))
    q, kp, vp, table, pos0, kw = paged_inputs(torch, f"invariance_{name}", c)
    out = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    row = 5
    wide = 64 if W < 64 else 96
    tbl1 = torch.zeros(1, wide, dtype=torch.int32, device="cuda")
    tbl1[0, :W] = table[row]
    alone = pa.paged_attention(q[row:row + 1].contiguous(), kp, vp, tbl1,
                               pos0[row:row + 1].contiguous(), **kw)
    ref = pa.paged_attention_reference(q, kp, vp, table, pos0, **kw)
    torch.cuda.synchronize()
    err, tol, close = compare(out, ref, dt)
    same = torch.equal(out[row], alone[0])
    return {"kernel": "paged_attention", "invariance": name, "dtype": _dtname(torch, dt),
            "body": pa.body(1, S, dt), "S": S, "W": [W, wide], "pos0": pos0[row].item(),
            "bitwise_equal": same, "max_abs_err": err, "tol": tol,
            "ok": same and close}


def flash_cases(torch):
    """The training shape first (B=8, H=16, S=512, D=64, causal bf16). The
    bf16 and f16 cases at D a multiple of 16 run the tensor-core
    (``wgmma``) body; the f32 cases and ``ragged_d40_bf16`` the ``fma``
    body. ``Sq`` (default ``S``) sets a query length apart from the kv
    length ``S``."""
    base = dict(B=8, H=16, D=64)
    return [
        ("causal_s512_bf16", dict(base, S=512, dtype=torch.bfloat16)),
        ("causal_s128_bf16", dict(base, S=128, dtype=torch.bfloat16)),
        ("causal_s128_f32", dict(base, S=128, dtype=torch.float32)),
        ("window_s512_bf16", dict(base, S=512, window=128, dtype=torch.bfloat16)),
        ("segment_s512_bf16", dict(base, S=512, seg=True, dtype=torch.bfloat16)),
        ("ragged_s200_bf16", dict(base, S=200, dtype=torch.bfloat16)),
        # q segment 2 is absent from the kv ids: those rows see no key, end
        # with out = mean(v) and lse at the -1e30 sentinel, as the twin
        ("dead_rows_s128_bf16", dict(base, S=128, causal=False, dead=True,
                                     dtype=torch.bfloat16)),
        ("causal_s512_d128_bf16", dict(B=4, H=8, D=128, S=512,
                                       dtype=torch.bfloat16)),
        # bert-base serving: non-causal, padding masks as segment ids
        # (valid lengths BERT_VALID_LENS), the f32 default and bf16
        ("bert_s128_f32", dict(B=8, H=12, D=64, S=128, causal=False,
                               pad=BERT_VALID_LENS, dtype=torch.float32)),
        ("bert_s128_bf16", dict(B=8, H=12, D=64, S=128, causal=False,
                                pad=BERT_VALID_LENS, dtype=torch.bfloat16)),
        # the f32 p50 path: one request, 97 valid tokens
        ("bert_s128_b1_f32", dict(B=1, H=12, D=64, S=128, causal=False,
                                  pad=(97,), dtype=torch.float32)),
        # dead rows in f32: the fma body's segment-tile skip must keep them
        ("dead_rows_s128_f32", dict(base, S=128, causal=False, dead=True,
                                    dtype=torch.float32)),
        # a half type at a head dim no tensor-core tile fits: the fma body
        ("ragged_d40_bf16", dict(B=2, H=4, D=40, S=200, dtype=torch.bfloat16)),
        # the f16 instantiation of the tensor-core body
        ("causal_s512_f16", dict(base, S=512, dtype=torch.float16)),
        # bf16 BERT at one request, 97 valid tokens: the smallest grid
        ("bert_s128_b1_bf16", dict(B=1, H=12, D=64, S=128, causal=False,
                                   pad=(97,), dtype=torch.bfloat16)),
        # D=48 in a 64-column tile: the columns past D come back as zeros
        ("causal_s512_d48_bf16", dict(base, D=48, S=512, dtype=torch.bfloat16)),
        # 128 queries against 512 keys, causal bottom-right (query i at
        # position i + 384): a suffix, as a prefill piece after a prefix
        ("cross_q128_kv512_bf16", dict(base, Sq=128, S=512, dtype=torch.bfloat16)),
        # more queries than keys, causal: the first Sq - S queries sit
        # before the first key and see none; as the twin, they end at
        # mean(v) over every key and lse at the -1e30 sentinel. 128 against
        # 64: the first q tile reaches no kv tile; 160 against 100: a q
        # tile of dead and live rows, a ragged last kv tile
        ("cross_q128_kv64_bf16", dict(base, Sq=128, S=64, dtype=torch.bfloat16)),
        ("cross_q160_kv100_bf16", dict(base, Sq=160, S=100, dtype=torch.bfloat16)),
        ("cross_q160_kv100_f32", dict(base, Sq=160, S=100, dtype=torch.float32)),
        # bert-base MLM training (the mlm phase's bf16 fit): non-causal, one
        # segment a row (the loss passes no padding mask)
        ("mlm_s128_bf16", dict(B=32, H=12, D=64, S=128, causal=False,
                               ones=True, dtype=torch.bfloat16)),
        # ring attention's hops (mesh phase): Sq = Skv = S/seq, the causal
        # diagonal and the full blocks of earlier ranks. (b): seq=2 with 8
        # of 16 heads a model rank; (a): seq=4, bf16 and f32 (its causal
        # hops are causal_s128_bf16 / _f32)
        ("ring_hop_s256_h8_bf16", dict(B=8, H=8, D=64, S=256, dtype=torch.bfloat16)),
        ("ring_hop_full_s256_h8_bf16", dict(B=8, H=8, D=64, S=256, causal=False,
                                            dtype=torch.bfloat16)),
        ("ring_hop_full_s128_bf16", dict(base, S=128, causal=False,
                                         dtype=torch.bfloat16)),
        ("ring_hop_full_s128_f32", dict(base, S=128, causal=False,
                                        dtype=torch.float32)),
        # (c): the MoE LM's attention over its fsdp=2 rows (B=4 a rank)
        ("mesh_fsdp_b4_s512_bf16", dict(base, B=4, S=512, dtype=torch.bfloat16)),
        # (a)'s Ulysses: the whole sequence, 16 / seq=4 heads a rank
        ("ulysses_s512_h4_bf16", dict(base, H=4, S=512, dtype=torch.bfloat16)),
        ("ulysses_s512_h4_f32", dict(base, H=4, S=512, dtype=torch.float32)),
    ]


#: the BERT kernel cases' valid lengths a row: full, ragged across tile
#: edges, a single token
BERT_VALID_LENS = (128, 97, 64, 33, 16, 128, 5, 1)


def flash_case_inputs(torch, name, c):
    """``(q, k, v, kw)`` of flash case ``name``: random inputs from a
    generator seeded by the name, and the mask arguments."""
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    B, H, S, D, dt = c["B"], c["H"], c["S"], c["D"], c["dtype"]
    Sq = c.get("Sq", S)
    causal = c.get("causal", True)
    q, k, v = (torch.randn(B, H, n, D, generator=g, device="cuda").to(dt)
               for n in (Sq, S, S))
    seg = kseg = None
    if c.get("seg"):
        # packed rows: 1..4 segments per row at random boundaries
        cuts = torch.rand(B, S, generator=g, device="cuda") < 3.0 / S
        cuts[:, 0] = False
        seg = kseg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    if c.get("pad"):
        # BERT's attention_mask as segments: valid tokens 1, pads 0
        lens = torch.tensor(c["pad"], device="cuda")
        seg = kseg = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                      ).to(torch.int32).contiguous()
    if c.get("ones"):  # BertEncoder's default mask: one segment a row
        seg = kseg = torch.ones(B, S, device="cuda", dtype=torch.int32)
    if c.get("dead"):
        kseg = torch.randint(0, 2, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        seg = torch.randint(0, 3, (B, S), generator=g, device="cuda",
                            dtype=torch.int32)
    kw = dict(causal=causal, window=c.get("window"), q_segment_ids=seg,
              kv_segment_ids=kseg)
    return q, k, v, kw


def run_flash_case(torch, name, c, flush):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    q, k, v, kw = flash_case_inputs(torch, name, c)
    B, H, Sq, D, dt = *q.shape, q.dtype
    S = k.shape[2]
    causal, window = kw["causal"], kw["window"]
    seg, kseg = kw["q_segment_ids"], kw["kv_segment_ids"]
    out, lse = fa.flash_attention(q, k, v, return_residuals=True, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    # bf16: the kernel rounds p = exp(s - m) to bf16 against its running
    # max m, the twin against the row's final max; each rounding is
    # within 2**-9 of p, so out may differ by 2**-8 * max|v| beyond that
    err, tol, close = compare(out, ref, dt,
                              atol=2.0 ** -8 * v.float().abs().max().item())
    lse_err = (lse - ref_lse).abs().max().item()
    lse_tol = 2e-4  # f32 in both; exp/log and summation order only
    dead = None
    if c.get("dead") or Sq > S:  # rows that see no key: lse at the sentinel in both
        rows = ref_lse <= fa.NEG_INF / 2
        dead = {"rows": int(rows.sum().item()),
                "lse_sentinel": bool((lse[rows] <= fa.NEG_INF / 2).all())}
    repeat = None
    if dt != torch.float32:  # no atomics: a second launch gives the same bits
        out2, lse2 = fa.flash_attention(q, k, v, return_residuals=True, **kw)
        torch.cuda.synchronize()
        repeat = torch.equal(out, out2) and torch.equal(lse, lse2)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), flush=flush)
    plain = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, **kw),
                    flush=flush)
    mask = fa._full_mask(q.shape, k.shape, seg, kseg, causal, window, q.device)
    if window is None and seg is None and Sq == S:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
    else:  # SDPA's is_causal aligns top-left: the mask says bottom-right
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
    library = time_ms(torch, lib, flush=flush)
    visible = B * Sq * S if mask is None else int(mask.expand(B, 1, Sq, S).sum().item())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + B * H * Sq * 4 + (
        (seg.numel() + kseg.numel()) * 4 if seg is not None else 0)
    flops = 4 * D * H * visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtname(torch, dt)] * 1e3
    return {
        "kernel": "flash_attention", "case": name,
        "shape": [B, H, S, D] if Sq == S else [B, H, Sq, S, D],
        "dtype": _dtname(torch, dt), "body": fa.body(dt, D), "causal": causal,
        "window": window, "segments": seg is not None, "dead_rows": dead,
        "bitwise_repeat": repeat,
        "max_abs_err": err, "tol": tol, "lse_err": lse_err, "lse_tol": lse_tol,
        "ok": close and lse_err <= lse_tol and repeat is not False and (
            dead is None or (dead["rows"] > 0 and dead["lse_sentinel"])),
        **_times(ms, plain, library), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def bwd_cases(torch):
    """The training shape first (B=8, H=16, S=512, D=64, causal bf16). The
    dq and dk/dv kernels run their tensor-core (``wgmma``) bodies on the
    bf16 and f16 cases at D a multiple of 16 and their ``fma`` bodies on
    the f32 ones and ``ragged_d40_bf16``. ``Sq`` (default ``S``) sets a
    query length apart from the kv length ``S``."""
    base = dict(B=8, H=16, D=64, causal=True)
    return [
        ("causal_s512_bf16", dict(base, S=512, dtype=torch.bfloat16)),
        ("causal_s128_f32", dict(base, S=128, dtype=torch.float32)),
        # the f32 parity steps' shape (the train phase's 60 launches each)
        ("causal_s512_f32", dict(base, S=512, dtype=torch.float32)),
        ("causal_s512_f16", dict(base, S=512, dtype=torch.float16)),
        ("window_s512_bf16", dict(base, S=512, window=128, dtype=torch.bfloat16)),
        ("segment_s512_bf16", dict(base, S=512, seg=True, dtype=torch.bfloat16)),
        ("ragged_s200_f32", dict(base, S=200, dtype=torch.float32)),
        ("ragged_s200_bf16", dict(base, S=200, dtype=torch.bfloat16)),
        # q segment 2 is absent from the kv ids: those rows are dead (lse
        # at the -1e30 sentinel) and must add exactly 0
        ("dead_rows_s128_f32", dict(base, S=128, causal=False, dead=True,
                                    dtype=torch.float32)),
        ("dead_rows_s128_bf16", dict(base, S=128, causal=False, dead=True,
                                     dtype=torch.bfloat16)),
        ("causal_s512_d128_bf16", dict(base, B=4, H=8, D=128, S=512,
                                       dtype=torch.bfloat16)),
        # bert-base MLM training: non-causal, padding masks as segment ids
        # (valid lengths BERT_VALID_LENS): the segment-tile skip
        ("bert_s128_f32", dict(B=8, H=12, D=64, S=128, causal=False,
                               pad=BERT_VALID_LENS, dtype=torch.float32)),
        # the fma bodies' D <= 128 instantiation
        ("causal_s256_d128_f32", dict(base, B=4, H=8, D=128, S=256,
                                      dtype=torch.float32)),
        # a half type at a head dim no tensor-core tile fits: the fma bodies
        ("ragged_d40_bf16", dict(base, B=2, H=4, D=40, S=200,
                                 dtype=torch.bfloat16)),
        # kv segment 7 (keys 30..69, across two kv tiles) that no query
        # has: those keys get dk = dv = 0 exactly
        ("dead_keys_s128_bf16", dict(base, S=128, causal=False, dead_keys=True,
                                     dtype=torch.bfloat16)),
        # 128 queries against 512 keys, causal bottom-right, window 64:
        # kv tiles 0-4 reach no q tile (their dk = dv = 0), and must not hang
        ("cross_q128_kv512_window_bf16", dict(base, Sq=128, S=512, window=64,
                                              dtype=torch.bfloat16)),
        # more queries than keys, causal: rows before the first key are
        # dead (dq = 0); ragged q and kv tiles, a q tile of dead and live rows
        ("cross_q160_kv100_bf16", dict(base, Sq=160, S=100, dtype=torch.bfloat16)),
        # bert-base MLM training in bf16: padding segments, non-causal
        ("bert_s128_bf16", dict(B=8, H=12, D=64, S=128, causal=False,
                                pad=BERT_VALID_LENS, dtype=torch.bfloat16)),
        # D=48 in a 64-column tile: loads read zeros past D, stores stop there
        ("causal_s512_d48_bf16", dict(base, D=48, S=512, dtype=torch.bfloat16)),
        # bert-base MLM training (the mlm phase's bf16 fit, bench.py's 32 x
        # 128): non-causal, one segment a row
        ("mlm_s128_bf16", dict(B=32, H=12, D=64, S=128, causal=False,
                               ones=True, dtype=torch.bfloat16)),
        # ring attention's backward hops (mesh phase), as the forward's
        ("ring_hop_s256_h8_bf16", dict(base, H=8, S=256, dtype=torch.bfloat16)),
        ("ring_hop_full_s256_h8_bf16", dict(base, H=8, S=256, causal=False,
                                            dtype=torch.bfloat16)),
        ("ring_hop_s128_bf16", dict(base, S=128, dtype=torch.bfloat16)),
        ("ring_hop_full_s128_bf16", dict(base, S=128, causal=False,
                                         dtype=torch.bfloat16)),
        ("ring_hop_full_s128_f32", dict(base, S=128, causal=False,
                                        dtype=torch.float32)),
        # the MoE LM's and (a)'s Ulysses backward, as the forward's
        ("mesh_fsdp_b4_s512_bf16", dict(base, B=4, S=512, dtype=torch.bfloat16)),
        ("ulysses_s512_h4_bf16", dict(base, H=4, S=512, dtype=torch.bfloat16)),
        ("ulysses_s512_h4_f32", dict(base, H=4, S=512, dtype=torch.float32)),
    ]


def case_shape(c) -> str:
    """A flash case's shape as the wrappers' ``*_BY_SHAPE`` counters name
    it."""
    from kubeflow_tpu_torch.ops.flash_attention import shape_key

    return shape_key(c["dtype"], c["B"], c["H"], c.get("Sq", c["S"]), c["S"],
                     c["D"], c.get("causal", True))


#: the cases of the mesh phase's shapes (their results feed the kernels line)
MESH_CASE_PREFIXES = ("ring_hop", "mesh_fsdp", "ulysses")


def bwd_tolerance(torch, fa, q, k, v, out, lse, dout, kw, refs):
    """Elementwise tolerances of (dq, dk, dv) against the twin.

    f32: PR 1's atol 2e-5, scaled by max(1, max|ref|): dk and dv are sums
    over up to S query rows and reach |g| ~ 4 at S = 512, where the f32
    summation-order noise grows with them. bf16/f16: the kernels round
    twice, ds to q's dtype and p to dO's dtype, from f32 values that differ
    from the twin's by that noise. Where the two straddle a rounding
    boundary they land one ulp apart: at most 2**-7 |x| in bf16 (8
    significant bits), 2**-10 |x| in f16. So |d dq| <= u * sum_j |ds||k|,
    |d dk| <= u * sum_i |ds||q| and |d dv| <= u * sum_i p |dO|, with
    u = 2**-7 or 2**-10, added to the f32 term."""
    tols = [2e-5 * max(1.0, r.abs().max().item()) for r in refs]
    if q.dtype == torch.float32:
        return tols
    u = 2.0 ** -7 if q.dtype == torch.bfloat16 else 2.0 ** -10
    p, ds = fa._bwd_probs(q, k, v, out, lse, dout, **kw)
    ads = ds.abs()
    bounds = (
        torch.einsum("bhqk,bhkd->bhqd", ads, k.float().abs()),
        torch.einsum("bhqk,bhqd->bhkd", ads, q.float().abs()),
        torch.einsum("bhqk,bhqd->bhkd", p, dout.float().abs()),
    )
    return [t + u * b for t, b in zip(tols, bounds)]


def bwd_case_inputs(torch, name, c):
    """``(q, k, v, dout, lse, out, kw)`` of backward case ``name``: random
    inputs from a generator seeded by the name, the mask arguments and
    the twin's forward residuals."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    B, H, S, D, dt, causal = (c[k] for k in ("B", "H", "S", "D", "dtype", "causal"))
    Sq = c.get("Sq", S)
    q, k, v, dout = (torch.randn(B, H, n, D, generator=g, device="cuda").to(dt)
                     for n in (Sq, S, S, Sq))
    qseg = kseg = None
    if c.get("seg"):
        cuts = torch.rand(B, S, generator=g, device="cuda") < 3.0 / S
        cuts[:, 0] = False
        qseg = kseg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    if c.get("pad"):
        # BERT's attention_mask as segments: valid tokens 1, pads 0
        lens = torch.tensor(c["pad"], device="cuda")
        qseg = kseg = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                       ).to(torch.int32).contiguous()
    if c.get("ones"):  # BertEncoder's default mask: one segment a row
        qseg = kseg = torch.ones(B, S, device="cuda", dtype=torch.int32)
    if c.get("dead"):
        kseg = torch.randint(0, 2, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        qseg = torch.randint(0, 3, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
    if c.get("dead_keys"):
        qseg = torch.zeros(B, S, device="cuda", dtype=torch.int32)
        qseg[:, S // 2:] = 1
        kseg = qseg.clone()
        kseg[:, 30:70] = 7
    window = c.get("window")
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, window=window,
              q_segment_ids=qseg, kv_segment_ids=kseg)
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    return q, k, v, dout, lse, out, kw


def run_bwd_case(torch, name, c, flush):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb

    q, k, v, dout, lse, out, kw = bwd_case_inputs(torch, name, c)
    B, H, Sq, D = q.shape
    S, dt, causal, window = k.shape[2], q.dtype, kw["causal"], kw["window"]
    qseg, kseg = kw["q_segment_ids"], kw["kv_segment_ids"]
    delta = (dout.float() * out.float()).sum(-1)
    got = (fb.launch_dq(q, k, v, dout, lse, delta, **kw),
           *fb.launch_dkv(q, k, v, dout, lse, delta, **kw))
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    tols = bwd_tolerance(torch, fa, q, k, v, out, lse, dout, kw, refs)
    errs, oks = [], []
    for x, r, t in zip(got, refs, tols):
        diff = (x - r).abs()
        errs.append(diff.max().item())
        oks.append(bool(torch.isfinite(x).all()) and bool((diff <= t).all()))
    # rows that see no key (lse at the sentinel): dq exactly 0; keys that
    # no live row sees: dk = dv = 0 exactly
    mask = fa._full_mask(q.shape, k.shape, qseg, kseg, causal, window, q.device)
    live = lse > fa.NEG_INF / 2
    seen = live[..., None].expand(B, H, Sq, S) if mask is None else (mask & live[..., None])
    unseen = ~seen.any(dim=2)  # (B, H, S)
    dead = {"rows": int((~live).sum().item()),
            "dq_zero": bool((got[0][~live] == 0).all()),
            "keys": int(unseen.sum().item()),
            "dkv_zero": bool((got[1][unseen] == 0).all() and (got[2][unseen] == 0).all())}
    oks += [dead["dq_zero"], dead["dkv_zero"]]
    if c.get("dead"):
        oks.append(dead["rows"] > 0)
    if c.get("dead_keys") or window is not None and Sq < S:
        oks.append(dead["keys"] > 0)
    # no atomics: a second launch gives the same bits
    again = (fb.launch_dq(q, k, v, dout, lse, delta, **kw),
             *fb.launch_dkv(q, k, v, dout, lse, delta, **kw))
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    oks.append(repeat)
    ms_dq = time_ms(torch, lambda: fb.launch_dq(q, k, v, dout, lse, delta, **kw),
                    flush=flush)
    ms_dkv = time_ms(torch, lambda: fb.launch_dkv(q, k, v, dout, lse, delta, **kw),
                     flush=flush)
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, **kw), flush=flush)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if mask is None:
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    else:
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    library = time_ms(torch, lambda: torch.autograd.grad(
        o, leaves, dout, retain_graph=True), flush=flush)
    # plain causal: SDPA's own causal path (aligned top-left, the same
    # mask at Sq == S), beside the boolean mask the yardstick has used
    library_causal = None
    if causal and window is None and qseg is None and Sq == S:
        oc = F.scaled_dot_product_attention(*leaves, is_causal=True)
        library_causal = time_ms(torch, lambda: torch.autograd.grad(
            oc, leaves, dout, retain_graph=True), flush=flush)
    if mask is None:
        visible = B * Sq * S
    else:
        visible = int(mask.expand(B, 1, Sq, S).sum().item())
    # dead rows see nothing: their pairs are masked, so not counted
    el = q.element_size()
    n_in = 2 * (q.numel() + k.numel()) * el + 2 * B * H * Sq * 4 + (
        B * (Sq + S) * 4 if qseg is not None else 0)
    peak = PEAK_FLOPS[_dtname(torch, dt)]
    bounds = {}
    for kern, nbytes, flops in (("dq", n_in + q.numel() * 4, 6 * D * H * visible),
                                ("dkv", n_in + 2 * k.numel() * 4, 8 * D * H * visible)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bounds[kern] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return {
        "kernel": "flash_attention_bwd", "case": name,
        "shape": [B, H, S, D] if Sq == S else [B, H, Sq, S, D],
        "dtype": _dtname(torch, dt),
        "body": {"dq": fb.dq_body(dt, D), "dkv": fb.dkv_body(dt, D)},
        "causal": causal, "window": window,
        "segments": qseg is not None, "dead_rows_keys": dead,
        "bitwise_repeat": repeat,
        "max_abs_err": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
        "tol_max": {"dq": float(torch.as_tensor(tols[0]).max()),
                    "dk": float(torch.as_tensor(tols[1]).max()),
                    "dv": float(torch.as_tensor(tols[2]).max())},
        "ok": all(oks),
        "ms": {"dq": ms_dq["ms"], "dkv": ms_dkv["ms"]}, "plain_ms": plain["ms"],
        "bound_ms": {"dq": bounds["dq"][0], "dkv": bounds["dkv"][0]},
        "bound_by": {"dq": bounds["dq"][1], "dkv": bounds["dkv"][1]},
        "library_ms": library["ms"],
        "library_is_causal_ms": library_causal and library_causal["ms"],
        "dropped": {"dq": ms_dq["dropped"], "dkv": ms_dkv["dropped"],
                    "plain_ms": plain["dropped"], "library_ms": library["dropped"]},
        "timing": {"dq": ms_dq, "dkv": ms_dkv, "plain_ms": plain,
                   "library_ms": library, "library_is_causal_ms": library_causal},
    }


def wgmma_bwd_build(ptxas):
    """``(ok, report)``: every ``flash_bwd_*_wgmma_kernel`` instantiation
    of the build with 0 spill bytes and no wgmma serialized."""
    report = {k: v for k, v in ptxas.get("flash_attention_bwd", {}).items()
              if k.startswith("flash_bwd_") and "_wgmma_kernel" in k}
    # 2 kernels x (bf16, f16) x (D <= 64, D <= 128) x (segment ids or not)
    ok = len(report) == 16 and all(
        v.endswith(" 0 bytes spill") for v in report.values())
    return ok, report


def paged_build(ptxas):
    """``(ok, report)``: every paged-attention instantiation of the build
    (``paged_attn_decode_kernel``: 3 q types x (own pool, int8) x 2 head
    dims; ``paged_attn_mma_kernel``: 2 x 2 x 2) with 0 spill bytes."""
    report = dict(ptxas.get("paged_attention", {}))
    ok = (sum(k.startswith("paged_attn_decode_kernel") for k in report) == 12
          and sum(k.startswith("paged_attn_mma_kernel") for k in report) == 8
          and len(report) == 20
          and all(v.endswith(" 0 bytes spill") for v in report.values()))
    return ok, report


def _zero_paged(pa):
    """Set the paged kernel's launch counts to 0: in all, by span, by body."""
    pa.LAUNCHES = 0
    pa.LAUNCHES_BY_S.clear()
    pa.LAUNCHES_BY_SHAPE.clear()
    for k in pa.LAUNCHES_BY_BODY:
        pa.LAUNCHES_BY_BODY[k] = 0


def _paged_counts(pa):
    """``(launches, by span S, by body)`` since :func:`_zero_paged`."""
    return pa.LAUNCHES, dict(pa.LAUNCHES_BY_S), dict(pa.LAUNCHES_BY_BODY)


def _bodies_follow_rule(pa, by_s, by_body, dtype, groups=1):
    """Whether the launches of each span ran on the body the rule gives a
    model of ``groups`` query heads a kv head in ``dtype``."""
    want = {k: 0 for k in by_body}
    for s, n in by_s.items():
        want[pa.body(groups, s, dtype)] += n
    return want == by_body


def phase_kernels(torch, state):
    build_ok, report = wgmma_bwd_build(state.get("ptxas", {}))
    emit({"phase": "bwd_build", "instantiations": report, "ok": build_ok})
    paged_ok, report = paged_build(state.get("ptxas", {}))
    emit({"phase": "paged_build", "instantiations": report, "ok": paged_ok})
    build_ok &= paged_ok
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    # the timer's floor: one launch that does next to nothing, after the flush
    one = torch.empty(1, device="cuda")
    emit({"phase": "timer_floor", "op": "fill_ of one float",
          **time_ms(torch, lambda: one.fill_(1.0), flush=flush)})
    ok = build_ok
    for name, c in bwd_cases(torch):
        r = run_bwd_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "causal_s512_bf16":
            state["bwd_main"] = r
        elif name == "causal_s128_f32":
            state["bwd_f32"] = r
        elif name in ("mlm_s128_bf16", "bert_s128_f32"):
            state.setdefault("bwd_mlm", {})[name] = r
        elif name.startswith(MESH_CASE_PREFIXES):
            state.setdefault("bwd_mesh", {})[name] = dict(r, shape=case_shape(c))
    for name, c in paged_cases(torch):
        r = run_paged_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "decode_bf16":
            state["paged_main"] = r
        elif name == "prefill_bf16":
            state["paged_mma"] = r
        elif name.startswith("tp_"):
            state.setdefault("paged_tp", {})[name] = r
    for name, dt, S, W in paged_invariance_cases(torch):
        r = run_paged_invariance(torch, name, dt, S, W)
        emit(r)
        ok &= r["ok"]
    for name, c in flash_cases(torch):
        r = run_flash_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "causal_s512_bf16":
            state["flash_main"] = r
        elif name.startswith("bert_"):
            state.setdefault("flash_bert", {})[name] = r
        elif name == "mlm_s128_bf16":
            state["flash_mlm"] = r
        elif name.startswith(MESH_CASE_PREFIXES):
            state.setdefault("flash_mesh", {})[name] = dict(r, shape=case_shape(c))
    return ok


# --------------------------------------------------------------------------- #
# phase 2: full-width no-cache forward, flash kernel vs plain attention
# --------------------------------------------------------------------------- #

def _model(torch, dtype, attn_impl, seed=0, state_dict=None, layers=None,
           device="cuda", moe=False):
    """``MODEL`` (at ``layers`` blocks when given) on ``device``; with
    ``moe`` every second block's FFN is the default ``MoEConfig``'s (the
    mesh phase's MoE LM)."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_weights,
    )

    cfg = TransformerConfig(dtype=dtype, attn_impl=attn_impl,
                            moe_every=2 if moe else 0,
                            **dict(MODEL, n_layers=layers or MODEL["n_layers"]))
    m = TransformerLM(cfg, device=device)
    if state_dict is None:
        init_weights(m, seed)
    else:
        m.load_state_dict(state_dict)
    return m.eval().requires_grad_(False)


def phase_forward(torch, state):
    from kubeflow_tpu_torch.ops import flash_attention as fa

    m_flash = _model(torch, torch.bfloat16, "flash")
    m_ref = _model(torch, torch.bfloat16, "reference",
                   state_dict=m_flash.state_dict())
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(2, MODEL["vocab_size"], (8, 128), generator=g, device="cuda")
    with torch.inference_mode():
        ref = m_ref(tokens)
        fa.LAUNCHES = 0
        out = m_flash(tokens)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES
    finite = bool(torch.isfinite(out).all())
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    tol = 5e-2
    state["flash_launches"] = launches
    ok = finite and rel <= tol and launches == MODEL["n_layers"]
    emit({"phase": "forward", "shape": list(tokens.shape), "dtype": "bf16",
          "logits_rel_err": rel, "tol": tol, "top1_agreement": top1,
          "finite": finite, "flash_launches": launches, "ok": ok})
    del m_flash, m_ref
    return ok


# --------------------------------------------------------------------------- #
# phases 3-4: the served engine
# --------------------------------------------------------------------------- #

def sharpened_state(torch, dtype, layers=None, device="cuda", moe=False):
    """Random weights from a seed with the unembed tied to the embedding
    and the residual branches tempered (bench.py's paged-attention model):
    a fully random head has near-tied logits, so any rounding would flip
    a greedy argmax; this keeps margins a trained LM would have. ``moe``:
    the MoE LM's, its experts' down projections tempered as the MLP's."""
    m = _model(torch, dtype, "flash", seed=0, layers=layers, device=device,
               moe=moe)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    del m
    sd["unembed.weight"] = sd["embed.embedding"].clone()
    for k in sd:
        if "o_proj" in k:
            sd[k] *= 0.5
        elif "down_proj" in k or "experts.down_kernel" in k:
            sd[k] *= 0.1
    return sd


def prompts():
    import numpy as np

    rng = np.random.default_rng(0)
    return [
        [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=int(n))]
        for n in rng.integers(8, 28, size=N_REQ)
    ]


def motif_prompts(rng):
    """``N_REQ`` prompts of 16 + i tokens that repeat an 8-token motif
    (the drafter matches them), drawn from ``rng``."""
    out = []
    for i in range(N_REQ):
        motif = [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=8)]
        out.append((motif * 4)[: 16 + i])
    return out


def _concurrent(fn, args):
    outs = [None] * len(args)
    errs = []

    def work(i):
        try:
            outs[i] = fn(args[i])
        except Exception as e:  # noqa: BLE001 — reported by the phase
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs:
        raise errs[0]
    return outs


def _engine_streams(torch, model, impl, reqs, **kw):
    from kubeflow_tpu_torch.serve.engine import LMEngine

    eng = LMEngine(model, **{**ENGINE, "paged_attn_impl": impl, **kw}).start()
    try:
        return _concurrent(lambda p: eng.submit(p, max_new_tokens=MAX_NEW), reqs)
    finally:
        eng.stop()


def _post(base, name, ids):
    body = json.dumps({"input_ids": ids, "max_new_tokens": MAX_NEW}).encode()
    r = urllib.request.Request(f"{base}/v2/models/{name}/generate", data=body,
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=300) as resp:
        return json.loads(resp.read())["token_ids"]


def _served_burst(base, lm, reqs):
    """The 8 requests at once through the server to ``lm``: streams, wall
    seconds, and the engine's chunks, carry uploads and pipeline EWMAs of
    this burst alone (the EWMAs restart cold before it)."""
    eng = lm.engine
    for k in ("decode_gap_ms", "d2h_drain_ms"):
        eng.overlap[k] = 0.0
    chunks0, uploads0 = eng.stats["chunks"], eng.overlap["carry_uploads"]
    eng.ttft_ms.clear()
    t0 = time.perf_counter()
    outs = _concurrent(lambda ids: _post(base, lm.name, ids), reqs)
    wall = time.perf_counter() - t0
    ttft = sorted(eng.ttft_ms)
    n_tok = sum(len(o) for o in outs)
    return outs, {
        "pipeline_depth": eng.pipeline_depth, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": ttft[len(ttft) // 2] if ttft else None,
        "ttft_ms_max": ttft[-1] if ttft else None,
        "chunks": eng.stats["chunks"] - chunks0,
        "carry_uploads": eng.overlap["carry_uploads"] - uploads0,
        "decode_gap_ms": eng.overlap["decode_gap_ms"],
        "d2h_drain_ms": eng.overlap["d2h_drain_ms"],
    }


def _spread(values):
    """Median and spread (max - min) of a depth's bursts."""
    return {"median": statistics.median(values), "spread": max(values) - min(values),
            "values": values}


def phase_serving(torch, state):
    """The burst through ``ModelServer`` on the pipelined engine (``lm``,
    ``pipeline_depth=1``: the main path, whose kernel launches are
    counted) and on the synchronous one (``lm0``, depth 0, the same
    weights), in turns: depth 1, 0, 1, 0, 1, 0. Each depth's tokens/s,
    TTFT and decode gap are reported as the median over its three bursts
    with their spread."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    sd = sharpened_state(torch, torch.bfloat16)
    models = {depth: LMEngineModel(
        name, config=cfg, state_dict=sd, device="cuda", max_new_tokens=MAX_NEW,
        paged_attn_impl="kernel", pipeline_depth=depth, **ENGINE,
    ) for depth, name in ((1, "lm"), (0, "lm0"))}
    server = ModelServer(list(models.values()), http_port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    reqs = prompts()
    runs = []
    try:
        with urllib.request.urlopen(f"{base}/v2/health/ready", timeout=30) as r:
            ready = r.status == 200 and json.loads(r.read())["ready"]
        for lm in models.values():  # warm-up: cuBLAS handles, allocator, kernels
            _post(base, lm.name, reqs[0][:8])
        torch.cuda.synchronize()
        _zero_paged(pa)
        fa.LAUNCHES = 0
        outs, main = _served_burst(base, models[1], reqs)
        paged_launches, by_s, by_body = _paged_counts(pa)
        flash_launches = fa.LAUNCHES
        runs.append(main)
        streams = {1: outs}
        for depth in (0, 1, 0, 1, 0):
            outs, r = _served_burst(base, models[depth], reqs)
            streams.setdefault(depth, outs)
            runs.append(r)
        # the same weights through the gather read path, in process
        gather = _engine_streams(torch, models[1].engine.model, "gather", reqs)
    finally:
        server.stop()
    outs = streams[1]
    well_formed = all(
        1 <= len(o) <= MAX_NEW and all(0 <= t < MODEL["vocab_size"] for t in o)
        for s in streams.values() for o in s
    )
    first_agree = sum(o[:1] == g[:1] for o, g in zip(outs, gather))
    match = sum(
        a == b for o, g in zip(outs, gather) for a, b in zip(o, g)
    ) / max(1, sum(max(len(o), len(g)) for o, g in zip(outs, gather)))
    state["paged_launches"] = paged_launches
    state["paged_launches_by_s"] = by_s
    state["paged_launches_by_body"] = by_body
    # decode steps (S=1) on the decode body, prefill pieces (S=32) on mma
    bodies = (set(by_s) == {1, 32} and by_body["decode"] == by_s[1] > 0
              and by_body["mma"] == by_s[32] > 0)
    ok = (ready and well_formed and paged_launches > 0 and bodies
          and first_agree >= N_REQ - 1)
    by_depth = {
        depth: {key: _spread([r[key] for r in runs if r["pipeline_depth"] == depth])
                for key in ("tokens_per_s", "ttft_ms_p50", "decode_gap_ms",
                            "d2h_drain_ms")}
        for depth in (1, 0)
    }
    emit({"phase": "serving", "dtype": "bf16", "requests": N_REQ,
          "tokens": main["tokens"], "pipeline_depth": 1,
          "turns": [r["pipeline_depth"] for r in runs], "by_depth": by_depth,
          "runs": runs, "depth0_equals_depth1": streams[0] == streams[1],
          "paged_launches": paged_launches, "paged_launches_by_s": by_s,
          "paged_launches_by_body": by_body, "bodies_by_rule": bodies,
          "flash_launches": flash_launches,
          "ready": ready, "well_formed": well_formed,
          "first_token_agree_vs_gather": first_agree,
          "token_match_vs_gather": match, "card": state["card"], "ok": ok})
    return ok


def phase_parity(torch, state):
    from kubeflow_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(torch, torch.float32, "flash",
                   state_dict=sharpened_state(torch, torch.float32))
    reqs = prompts()
    pa.LAUNCHES = 0
    kern = _engine_streams(torch, model, "kernel", reqs)
    launches = pa.LAUNCHES
    gath = _engine_streams(torch, model, "gather", reqs)
    diverged = [i for i, (a, b) in enumerate(zip(kern, gath)) if a != b]
    ok = not diverged and launches > 0
    emit({"phase": "parity", "dtype": "f32", "requests": N_REQ,
          "tokens": sum(len(s) for s in kern), "identical": not diverged,
          "diverged_rows": diverged, "kernel_launches": launches, "ok": ok})
    return ok


# --------------------------------------------------------------------------- #
# phase 5: the engine loop's features, f32 on the kernel read path
# --------------------------------------------------------------------------- #

def _greedy_margin(torch, model, ids, want, got):
    """First position where two greedy streams of ``ids`` part, and the
    top-2 logit margin there in a no-cache forward of the prompt plus
    the tokens both agree on (a near-tie explains a flip; a wide margin
    is a bug)."""
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    with torch.inference_mode():
        logits = model(torch.tensor([ids + want[:i]], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return {"position": i, "top2_margin": (top[0] - top[1]).item()}


def _compare_greedy(torch, model, reqs, want, got):
    """(identical, the margins of the rows that diverge)."""
    bad = [dict(row=r, **_greedy_margin(torch, model, reqs[r], want[r], got[r]))
           for r in range(len(reqs)) if want[r] != got[r]]
    return not bad, bad


def phase_engine(torch, state):
    """The engine features of the pipelined loop, in f32 with TF32 off at
    full width on the kernel read path (the sharpened weights). Each check
    gates the phase; a greedy divergence prints the top-2 logit margin at
    the first divergent position."""
    import numpy as np

    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.engine import LMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(torch, torch.float32, "flash",
                   state_dict=sharpened_state(torch, torch.float32))
    base = dict(ENGINE, paged_attn_impl="kernel")
    out = {"phase": "engine", "dtype": "f32", "tf32": False, "card": state["card"]}

    def run(kw, reqs, warm=(), overlap=None, model=model):
        eng = LMEngine(model, **kw).start()
        try:
            for p in warm:  # sequential first: e.g. a prefix to store
                eng.submit(p, max_new_tokens=MAX_NEW)
            outs = _concurrent(lambda p: eng.submit(p, max_new_tokens=MAX_NEW), reqs)
            if overlap is not None:
                overlap.update(eng.overlap)
            return outs, dict(eng.stats)
        finally:
            eng.stop()

    # (a) the pipelined loop against the synchronous one
    reqs = prompts()
    d1, s1 = run(dict(base, pipeline_depth=1), reqs)
    d0, _ = run(dict(base, pipeline_depth=0), reqs)
    same, bad = _compare_greedy(torch, model, reqs, d0, d1)
    out["a_depth1_vs_depth0"] = {"identical": same, "diverged": bad,
                                 "tokens": sum(map(len, d1)), "chunks": s1["chunks"]}

    # (b) speculative decoding on prompts that repeat an 8-token motif
    rng = np.random.default_rng(3)
    motif_reqs = motif_prompts(rng)
    _zero_paged(pa)
    k4, sk = run(dict(base, spec_draft_tokens=SPEC_K, spec_ngram=3), motif_reqs)
    _, by_s, by_body = _paged_counts(pa)
    k0, s0 = run(base, motif_reqs)
    same_b, bad_b = _compare_greedy(torch, model, motif_reqs, k0, k4)
    out["b_spec_k4_vs_k0"] = {
        "identical": same_b, "diverged": bad_b, "tokens": sum(map(len, k4)),
        "spec_proposed": sk["spec_proposed"], "spec_accepted": sk["spec_accepted"],
        "chunks_k4": sk["chunks"], "chunks_k0": s0["chunks"],
        "paged_launches_by_s": by_s, "paged_launches_by_body": by_body}

    # (b16) the same speculative traffic on the bf16 model: its verifies
    # (S=5) take the tensor-core body, its decode steps the decode body;
    # K=4 against K=0 judged by near ties
    m16 = _model(torch, torch.bfloat16, "flash",
                 state_dict=sharpened_state(torch, torch.bfloat16))
    _zero_paged(pa)
    h4, sh = run(dict(base, spec_draft_tokens=SPEC_K, spec_ngram=3), motif_reqs,
                 model=m16)
    _, by_s16, by_body16 = _paged_counts(pa)
    h0, _ = run(base, motif_reqs, model=m16)
    ok16, bad16 = _judged(torch, m16, motif_reqs, h0, h4)
    del m16
    rule16 = _bodies_follow_rule(pa, by_s16, by_body16, torch.bfloat16)
    out["b16_spec_k4_vs_k0_bf16"] = {
        "identical": h4 == h0, "judged_equal": ok16, "diverged": bad16,
        "spec_accepted": sh["spec_accepted"], "paged_launches_by_s": by_s16,
        "paged_launches_by_body": by_body16, "bodies_by_rule": rule16}

    # (c) chunked prefill + prefix cache against neither; the first prompt
    # (70 tokens) stores the 64-token shared prefix, the rest follow
    shared = [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=64)]
    pre_reqs = []
    for n in (70, 40, 100, 66, 88, 52, 95, 77):
        tail = [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=n)]
        pre_reqs.append((shared + tail)[:n])
    kw_c = dict(base, prefill_buckets=(32, 128), max_seq=192,
                kv_pool_tokens=48 * 32)
    on, sc = run(dict(kw_c, prefill_chunk=32, prefix_cache_entries=8),
                 pre_reqs[1:], warm=pre_reqs[:1])
    off, _ = run(kw_c, pre_reqs[1:], warm=pre_reqs[:1])
    same_c, bad_c = _compare_greedy(torch, model, pre_reqs[1:], off, on)
    out["c_chunked_prefix_vs_plain"] = {
        "identical": same_c, "diverged": bad_c, "requests": len(pre_reqs),
        "prefix_hits": sc["prefix_hits"],
        "prefix_tokens_reused": sc["prefix_tokens_reused"],
        "prefill_pieces": sc["prefill_pieces"]}

    # (c8) the same traffic on an int8 pool: the prefill pieces measure
    # the quantization error (the EWMA of mean-abs error over magnitude)
    ov8 = {}
    q8, s8 = run(dict(kw_c, prefill_chunk=32, prefix_cache_entries=8,
                      kv_quant="int8"), pre_reqs[1:], warm=pre_reqs[:1],
                 overlap=ov8)
    qerr = ov8.get("kv_quant_error")
    out["c8_int8_kv_quant_error"] = {
        "kv_quant_error": qerr, "bound": 0.05,
        "prefill_pieces": s8["prefill_pieces"], "prefix_hits": s8["prefix_hits"],
        "token_match_vs_f32_pool": sum(
            a == b for o, g in zip(q8, on) for a, b in zip(o, g))
        / max(1, sum(max(len(o), len(g)) for o, g in zip(q8, on)))}

    # (d) seeded sampling: repeatable, resumable, seed-dependent (a resumed
    # prompt carries half a stream, so it takes the 128 bucket)
    eng = LMEngine(model, **dict(base, prefill_buckets=(32, 128))).start()
    try:
        ids, samp = reqs[0], dict(max_new_tokens=MAX_NEW, temperature=0.9)
        first = eng.submit(ids, seed=1234, **samp)
        again = eng.submit(ids, seed=1234, **samp)
        cut = len(first) // 2
        rest = eng.submit(ids, seed=1234, resume_tokens=first[:cut], **samp)
        other = eng.submit(ids, seed=4321, **samp)
    finally:
        eng.stop()
    out["d_seeded"] = {"tokens": len(first), "repeat_identical": again == first,
                       "resume_identical": rest == first[cut:], "cut": cut,
                       "other_seed_differs": other != first}
    checks = {
        "a": same,
        "b": same_b and sk["spec_accepted"] > 0 and by_s.get(5, 0) > 0,
        "b16": (ok16 and sh["spec_accepted"] > 0 and by_s16.get(5, 0) > 0 and rule16
                and by_body16["mma"] >= by_s16[5]),
        "c": same_c and sc["prefix_hits"] > 0 and sc["prefill_pieces"] > len(pre_reqs),
        "c8": qerr is not None and math.isfinite(qerr) and 0 < qerr < 0.05,
        "d": (len(first) >= 4 and again == first and rest == first[cut:]
              and other != first),
    }
    state["verify_launches"] = by_s.get(5, 0)
    state["verify_launches_bf16_by_body"] = {"S5": by_s16.get(5, 0), **by_body16}
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit(out)
    del model
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 6: the replica's request contract over HTTP
# --------------------------------------------------------------------------- #

def _http(base, method, path, body=None, headers=None):
    """``(status, headers, body text)`` of one request; errors included."""
    data = None if body is None else json.dumps(body).encode()
    r = urllib.request.Request(f"{base}{path}", data=data, method=method,
                               headers={"Content-Type": "application/json",
                                        **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


class _SSE:
    """A ``generate_stream`` client that reads one frame at a time, with
    the client-side time to its first frame."""

    def __init__(self, port, name, ids, headers=None):
        import http.client

        self.t0 = time.perf_counter()
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        self.conn.request("POST", f"/v2/models/{name}/generate_stream",
                          json.dumps({"input_ids": ids, "max_new_tokens": MAX_NEW}),
                          {"Content-Type": "application/json", **(headers or {})})
        self.resp = self.conn.getresponse()
        self.status = self.resp.status
        self.ttft_ms = None

    def frame(self):
        while True:
            line = self.resp.readline().decode()
            if not line:
                return None
            if line.startswith("data: "):
                if self.ttft_ms is None:
                    self.ttft_ms = (time.perf_counter() - self.t0) * 1e3
                return json.loads(line[len("data: "):])

    def read_all(self):
        """(tokens, the last frame)."""
        toks = []
        while True:
            f = self.frame()
            if f is None or "token_ids" not in f:
                self.conn.close()
                return toks, f
            toks += f["token_ids"]


def _sse_tokens(port, name, ids, headers=None):
    s = _SSE(port, name, ids, headers)
    if s.status != 200:
        raise RuntimeError(f"generate_stream answered {s.status}")
    toks, last = s.read_all()
    return toks, last, s.ttft_ms


def _wedge_hook(entered, release):
    """A one-shot ``pre_chunk`` hook: the scheduler blocks on ``release``."""

    def hook(eng):
        entered.set()
        release.wait(120)
        eng._fault_hooks.pop("pre_chunk", None)

    return hook


def phase_contract(torch, state):
    """The replica's request contract over HTTP, on the bf16 full-width
    model on the paged kernel through one ``ModelServer``
    (``default_deadline_ms=60000``): (1) warmup before ready; (2) three
    bursts of the 8 prompts over ``generate_stream``, token-identical to
    ``generate``, the paged launches counted; (3) expired deadlines and a
    client's foreign absolute stamp; (4) an unmeetable deadline shed on
    the warm EWMA; (5) priority eviction with the engine wedged; (6) the
    watchdog restarting a second model wedged mid-stream, the stream
    resumed; (7) ``/metrics``."""
    import gc

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    sd = sharpened_state(torch, torch.bfloat16)
    # the model's in-flight cap equals the engine's capacity (max_batch +
    # max_queue), so a small queue lets step 5 fill it
    common = dict(config=cfg, state_dict=sd, device="cuda", max_new_tokens=MAX_NEW,
                  paged_attn_impl="kernel", max_queue=2, **ENGINE)
    lm = LMEngineModel("lm", **common)
    lm_wd = LMEngineModel("lm_wd", watchdog_min_wedge_s=1.0,
                          watchdog_interval_s=0.1, **common)
    out = {"phase": "contract", "dtype": "bf16", "card": state["card"]}
    checks = {}
    served = {"lm": 0, "lm_wd": 0}  # requests the server should count

    # (1) warmup in load(), before the model reports ready
    t0 = time.perf_counter()
    server = ModelServer([lm, lm_wd], http_port=0,
                         default_deadline_ms=60000.0).start()
    load_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{server.port}"
    try:
        rep = lm.warmup_report
        zero = (all(v == 0 for v in lm.engine.stats.values())
                and all(v == 0 for v in lm.engine.overlap.values()))
        out["1_warmup"] = {**rep, "load_both_s": load_s, "stats_zeroed": zero,
                           "libraries_loaded": sorted(_build._libs)}
        checks["1"] = (rep["libraries"] == ["paged_attention"]
                       and rep["ready"] is False and "paged_attention" in _build._libs
                       and zero and lm.ready and lm_wd.ready)

        # (2) the burst over SSE, three times; generate on the same prompts
        reqs = prompts()
        _zero_paged(pa)
        bursts = []
        for _ in range(3):
            res = _concurrent(lambda ids: _sse_tokens(server.port, "lm", ids), reqs)
            served["lm"] += len(reqs)
            bursts.append(res)
        launches, by_s, by_body = _paged_counts(pa)
        state["contract_paged_launches"] = launches
        state["contract_paged_launches_by_body"] = by_body
        gen = _concurrent(lambda ids: _post(base, "lm", ids), reqs)
        served["lm"] += len(reqs)
        streams = [[t for t, _, _ in b] for b in bursts]
        ttft = [statistics.median(ms for _, _, ms in b) for b in bursts]
        done_ok = all(last == {"done": True, "n_tokens": len(t)}
                      for b in bursts for t, last, _ in b)
        out["2_sse"] = {
            "requests": len(reqs), "bursts": 3, "tokens": sum(map(len, streams[0])),
            "ttft_ms_median": statistics.median(ttft), "ttft_ms_spread": max(ttft) - min(ttft),
            "ttft_ms_by_burst": ttft, "paged_launches": launches,
            "paged_launches_by_s": by_s, "paged_launches_by_body": by_body,
            "sse_equals_generate": all(s == gen for s in streams),
            "rows_differing": [i for i in range(len(reqs)) if streams[0][i] != gen[i]],
            "done_frames": done_ok}
        checks["2"] = all(s == gen for s in streams) and launches > 0 and done_ok

        # (3) deadlines
        d0 = {route: _http(base, "POST", f"/v2/models/lm/{route}",
                           {"input_ids": reqs[0]}, {"x-kft-deadline-ms": "0"})
              for route in ("generate", "generate_stream")}
        foreign = _http(base, "POST", "/v2/models/lm/generate",
                        {"input_ids": reqs[0], "max_new_tokens": MAX_NEW},
                        {"x-kft-deadline-ms": "30000", "x-kft-deadline-abs": "1.0"})
        served["lm"] += foreign[0] == 200
        out["3_deadlines"] = {
            **{f"deadline_0_{r}": [v[0], v[1].get("Retry-After")] for r, v in d0.items()},
            "foreign_abs_stamp": foreign[0],
            "foreign_abs_tokens_equal": foreign[0] == 200
            and json.loads(foreign[2])["token_ids"] == gen[0]}
        checks["3"] = (all((v[0], v[1].get("Retry-After")) == (503, "1")
                           for v in d0.values())
                       and out["3_deadlines"]["foreign_abs_tokens_equal"])

        # (4) an unmeetable deadline: half of the warm estimate
        eng = lm.engine
        est = eng.estimate_admission(MAX_NEW)
        budget_ms = (est[0] + est[1]) * 1e3 / 2 if est else None
        shed = _http(base, "POST", "/v2/models/lm/generate", {"input_ids": reqs[0]},
                     {"x-kft-deadline-ms": f"{budget_ms:.3f}"}) if est else (0, {}, "")
        out["4_shed"] = {"decode_gap_ms": eng.overlap["decode_gap_ms"],
                         "estimate_s": est, "budget_ms": budget_ms,
                         "status": shed[0], "retry_after": shed[1].get("Retry-After"),
                         "shed_deadline": eng.stats["shed_deadline"]}
        checks["4"] = (shed[0] == 503 and int(shed[1].get("Retry-After", "0")) >= 1
                       and eng.stats["shed_deadline"] == 1)

        # (5) priority: the rows held by direct engine clients (priority 1)
        # and wedged, priority 0 and 1 queued over HTTP, then a priority-3
        # newcomer over HTTP evicts the priority-0 one
        entered, release = threading.Event(), threading.Event()
        eng._fault_hooks["pre_chunk"] = _wedge_hook(entered, release)
        results = {}

        def direct(i):
            results[f"row{i}"] = eng.submit(reqs[i], max_new_tokens=MAX_NEW, priority=1)

        def http_call(key, i, prio):
            results[key] = _http(base, "POST", "/v2/models/lm/generate",
                                 {"input_ids": reqs[i]}, {"x-kft-priority": str(prio)})

        cap = eng.max_batch + eng.max_queue
        threads = [threading.Thread(target=direct, args=(i,)) for i in range(eng.max_batch)]
        try:
            for t in threads:
                t.start()
            if not entered.wait(60):
                raise RuntimeError("the engine never reached the wedge")
            for key, i, prio in (("p0", 0, 0), ("p1", 1, 1)):
                th = threading.Thread(target=http_call, args=(key, i, prio))
                th.start()
                threads.append(th)
            t_fill = time.monotonic() + 60
            while (eng._pending.qsize() + sum(s is not None for s in eng._slots)
                   < cap and time.monotonic() < t_fill):
                time.sleep(0.005)
            filled = eng._pending.qsize() + sum(s is not None for s in eng._slots)
            th = threading.Thread(target=http_call, args=("p3", 2, 3))
            th.start()
            threads.append(th)
            t_evict = time.monotonic() + 60
            while "p0" not in results and time.monotonic() < t_evict:
                time.sleep(0.005)
            shed_priority = eng.stats["shed_priority"]
        finally:
            release.set()
            for t in threads:
                t.join(300)
        p0, p1, p3 = results.get("p0"), results.get("p1"), results.get("p3")
        served["lm"] += (p1 is not None and p1[0] == 200) + (p3 is not None and p3[0] == 200)
        out["5_priority"] = {
            "capacity": cap, "filled": filled,
            "p0": [p0[0], p0[1].get("Retry-After")] if p0 else None,
            "p1": p1[0] if p1 else None, "p3": p3[0] if p3 else None,
            "rows_served": sum(bool(results.get(f"row{i}")) for i in range(eng.max_batch)),
            "shed_priority": shed_priority}
        checks["5"] = (filled == cap and p0 is not None and p0[0] == 503
                       and int(p0[1].get("Retry-After", "0")) >= 1
                       and p1 and p1[0] == 200 and p3 and p3[0] == 200
                       and shed_priority == 1
                       and out["5_priority"]["rows_served"] == eng.max_batch)

        # (6) the watchdog: lm_wd wedged after its stream's first frame
        ids = reqs[3]
        want = _post(base, "lm_wd", ids)
        served["lm_wd"] += 1
        gc.collect()  # so that only the old pool is left to free below
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        old = lm_wd.engine
        entered, release = threading.Event(), threading.Event()
        old._fault_hooks["pre_chunk"] = _wedge_hook(entered, release)
        t_wedge = time.perf_counter()
        s = _SSE(server.port, "lm_wd", ids)
        first = s.frame()
        committed = first["token_ids"]
        end = s.frame()  # the watchdog trips, the stream ends resumable
        trip_s = time.perf_counter() - t_wedge
        s.conn.close()
        served["lm_wd"] += 1
        t_ready = time.monotonic() + 60
        while not lm_wd.ready and time.monotonic() < t_ready:
            time.sleep(0.01)  # the rebuild lands right after the poison
        mem_both = torch.cuda.memory_allocated()
        rest, last, _ = _sse_tokens(server.port, "lm_wd", ids,
                                    {"x-kft-resume-tokens": ",".join(map(str, committed))})
        served["lm_wd"] += 1
        wd = lm_wd.watchdog.stats
        new_engine = lm_wd.engine is not old
        release.set()
        old_thread = old._thread
        old_thread.join(120)
        del old, s
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        pool_bytes = sum(t.numel() * t.element_size()
                         for lc in lm_wd.engine.cache.values() for t in lc.values())
        out["6_watchdog"] = {
            "trip_s": trip_s, "end_frame": end, "committed": len(committed),
            "resumed": len(rest), "resume_equals_uninterrupted": committed + rest == want,
            "trips": wd["trips"], "restarts": wd["restarts"], "ready": lm_wd.ready,
            "new_engine": new_engine, "old_thread_exited": not old_thread.is_alive(),
            "pool_bytes": pool_bytes, "allocated_before": mem0,
            "allocated_both_pools": mem_both, "allocated_after_old_exit": mem1}
        checks["6"] = (end is not None and end.get("resumable") is True
                       and committed + rest == want and last.get("done") is True
                       and wd["trips"] == {"wedged": 1} and wd["restarts"] == 1
                       and lm_wd.ready and new_engine and not old_thread.is_alive()
                       and mem1 <= mem0 + pool_bytes // 2)

        # (7) /metrics
        status, _, text = _http(base, "GET", "/metrics")
        values = {}
        for ln in text.splitlines():
            if ln and not ln.startswith("#"):
                series, v = ln.rsplit(" ", 1)
                values[series] = float(v)
        names = ["kubeflow_tpu_requests_total", "kubeflow_tpu_latency_p50_ms",
                 "kubeflow_tpu_latency_p99_ms", "kft_server_inflight",
                 "kubeflow_tpu_engine_admitted", "kubeflow_tpu_engine_active_rows",
                 "kft_engine_decode_gap_ms", "kft_engine_d2h_drain_ms",
                 "kft_engine_carry_uploads_total", "kft_engine_slot_occupancy",
                 "kft_engine_spec_acceptance", "kft_engine_spec_proposed_total",
                 "kft_engine_spec_accepted_total", "kft_engine_prefix_hits_total",
                 "kft_engine_prefix_tokens_reused_total", "kft_engine_prefix_entries",
                 "kft_engine_prefix_tokens_stored", "kubeflow_tpu_engine_kv_pages_used",
                 "kft_engine_paged_attn_kernel", "kft_engine_watchdog_trips_total",
                 "kft_engine_restarts_total", "kft_server_ttft_ms_bucket",
                 "kft_server_tpot_ms_bucket"]
        missing = [n for n in names if not any(k.startswith(n + "{") for k in values)]
        want_counts = {
            'kubeflow_tpu_requests_total{model="lm"}': served["lm"],
            'kubeflow_tpu_requests_total{model="lm_wd"}': served["lm_wd"],
            'kubeflow_tpu_engine_shed_deadline{model="lm"}': 1,
            'kubeflow_tpu_engine_shed_priority{model="lm"}': 1,
            'kft_engine_watchdog_trips_total{model="lm_wd",reason="wedged"}': 1,
            'kft_engine_restarts_total{model="lm_wd"}': 1,
            'kft_engine_paged_attn_kernel{model="lm"}': 1,
        }
        got_counts = {k: values.get(k) for k in want_counts}
        out["7_metrics"] = {"status": status, "lines": len(values), "missing": missing,
                            "counts": got_counts, "wanted": want_counts}
        checks["7"] = status == 200 and not missing and got_counts == want_counts
    finally:
        server.stop()
    out["checks"] = checks
    out["ok"] = all(checks.values()) and len(checks) == 7
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 7: KV movement between replicas
# --------------------------------------------------------------------------- #

#: a bf16 greedy divergence counts as a near tie when the top-2 logit
#: margin at its first position is below this: two bf16 ulps of a logit
#: of magnitude 16-32, the rounding that two summation orders can differ
#: by after 12 bf16 layers
NEAR_TIE = 0.25
PEER_HEADER, SESSION_HEADER = "x-kft-prefill-peer", "x-kft-session"


def _judged(torch, model, reqs, want, got):
    """bf16 streams: identical, or each divergence a near tie."""
    same, bad = _compare_greedy(torch, model, reqs, want, got)
    return same or all(b["top2_margin"] < NEAR_TIE for b in bad), bad


def _gen(port, ids, headers=None, max_new=MAX_NEW):
    status, _, text = _http(f"http://127.0.0.1:{port}", "POST",
                            "/v2/models/lm/generate",
                            {"input_ids": ids, "max_new_tokens": max_new}, headers)
    if status != 200:
        raise RuntimeError(f"generate answered {status}: {text[:200]}")
    return json.loads(text)["token_ids"]


def _scrape(port):
    _, _, text = _http(f"http://127.0.0.1:{port}", "GET", "/metrics")
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            series, v = ln.rsplit(" ", 1)
            out[series] = float(v)
    return out


def _wire(tree, meta, ids):
    """A span through the port's codec, as a decode replica receives it."""
    from kubeflow_tpu_torch.serve.kv_codec import decode_kv_entries, encode_kv_entries

    blob = encode_kv_entries([(tuple(ids), tree)], meta)
    entries, got_meta = decode_kv_entries(blob)
    return entries[0][1], got_meta, len(blob)


def _engine_pair(torch, model, reqs, kw):
    """Prefill spans on one engine, shipped through the codec, decoded on
    a second; a third engine serves colocated. Returns the colocated and
    the disaggregated streams, the decode and prefill stats and the blob
    bytes of each span."""
    from kubeflow_tpu_torch.serve.engine import LMEngine

    pre, dec, colo = (LMEngine(model, **kw).start() for _ in range(3))
    try:
        want = _concurrent(lambda p: colo.submit(p, max_new_tokens=MAX_NEW), reqs)
        shipped = _concurrent(lambda p: _wire(*pre.prefill_span(p), p), reqs)
        spans = [dec.prepare_kv_span(p, t, m) for p, (t, m, _) in zip(reqs, shipped)]
        got = _concurrent(lambda i: dec.submit(reqs[i], max_new_tokens=MAX_NEW,
                                               kv_span=spans[i]), list(range(len(reqs))))
        planes = sorted(shipped[0][0]["layers_0"])
        return (want, got, dict(dec.stats), dict(pre.stats),
                [b for _, _, b in shipped], planes)
    finally:
        for e in (pre, dec, colo):
            e.stop()


def _trace_spans(ports, trace_id, timeout_s=30.0):
    """The finished trace's spans from ``/debug/traces`` of every port,
    merged by span id (a trace is served once its last span ended)."""
    t_end = time.monotonic() + timeout_s
    while True:
        spans = {}
        for p in ports:
            _, _, text = _http(f"http://127.0.0.1:{p}", "GET", "/debug/traces?limit=256")
            for tr in json.loads(text)["traces"]:
                if tr["trace_id"] == trace_id:
                    spans.update({s["span_id"]: s for s in tr["spans"]})
        if spans or time.monotonic() > t_end:
            return sorted(spans.values(), key=lambda s: s["start_ms"])
        time.sleep(0.05)


def _trace_rows(spans):
    """(name, parent's name, status, ms) of each span, by start."""
    names = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], names.get(s["parent_span_id"]), s["status"],
             s["end_ms"] - s["start_ms"]) for s in spans]


def phase_disagg(torch, state):
    """KV movement between replicas on the full-width model, bf16 on the
    paged kernel unless named: (a) a prefill and a decode replica, the
    8-prompt burst sent to the decode replica over ``generate`` and three
    times over ``generate_stream`` with ``x-kft-prefill-peer``, against a
    colocated replica (TTFT to the first SSE frame, in turns); then the
    same on an f32 engine pair through the codec (exact); (b) int8 pools
    on both sides; (c) a prefix-cache pull from replica A to replica B;
    (d) three sessions of two turns through a host tier that holds two
    sessions' spans; (e) a dropped ship and a dead peer. Prints span
    bytes predicted and measured, ship times, paged launches by span S
    (the prefill replica runs S=32 only, the decode replica S=1), and one
    traced request's ``kv.ship`` span split into the prefill replica's
    ``engine``, ``queue.wait`` and ``prefill`` spans and the rest (the
    wire, the codec and the implant's checks; ``kv_span:prefill`` opens
    no dataplane span, as in the reference)."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve import engine as teng
    from kubeflow_tpu_torch.serve.server import ModelServer

    t_phase = time.perf_counter()
    hd = MODEL["d_model"] // MODEL["n_heads"]
    per_tok = MODEL["n_layers"] * 2 * MODEL["n_heads"] * hd * 2       # bf16 K, V
    per_tok8 = MODEL["n_layers"] * 2 * MODEL["n_heads"] * (hd + 4)   # int8 + f32 scale
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    sd = sharpened_state(torch, torch.bfloat16)
    common = dict(config=cfg, state_dict=sd, device="cuda", max_new_tokens=MAX_NEW,
                  paged_attn_impl="kernel", pipeline_depth=1, **ENGINE)
    long_kw = dict(common, prefill_buckets=(32, 128), max_seq=192)
    # two turn-1 session spans of 64 tokens fit, three do not (d)
    tier_bytes = int(2.9 * 64 * per_tok)
    roles = {"colo": ("both", common), "pre": ("prefill", common),
             "dec": ("decode", common),
             "a": ("both", dict(long_kw, prefix_cache_entries=8)),
             "b": ("both", dict(long_kw, prefix_cache_entries=8)),
             "tier": ("both", dict(long_kw, host_kv_bytes=tier_bytes))}
    srv = {}
    out = {"phase": "disagg", "dtype": "bf16", "card": state["card"]}
    checks = {}
    try:
        for key, (role, kw) in roles.items():
            srv[key] = ModelServer([teng.LMEngineModel("lm", **kw)], http_port=0,
                                   role=role).start()
        port = {k: s.port for k, s in srv.items()}
        eng = {k: s.models["lm"].engine for k, s in srv.items()}
        model = eng["colo"].model
        peer_url = f"http://127.0.0.1:{port['pre']}"
        peer = {PEER_HEADER: peer_url}
        ready = {k: json.loads(_http(f"http://127.0.0.1:{p}", "GET",
                                     "/v2/health/ready")[2]) for k, p in port.items()}
        reqs = prompts()

        # (a) the burst, disaggregated against colocated
        want = _concurrent(lambda ids: _gen(port["colo"], ids), reqs)
        _gen(port["dec"], reqs[0], peer)  # warm: the ship path once
        d0, p0 = dict(eng["dec"].stats), dict(eng["pre"].stats)
        m0 = _scrape(port["dec"])
        _zero_paged(pa)
        got = _concurrent(lambda ids: _gen(port["dec"], ids, peer), reqs)
        launches, by_s, by_body = _paged_counts(pa)
        m1 = _scrape(port["dec"])
        ttft = {"colocated": [], "disaggregated": []}
        streams = []
        for _ in range(3):
            for kind, p, hdr in (("colocated", port["colo"], None),
                                 ("disaggregated", port["dec"], peer)):
                res = _concurrent(lambda ids: _sse_tokens(p, "lm", ids, hdr), reqs)
                ttft[kind].append(statistics.median(ms for _, _, ms in res))
                if kind == "disaggregated":
                    streams.append([t for t, _, _ in res])
        d1, p1 = dict(eng["dec"].stats), dict(eng["pre"].stats)
        dd = {k: d1[k] - d0[k] for k in ("prefill_pieces", "kv_injected",
                                        "kv_ship_fallbacks", "kv_ship_bytes", "chunks")}
        pd = {k: p1[k] - p0[k] for k in ("kv_spans_exported", "chunks",
                                        "prefill_pieces")}
        ok_a, bad_a = _judged(torch, model, reqs, want, got)
        ok_s = all(s == got for s in streams)
        ship_key = 'kft_engine_kv_ship_ms_{}'
        n_ship = m1.get(ship_key.format("count"), 0) - m0.get(ship_key.format("count"), 0)
        ship_mean = ((m1.get(ship_key.format("sum"), 0) - m0.get(ship_key.format("sum"), 0))
                     / n_ship if n_ship else None)
        n16 = [-(-len(p) // 16) * 16 for p in reqs]
        n_bursts = 4
        out["a_disagg_burst"] = {
            "roles": {k: v["role"] for k, v in ready.items()},
            "identical": got == want, "judged_equal": ok_a, "diverged": bad_a,
            "sse_equals_generate": ok_s, "decode_replica": dd, "prefill_replica": pd,
            "paged_launches": launches,
            "paged_launches_by_s": by_s, "paged_launches_by_body": by_body,
            "span_bytes_predicted_burst": sum(n * per_tok for n in n16),
            # four bursts (generate, then SSE three times) shipped
            "span_bytes_measured_burst": dd["kv_ship_bytes"] / n_bursts,
            "kv_ship_ms_mean_burst": ship_mean,
            "client_ttft_ms": {k: _spread(v) for k, v in ttft.items()}}
        checks["a"] = (ok_a and ok_s and dd["prefill_pieces"] == 0
                       and dd["kv_injected"] == N_REQ * n_bursts
                       and dd["kv_ship_fallbacks"] == 0
                       and pd["kv_spans_exported"] == N_REQ * n_bursts
                       and pd["chunks"] == 0 and launches > 0
                       and set(by_s) == {1, 32}
                       and by_s[32] == N_REQ * MODEL["n_layers"]
                       and by_body == {"decode": by_s[1], "mma": by_s[32]}
                       and ready["pre"]["role"] == "prefill"
                       and ready["dec"]["role"] == "decode")
        state["disagg_paged_launches_by_s"] = by_s
        state["disagg_paged_launches_by_body"] = by_body

        # one traced ship: the kv.ship span against the prefill replica's
        # spans under it (one process: one tracer behind both ports)
        from kubeflow_tpu_torch.obs.trace import TRACER, TraceContext

        TRACER.clear()
        TRACER.sample_every = 1
        ctx = TraceContext(f"{zlib.crc32(b'disagg'):08x}" * 4, "cd" * 8)
        traced = _gen(port["dec"], reqs[0], {**peer, "x-kft-trace": ctx.header()})
        spans = _trace_spans([port["dec"], port["pre"]], ctx.trace_id)
        TRACER.sample_every = 16

        def ms(sp):
            return sp["end_ms"] - sp["start_ms"]

        ship_sp = next((sp for sp in spans if sp["name"] == "kv.ship"), None)
        pre_eng = next((sp for sp in spans if ship_sp and sp["name"] == "engine"
                        and sp["parent_span_id"] == ship_sp["span_id"]), None)
        kids = {sp["name"]: ms(sp) for sp in spans
                if pre_eng and sp["parent_span_id"] == pre_eng["span_id"]}
        out["a_ship_trace"] = {
            "trace_id": ctx.trace_id, "tokens_equal": traced == want[0],
            "kv_ship_ms": ms(ship_sp) if ship_sp else None,
            "prefill_replica": {
                "dataplane_ms": None,
                "engine_ms": ms(pre_eng) if pre_eng else None,
                "queue_wait_ms": kids.get("queue.wait"),
                "prefill_ms": kids.get("prefill")},
            "rest_ms": ms(ship_sp) - ms(pre_eng) if ship_sp and pre_eng else None,
            "spans": [[n, p, st, round(v, 3)] for n, p, st, v in _trace_rows(spans)]}
        checks["a_trace"] = (ship_sp is not None and ship_sp["status"] == "ok"
                             and pre_eng is not None
                             and {"queue.wait", "prefill"} <= set(kids)
                             and traced == want[0])

        # span bytes and ship time, one request at a time
        ship = []
        for p in reqs:
            b0 = eng["dec"].stats["kv_ship_bytes"]
            t0 = time.perf_counter()
            span = teng.fetch_kv_span(eng["dec"], peer_url, "lm", p, 0.0)
            ship.append({"tokens": len(p), "n16": -(-len(p) // 16) * 16,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "bytes": eng["dec"].stats["kv_ship_bytes"] - b0,
                         "predicted_bytes": -(-len(p) // 16) * 16 * per_tok,
                         "ok": span is not None})
        out["a_ship_sequential"] = {
            "ms": _spread([s["ms"] for s in ship]), "spans": ship,
            "header_bytes": sorted({s["bytes"] - s["predicted_bytes"] for s in ship})}
        checks["a_ship"] = all(s["ok"] and 0 < s["bytes"] - s["predicted_bytes"] < 16384
                               for s in ship)

        # (e) a dropped ship and a dead peer: local prefill, same tokens
        fired = []

        def drop(e):
            e._fault_hooks.pop("kv_ship", None)
            fired.append(1)
            raise ConnectionResetError("prefill peer died mid-ship")

        f0, pp0 = eng["dec"].stats["kv_ship_fallbacks"], eng["dec"].stats["prefill_pieces"]
        eng["dec"]._fault_hooks["kv_ship"] = drop
        e_hook = _gen(port["dec"], reqs[1], peer)
        f1 = eng["dec"].stats["kv_ship_fallbacks"]
        e_dead = _gen(port["dec"], reqs[2], {PEER_HEADER: "http://127.0.0.1:1"})
        f2 = eng["dec"].stats["kv_ship_fallbacks"]
        ok_e, bad_e = _judged(torch, model, reqs[1:3], want[1:3], [e_hook, e_dead])
        out["e_fallbacks"] = {"hook_fired": len(fired), "fallbacks": [f1 - f0, f2 - f1],
                              "local_prefill_pieces":
                                  eng["dec"].stats["prefill_pieces"] - pp0,
                              "tokens_equal": ok_e, "diverged": bad_e}
        checks["e"] = (fired == [1] and f1 - f0 == 1 and f2 - f1 == 1 and ok_e
                       and eng["dec"].stats["prefill_pieces"] - pp0 == 2)

        # (a, f32) the pair through the codec with TF32 off: exact
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m32 = _model(torch, torch.float32, "flash",
                     state_dict=sharpened_state(torch, torch.float32))
        kw_eng = dict(ENGINE, paged_attn_impl="kernel")
        w32, g32, ds32, ps32, _, _ = _engine_pair(torch, m32, reqs, kw_eng)
        same32, bad32 = _compare_greedy(torch, m32, reqs, w32, g32)
        del m32
        out["a_f32_pair"] = {"identical": same32, "diverged": bad32,
                             "prefill_pieces": ds32["prefill_pieces"],
                             "kv_injected": ds32["kv_injected"],
                             "spans_exported": ps32["kv_spans_exported"]}
        checks["a_f32"] = (same32 and ds32["prefill_pieces"] == 0
                           and ds32["kv_injected"] == N_REQ)

        # (b) int8 pools on both sides: codes and scales on the wire
        w8, g8, ds8, _, bytes8, planes8 = _engine_pair(
            torch, model, reqs, dict(kw_eng, kv_quant="int8"))
        ok_b, bad_b = _judged(torch, model, reqs, w8, g8)
        out["b_int8_pair"] = {
            "identical": w8 == g8, "judged_equal": ok_b, "diverged": bad_b,
            "planes": planes8, "prefill_pieces": ds8["prefill_pieces"],
            "kv_injected": ds8["kv_injected"],
            "span_bytes": bytes8, "predicted_bytes": [n * per_tok8 for n in n16]}
        checks["b"] = (ok_b and ds8["prefill_pieces"] == 0
                       and ds8["kv_injected"] == N_REQ
                       and planes8 == ["k", "k_scale", "v", "v_scale"]
                       and all(0 < b - n * per_tok8 < 16384
                               for b, n in zip(bytes8, n16)))

        # (c) prefix transfer: A serves 4 prompts sharing 64 tokens, B
        # pulls A's 64-token entry, then serves the same prompts
        rng = np.random.default_rng(11)
        shared = [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=64)]
        pre_reqs = [shared + [int(t) for t in rng.integers(2, MODEL["vocab_size"],
                                                             size=n)]
                    for n in (8, 13, 21, 30)]
        a_out = [_gen(port["a"], p) for p in pre_reqs]
        index = json.loads(_http(f"http://127.0.0.1:{port['a']}", "GET",
                                 "/v2/models/lm/prefix_cache")[2])
        pull = _http(f"http://127.0.0.1:{port['b']}", "POST",
                     "/v2/models/lm/prefix_cache:pull",
                     {"peer": f"http://127.0.0.1:{port['a']}", "keys": [shared]})
        b_out = [_gen(port["b"], p) for p in pre_reqs]
        ok_c, bad_c = _judged(torch, model, pre_reqs, a_out, b_out)
        bpc, apc = eng["b"].prefix_cache_stats(), eng["a"].prefix_cache_stats()
        out["c_prefix_pull"] = {
            "a_index": {"count": index["count"], "tokens": index["tokens"]},
            "pull": [pull[0], json.loads(pull[2])],
            "a": apc, "b": bpc, "identical": a_out == b_out, "judged_equal": ok_c,
            "diverged": bad_c}
        checks["c"] = (pull[0] == 200 and ok_c and bpc["imported"] >= 1
                       and bpc["hits"] == len(pre_reqs) and apc["exported"] >= 1)

        # (d) the host tier: turn 2 = turn 1's prompt + its 48 tokens + 8
        # new ones, 16 new tokens; the third span evicts the first, and
        # turn 2 runs for s1, s2, then s0 (s1's and s2's new spans fit
        # beside the one not yet taken)
        tier = eng["tier"].host_kv_tier
        sess = [[int(t) for t in rng.integers(2, MODEL["vocab_size"], size=24)]
                for _ in range(3)]
        t1 = [_gen(port["tier"], p, {SESSION_HEADER: f"s{i}"}) for i, p in enumerate(sess)]
        flushed = eng["tier"].flush_offload()
        res1, ev1 = tier.resident(), tier.stats["evictions"]
        turn2 = [p + t + [int(x) for x in rng.integers(2, MODEL["vocab_size"], size=8)]
                 for p, t in zip(sess, t1)]
        d_rows = {}
        for i in (1, 2, 0):
            flushed &= eng["tier"].flush_offload()
            s0 = dict(eng["tier"].stats)
            toks = _gen(port["tier"], turn2[i], {SESSION_HEADER: f"s{i}"}, max_new=16)
            d_rows[i] = {"tokens": toks,
                         "offload_in": eng["tier"].stats["kv_offload_in"] - s0["kv_offload_in"],
                         "prefill_pieces": eng["tier"].stats["prefill_pieces"]
                         - s0["prefill_pieces"]}
        fresh = teng.LMEngine(model, **dict(kw_eng, prefill_buckets=(32, 128),
                                            max_seq=192)).start()
        try:
            want2 = [fresh.submit(p, max_new_tokens=16) for p in turn2]
        finally:
            fresh.stop()
        got2 = [d_rows[i]["tokens"] for i in range(3)]
        ok_d, bad_d = _judged(torch, model, turn2, want2, got2)
        out["d_host_tier"] = {
            "budget_bytes": tier_bytes, "resident_after_turn1": res1,
            "evictions_after_turn1": ev1,
            "predicted_turn1_span_bytes": 64 * per_tok,
            "by_session": {f"s{i}": {k: v for k, v in r.items() if k != "tokens"}
                           for i, r in d_rows.items()},
            "identical": got2 == want2, "judged_equal": ok_d, "diverged": bad_d}
        checks["d"] = (ok_d and flushed and res1["rows"] == 2 and ev1 == 1
                       and d_rows[1]["offload_in"] == 1 and d_rows[2]["offload_in"] == 1
                       and d_rows[0]["offload_in"] == 0
                       and d_rows[0]["prefill_pieces"] > 0)
    finally:
        for s in srv.values():
            s.stop()
    out["seconds"] = time.perf_counter() - t_phase
    out["checks"] = checks
    out["ok"] = all(checks.values()) and len(checks) == 8
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 8: replicas behind the port's gateway
# --------------------------------------------------------------------------- #

class _Clocked(_SSE):
    """An SSE client that also stamps every frame's arrival."""

    def __init__(self, port, name, ids, headers=None):
        super().__init__(port, name, ids, headers)
        self.stamps = []

    def frame(self):
        f = super().frame()
        if f is not None:
            self.stamps.append(time.perf_counter())
        return f

    def read_frames(self):
        frames = []
        while True:
            f = self.frame()
            if f is None:
                self.conn.close()
                return frames
            frames.append(f)
            if "token_ids" not in f:
                self.conn.close()
                return frames


def _fleet_burst(port, reqs, headers_for):
    """The requests at once over ``generate_stream``: per request its
    frames, frame arrival times, client TTFT; and the burst's wall."""
    def one(i):
        s = _Clocked(port, "lm", reqs[i], headers_for(i))
        if s.status != 200:
            raise RuntimeError(f"generate_stream answered {s.status}")
        frames = s.read_frames()
        return {"frames": frames, "stamps": s.stamps, "ttft_ms": s.ttft_ms,
                "tokens": [t for f in frames for t in f.get("token_ids", [])]}

    t0 = time.perf_counter()
    res = _concurrent(one, list(range(len(reqs))))
    wall = time.perf_counter() - t0
    n_tok = sum(len(r["tokens"]) for r in res)
    return res, {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
                 "ttft_ms_median": statistics.median(r["ttft_ms"] for r in res)}


def _clean(res):
    """No error frame, one done frame counting every token."""
    return all(all("error" not in f for f in r["frames"])
               and r["frames"][-1] == {"done": True, "n_tokens": len(r["tokens"])}
               for r in res)


def _session_on(gw, route, url):
    """A session id whose affine replica is ``url``."""
    for i in range(1000):
        b = gw._affine_pick(route, "default", f"session:fleet-{i}")
        if b is not None and b.url == url:
            return f"fleet-{i}"
    raise RuntimeError(f"no session maps to {url}")


#: (a)'s turns of each kind: a median and a spread, and the whole run
#: stays inside its time
FLEET_TURNS = 2


def phase_fleet(torch, state):
    """Two full-width bf16 replicas (``LMEngineModel`` on the paged kernel,
    watchdog on, chunked prefill in 32-token pieces so a resumed prompt
    of any length fits) behind the port's ``InferenceGateway`` with
    session affinity, so the replica a burst lands on is known: (a) the
    8-prompt burst over ``generate_stream`` in turns, direct to replica A
    and through the gateway to A (client TTFT and tokens/s, medians and
    spread: the gateway's cost); (b) a burst through the gateway during
    which ``kill_mid_stream`` kills A's server after rows have committed
    tokens: every stream resumes on B, no error frame, each judged against
    the uninterrupted streams, the resumes and the gap from the death to
    the next frame counted; (c) A back on a new server, wedged mid-stream:
    its watchdog restarts the engine and the streams resume on B; (d) one
    traced stream's tree from the gateway's and both replicas'
    ``/debug/traces``; (e) an f32 pair (TF32 off), two streams with one
    kill, identical to the uninterrupted ones. The paged launches of (b)
    and (c) are the fleet path's, by span and body."""
    from kubeflow_tpu_torch.chaos.injectors import kill_mid_stream
    from kubeflow_tpu_torch.gateway import GatewayConfig, InferenceGateway, ServiceRoute
    from kubeflow_tpu_torch.gateway.server import STREAM_RESUMES
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.obs.trace import TRACER, TraceContext
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    t_phase = time.perf_counter()
    out = {"phase": "fleet", "dtype": "bf16", "card": state["card"]}
    checks = {}
    engine = dict(ENGINE, prefill_chunk=32)
    TRACER.clear()
    TRACER.sample_every = 1

    def replicas(dtype, sd, **kw):
        cfg = TransformerConfig(dtype=dtype, attn_impl="flash", **MODEL)
        return [LMEngineModel("lm", config=cfg, state_dict=sd, device="cuda",
                              max_new_tokens=MAX_NEW, paged_attn_impl="kernel",
                              **engine, **kw) for _ in range(2)]

    def fleet(models):
        servers = [ModelServer([m], http_port=0).start() for m in models]
        route = ServiceRoute(name="lm", affinity="session", max_attempts=4)
        gw = InferenceGateway(GatewayConfig(
            probe_interval_s=30.0, failure_threshold=2, recovery_s=60.0,
            retry_budget_floor=100, routes=[route],
            backends=[("lm", f"http://127.0.0.1:{s.port}", "default", "both")
                      for s in servers])).start()
        return servers, gw, route

    def resumed(r0, want):
        """The gateway's resumes since ``r0``, once they reach ``want``
        (a client reads the done frame a moment before the count)."""
        t_end = time.monotonic() + 10
        while (STREAM_RESUMES.labels(service="lm", outcome="ok").value - r0 < want
               and time.monotonic() < t_end):
            time.sleep(0.01)
        return STREAM_RESUMES.labels(service="lm", outcome="ok").value - r0

    def killer(server, box):
        def act(eng):  # on the engine's thread: the kill runs beside it
            box["t_kill"] = time.perf_counter()
            threading.Thread(target=server.kill, daemon=True).start()
        return act

    def death_gaps(res, t_kill):
        """Per stream, the longest wait for a frame after the death (the
        frames the dead replica had already sent arrive first)."""
        gaps = []
        for r in res:
            prev = [t_kill] + [t for t in r["stamps"] if t > t_kill]
            if len(prev) > 1:
                gaps.append(max(b - max(a, t_kill)
                                for a, b in zip(prev, prev[1:])) * 1e3)
        return gaps

    reqs = prompts()
    sd = sharpened_state(torch, torch.bfloat16)
    # the watchdogs keep their 30 s floor while the peer absorbs resumed
    # prefills; (c) tightens the victim's to 1 s once its EWMA is warm
    models = replicas(torch.bfloat16, sd, watchdog_interval_s=0.1)
    servers, gw, route = fleet(models)
    url = [f"http://127.0.0.1:{s.port}" for s in servers]
    try:
        model = models[0].engine.model
        sid = _session_on(gw, route, url[0])
        seed = {"x-kft-seed": "7"}  # direct requests run the seeded chunk too

        # (a) direct to A against through the gateway to A, in turns
        turns = {"direct": [], "gateway": []}
        streams = {"direct": [], "gateway": []}
        for _ in range(FLEET_TURNS):
            for kind, port, hdr in (
                    ("direct", servers[0].port, lambda i: seed),
                    ("gateway", gw.http_port,
                     lambda i: {**seed, "x-session-id": sid})):
                res, st = _fleet_burst(port, reqs, hdr)
                turns[kind].append(st)
                streams[kind].append([r["tokens"] for r in res])
                checks.setdefault("a_clean", True)
                checks["a_clean"] &= _clean(res)
        want = streams["direct"][0]
        ok_a, bad_a = _judged(torch, model, reqs, want, streams["gateway"][0])
        a_stats = {kind: {k: _spread([t[k] for t in v])
                          for k in ("ttft_ms_median", "tokens_per_s")}
                   for kind, v in turns.items()}
        out["a_direct_vs_gateway"] = {
            **a_stats,
            "ttft_ms_added": a_stats["gateway"]["ttft_ms_median"]["median"]
            - a_stats["direct"]["ttft_ms_median"]["median"],
            "tokens_per_s_ratio": a_stats["gateway"]["tokens_per_s"]["median"]
            / a_stats["direct"]["tokens_per_s"]["median"],
            "gateway_equals_direct_judged": ok_a, "diverged": bad_a}
        checks["a"] = ok_a and all(s == streams["direct"][0]
                                   for s in streams["direct"])

        # (b) A's server killed mid-burst; one stream traced
        _zero_paged(pa)
        ctx = TraceContext(f"{zlib.crc32(b'fleet'):08x}" * 4, "ab" * 8)
        box = {}
        r0 = STREAM_RESUMES.labels(service="lm", outcome="ok").value
        a0 = models[1].engine.stats["resume_admits"]
        kill_mid_stream(models[0].engine, after_tokens=8,
                        action=killer(servers[0], box))
        res_b, st_b = _fleet_burst(gw.http_port, reqs, lambda i: {
            "x-session-id": sid, **({"x-kft-trace": ctx.header()} if i == 0 else {})})
        got_b = [r["tokens"] for r in res_b]
        ok_b, bad_b = _judged(torch, model, reqs, want, got_b)
        gaps = death_gaps(res_b, box["t_kill"]) if "t_kill" in box else []
        admits = models[1].engine.stats["resume_admits"] - a0
        out["b_kill"] = {
            **st_b, "killed": "t_kill" in box, "resumes": resumed(r0, admits),
            "peer_resume_admits": admits,
            "longest_frame_gap_after_death_ms": _spread(gaps) if gaps else None,
            "judged_equal": ok_b, "identical": got_b == want, "diverged": bad_b}
        checks["b"] = ("t_kill" in box and _clean(res_b) and ok_b
                       and out["b_kill"]["resumes"] >= 1
                       and out["b_kill"]["peer_resume_admits"] == out["b_kill"]["resumes"])

        # (d) the traced stream: one trace id from the edge to the chunks
        rows = _trace_rows(_trace_spans([gw.http_port, servers[1].port],
                                        ctx.trace_id))
        triples = {(n, p, s) for n, p, s, _ in rows}
        out["d_trace"] = {"trace_id": ctx.trace_id,
                          "spans": [[n, p, s, round(ms, 3)] for n, p, s, ms in rows]}
        checks["d"] = ({("route", None, "ok"), ("proxy", "route", "error"),
                        ("stream.resume", "route", "ok"),
                        ("dataplane.stream", "stream.resume", "ok"),
                        ("engine", "dataplane.stream", "ok"),
                        ("queue.wait", "engine", "ok"), ("prefill", "engine", "ok"),
                        ("decode.chunk", "engine", "ok")} <= triples)

        # (c) A on a new server, wedged mid-stream; its watchdog restarts it
        servers[0] = ModelServer([models[0]], http_port=0).start()
        gw.pool.remove(url[0])
        url[0] = f"http://127.0.0.1:{servers[0].port}"
        gw.pool.add("lm", url[0])
        sid_c = _session_on(gw, route, url[0])
        wd = models[0].watchdog
        wd.config.min_wedge_s = 1.0
        trips0, restarts0 = dict(wd.stats["trips"]), wd.stats["restarts"]
        old = models[0].engine
        entered, release = threading.Event(), threading.Event()
        old._fault_hooks["pre_chunk"] = _wedge_hook(entered, release)
        r0 = STREAM_RESUMES.labels(service="lm", outcome="ok").value
        a0 = models[1].engine.stats["resume_admits"]
        try:
            res_c, st_c = _fleet_burst(gw.http_port, reqs,
                                       lambda i: {"x-session-id": sid_c})
        finally:
            release.set()
        old._thread.join(120)
        fleet_launches, fleet_by_s, fleet_by_body = _paged_counts(pa)
        got_c = [r["tokens"] for r in res_c]
        ok_c, bad_c = _judged(torch, model, reqs, want, got_c)
        out["c_wedge"] = {
            **st_c, "wedged": entered.is_set(),
            "wedge_threshold_s": wd.wedge_threshold_s(old),
            "resumes": resumed(r0, models[1].engine.stats["resume_admits"] - a0),
            "watchdog_trips": wd.stats["trips"], "restarts": wd.stats["restarts"] - restarts0,
            "new_engine": models[0].engine is not old, "ready": models[0].ready,
            "judged_equal": ok_c, "identical": got_c == want, "diverged": bad_c}
        checks["c"] = (entered.is_set() and _clean(res_c) and ok_c
                       and out["c_wedge"]["resumes"] >= 1
                       and wd.stats["trips"].get("wedged", 0)
                       == trips0.get("wedged", 0) + 1
                       and out["c_wedge"]["restarts"] == 1
                       and models[0].engine is not old and models[0].ready)
        out["paged_launches"] = fleet_launches
        out["paged_launches_by_s"] = fleet_by_s
        out["paged_launches_by_body"] = fleet_by_body
        checks["launches"] = (fleet_by_body.get("decode", 0) == fleet_by_s.get(1, 0) > 0
                              and fleet_by_body.get("mma", 0) > 0
                              and _bodies_follow_rule(pa, fleet_by_s, fleet_by_body,
                                                      torch.bfloat16))
        state["fleet_paged_launches_by_s"] = fleet_by_s
        state["fleet_paged_launches_by_body"] = fleet_by_body
    finally:
        gw.stop()
        for s in servers:
            s.stop()
        del models
    torch.cuda.empty_cache()

    # (e) the f32 pair with TF32 off: two streams, one kill, identical
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = replicas(torch.float32, sharpened_state(torch, torch.float32))
    servers, gw, route = fleet(models)
    try:
        pair = reqs[:2]
        sid_e = _session_on(gw, route, f"http://127.0.0.1:{servers[0].port}")
        hdr = lambda i: {"x-session-id": sid_e}  # noqa: E731
        res0, _ = _fleet_burst(gw.http_port, pair, hdr)
        box = {}
        r0 = STREAM_RESUMES.labels(service="lm", outcome="ok").value
        kill_mid_stream(models[0].engine, after_tokens=8,
                        action=killer(servers[0], box))
        res1, _ = _fleet_burst(gw.http_port, pair, hdr)
        w32, g32 = [r["tokens"] for r in res0], [r["tokens"] for r in res1]
        same32, bad32 = _compare_greedy(torch, models[1].engine.model, pair, w32, g32)
        out["e_f32_pair"] = {"killed": "t_kill" in box,
                             "resumes": resumed(r0, len(pair)),
                             "identical": same32, "diverged": bad32}
        checks["e"] = ("t_kill" in box and same32 and _clean(res0) and _clean(res1)
                       and out["e_f32_pair"]["resumes"] >= 1)
    finally:
        gw.stop()
        for s in servers:
            s.stop()
    TRACER.sample_every = 16
    out["seconds"] = time.perf_counter() - t_phase
    out["checks"] = checks
    out["ok"] = all(checks.values()) and len(checks) == 7
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 9: the dense KV cache — the causal-lm runtime and the dense engine
# --------------------------------------------------------------------------- #

#: bench_engine's dense engine (``bench.py:990-993``)
DENSE_ENGINE = dict(max_batch=8, max_seq=192, chunk_steps=8,
                    prefill_buckets=(128,), eos_id=1)
#: the paged twin of DENSE_ENGINE: every row's whole context fits at once
DENSE_PAGED = dict(DENSE_ENGINE, kv_pool_tokens=8 * 192 + 32, page_size=32,
                   paged_attn_impl="kernel")
GEN_BATCH, GEN_PROMPT, GEN_LONG, GEN_SHORT = 8, 128, 64, 16
DENSE_NEW = 48
#: turns of (a) and bursts of (b) each: a median and a spread, and the
#: whole run stays inside its time
DENSE_TURNS = 2
DENSE_TEXTS = ["hello world", "The [MASK] sat on the mat.",
               "naive cafe, unicode: üé✓", "a.b,c;d:e?f!"]


def bench_engine_requests():
    """bench_engine's traffic (``bench.py:966-972``): 16 prompts of
    ``rng.integers(16, 120)`` tokens, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(2, MODEL["vocab_size"], size=int(n))]
            for n in rng.integers(16, 120, size=16)]


def _engine_burst(eng, reqs, max_new):
    """All requests at once on a started engine: streams, and tokens/s,
    TTFT p50 and the decode-gap EWMA of this burst alone."""
    eng.overlap["decode_gap_ms"] = 0.0
    eng.ttft_ms.clear()
    t0 = time.perf_counter()
    outs = _concurrent(lambda p: eng.submit(p, max_new_tokens=max_new), reqs)
    wall = time.perf_counter() - t0
    ttft = sorted(eng.ttft_ms)
    n_tok = sum(map(len, outs))
    return outs, {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
                  "ttft_ms_p50": ttft[len(ttft) // 2] if ttft else None,
                  "decode_gap_ms": eng.overlap["decode_gap_ms"]}


def phase_dense(torch, state):
    """The dense KV cache at the width of the JAX ``bench_generate`` model
    (the serving model; ``sharpened_state`` weights). (a) The
    ``causal-lm`` runtime behind ``ModelServer`` with bench_generate's
    traffic, 8 prompts of 128 tokens, generating 64 and 16 tokens in
    turns (``DENSE_TURNS`` each): the whole generation's ms at each length, the
    decode step from their difference / 48; the greedy streams against
    the paged engine's on the same weights; text rows over v1 against
    their tokenizer ids. (b) bench_engine's traffic (16 prompts, 48 new
    tokens) on the dense engine at depths 1 and 0 and on the paged kernel
    engine, ``DENSE_TURNS`` bursts each in turns: tokens/s, TTFT p50, decode gap;
    dense against paged streams. (a) and (b)'s dense runs must launch no
    paged kernel. (c) f32, TF32 off: the dense engine with K=4, with
    chunked prefill and a prefix cache, seeded with resume, and with a
    window must give the f32 paged engine's streams; a dense decode
    engine fed spans by a paged prefill engine runs no prefill piece."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.engine import LMEngine
    from kubeflow_tpu_torch.serve.generate import LMRuntimeModel
    from kubeflow_tpu_torch.serve.model import BucketSpec
    from kubeflow_tpu_torch.serve.runtimes import SimpleTokenizer
    from kubeflow_tpu_torch.serve.server import ModelServer

    t_phase = time.perf_counter()
    out = {"phase": "dense", "card": state["card"],
           "cache_bytes": 8 * MODEL["n_heads"] * 192 * 64 * 2 * 2 * MODEL["n_layers"]}
    checks = {}
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    sd = sharpened_state(torch, torch.bfloat16)
    rts = {n: LMRuntimeModel(
        f"gen{n}", config=cfg, state_dict=sd, device="cuda", max_new_tokens=n,
        buckets=BucketSpec(batch_sizes=(GEN_BATCH,), seq_lens=(GEN_PROMPT,)))
        for n in (GEN_LONG, GEN_SHORT)}
    rng = np.random.default_rng(5)
    gen_reqs = [[int(t) for t in rng.integers(2, MODEL["vocab_size"], size=GEN_PROMPT)]
                for _ in range(GEN_BATCH)]
    server = ModelServer(list(rts.values()), http_port=0).start()
    base = f"http://127.0.0.1:{server.port}"

    def predict(name, instances):
        status, _, text = _http(base, "POST", f"/v1/models/{name}:predict",
                                {"instances": instances})
        if status != 200:
            raise RuntimeError(f"{name} answered {status}: {text[:200]}")
        return [p["token_ids"] for p in json.loads(text)["predictions"]]

    try:
        # (a) the runtime, bench_generate's traffic
        ids_rows = [{"input_ids": p} for p in gen_reqs]
        for n in (GEN_LONG, GEN_SHORT):  # warm: cuBLAS handles, allocator
            predict(f"gen{n}", ids_rows[:1])
        torch.cuda.synchronize()
        pa.LAUNCHES = 0
        gen_ms = {GEN_LONG: [], GEN_SHORT: []}
        streams = None
        for _ in range(DENSE_TURNS):
            for n in (GEN_LONG, GEN_SHORT):
                got = predict(f"gen{n}", ids_rows)
                gen_ms[n].append(rts[n].stats["generate_ms"][-1])
                if n == GEN_LONG:
                    streams = streams or got
        tok = SimpleTokenizer(MODEL["vocab_size"])
        text_tokens = predict(f"gen{GEN_SHORT}", DENSE_TEXTS)
        id_tokens = predict(f"gen{GEN_SHORT}",
                            [{"input_ids": tok.encode(t)} for t in DENSE_TEXTS])
        dense_launches_a = pa.LAUNCHES
        model = rts[GEN_LONG]._lm  # kept past the server's unload
    finally:
        server.stop()
    eng = LMEngine(model, **DENSE_PAGED).start()
    try:
        paged = _concurrent(lambda p: eng.submit(p, max_new_tokens=GEN_LONG), gen_reqs)
    finally:
        eng.stop()
    ok_a, bad_a = _judged(torch, model, gen_reqs, paged, streams)
    med = {n: statistics.median(v) for n, v in gen_ms.items()}
    out["a_runtime"] = {
        "dtype": "bf16", "batch": GEN_BATCH, "prompt": GEN_PROMPT,
        "generate_ms": {str(n): _spread(v) for n, v in gen_ms.items()},
        "ms_per_decode_step": (med[GEN_LONG] - med[GEN_SHORT]) / (GEN_LONG - GEN_SHORT),
        "tokens_per_s_long": GEN_BATCH * GEN_LONG / (med[GEN_LONG] / 1e3),
        "tokens": sum(map(len, streams)), "identical_to_paged": streams == paged,
        "judged_equal": ok_a, "diverged": bad_a,
        "text_rows_equal_ids": text_tokens == id_tokens,
        "paged_launches": dense_launches_a}
    checks["a"] = (ok_a and text_tokens == id_tokens and dense_launches_a == 0
                   and all(1 <= len(s) <= GEN_LONG for s in streams))

    # (b) the dense engine, bench_engine's traffic, against the paged one
    reqs = bench_engine_requests()
    engines = {"dense_1": LMEngine(model, **DENSE_ENGINE, pipeline_depth=1),
               "dense_0": LMEngine(model, **DENSE_ENGINE, pipeline_depth=0),
               "paged_1": LMEngine(model, **DENSE_PAGED, pipeline_depth=1)}
    runs = {k: [] for k in engines}
    outs = {}
    dense_launches_b = 0
    try:
        for e in engines.values():
            e.start()
            e.submit(reqs[0][:16], max_new_tokens=8)  # warm
        torch.cuda.synchronize()
        for _ in range(DENSE_TURNS):
            for key, e in engines.items():
                pa.LAUNCHES = 0
                got, r = _engine_burst(e, reqs, DENSE_NEW)
                torch.cuda.synchronize()
                if key.startswith("dense"):
                    dense_launches_b += pa.LAUNCHES
                runs[key].append(r)
                outs.setdefault(key, got)
    finally:
        for e in engines.values():
            e.stop()
    ok_b, bad_b = _judged(torch, model, reqs, outs["paged_1"], outs["dense_1"])
    out["b_engine"] = {
        "dtype": "bf16", "requests": len(reqs), "max_new_tokens": DENSE_NEW,
        "by_engine": {k: {m: _spread([r[m] for r in v])
                          for m in ("tokens_per_s", "ttft_ms_p50", "decode_gap_ms")}
                      for k, v in runs.items()},
        "depth1_equals_depth0": outs["dense_1"] == outs["dense_0"],
        "identical_to_paged": outs["dense_1"] == outs["paged_1"],
        "judged_equal": ok_b, "diverged": bad_b,
        "paged_launches_dense_runs": dense_launches_b}
    checks["b"] = (ok_b and outs["dense_1"] == outs["dense_0"]
                   and dense_launches_b == 0)
    state["dense_paged_launches"] = dense_launches_a + dense_launches_b
    del model
    torch.cuda.empty_cache()

    # (c) f32 correctness: each dense run against the f32 paged engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd32 = sharpened_state(torch, torch.float32)
    m32 = _model(torch, torch.float32, "flash", state_dict=sd32)

    def streams_of(model_, kw, reqs_, warm=(), **submit):
        e = LMEngine(model_, **kw).start()
        try:
            for p in warm:
                e.submit(p, max_new_tokens=MAX_NEW, **submit)
            got = _concurrent(lambda p: e.submit(p, max_new_tokens=MAX_NEW, **submit),
                              reqs_)
            return got, dict(e.stats)
        finally:
            e.stop()

    c = {}
    mot = np.random.default_rng(3)
    motif_reqs = []
    for i in range(N_REQ):
        motif = [int(t) for t in mot.integers(2, MODEL["vocab_size"], size=8)]
        motif_reqs.append((motif * 4)[: 16 + i])
    k4_kw = dict(max_batch=8, max_seq=128, chunk_steps=8, prefill_buckets=(32,),
                 eos_id=1, spec_draft_tokens=4)
    dk4, sk4 = streams_of(m32, k4_kw, motif_reqs)
    pk4, _ = streams_of(m32, dict(ENGINE, paged_attn_impl="kernel",
                                  spec_draft_tokens=4), motif_reqs)
    c["k4"] = {"identical": dk4 == pk4, "spec_accepted": sk4["spec_accepted"]}

    shared = [int(t) for t in mot.integers(2, MODEL["vocab_size"], size=64)]
    pre_reqs = []
    for n in (70, 40, 100, 66, 88, 52, 95, 77):
        tail = [int(t) for t in mot.integers(2, MODEL["vocab_size"], size=n)]
        pre_reqs.append((shared + tail)[:n])
    long_kw = dict(max_batch=8, max_seq=192, chunk_steps=8, prefill_buckets=(32, 128),
                   eos_id=1)
    dc, sc = streams_of(m32, dict(long_kw, prefill_chunk=32, prefix_cache_entries=8),
                        pre_reqs[1:], warm=pre_reqs[:1])
    pc, _ = streams_of(m32, dict(long_kw, kv_pool_tokens=48 * 32, page_size=32,
                                 paged_attn_impl="kernel"),
                       pre_reqs[1:], warm=pre_reqs[:1])
    c["chunked_prefix"] = {"identical": dc == pc, "prefix_hits": sc["prefix_hits"],
                           "prefill_pieces": sc["prefill_pieces"]}

    ids = prompts()[0]
    samp = dict(max_new_tokens=MAX_NEW, temperature=0.9, seed=1234)
    seeded = {}
    for kind, kw in (("dense", dict(long_kw)),
                     ("paged", dict(long_kw, kv_pool_tokens=48 * 32, page_size=32,
                                    paged_attn_impl="kernel"))):
        e = LMEngine(m32, **kw).start()
        try:
            first = e.submit(ids, **samp)
            cut = len(first) // 2
            seeded[kind] = (first, e.submit(ids, resume_tokens=first[:cut], **samp), cut)
        finally:
            e.stop()
    (df, dr, cut), (pf, _, _) = seeded["dense"], seeded["paged"]
    c["seeded_resume"] = {"identical": df == pf, "resume_identical": dr == df[cut:],
                          "tokens": len(df)}

    cfg_w = TransformerConfig(dtype=torch.float32, attn_impl="flash", attn_window=32,
                              **MODEL)
    from kubeflow_tpu_torch.models.transformer import TransformerLM

    mw = TransformerLM(cfg_w, device="cuda")
    mw.load_state_dict(sd32)
    mw.eval().requires_grad_(False)
    win_reqs = prompts()
    dw, _ = streams_of(mw, dict(ENGINE, kv_pool_tokens=None), win_reqs)
    pw, _ = streams_of(mw, dict(ENGINE, paged_attn_impl="kernel"), win_reqs)
    c["window"] = {"identical": dw == pw, "window": 32, "tokens": sum(map(len, dw))}
    del mw

    # a dense decode engine fed by a paged prefill engine, through the codec
    pre = LMEngine(m32, **dict(ENGINE, paged_attn_impl="kernel")).start()
    dec = LMEngine(m32, **dict(ENGINE, kv_pool_tokens=None)).start()
    try:
        reqs8 = prompts()
        shipped = [_wire(*pre.prefill_span(p), p) for p in reqs8]
        spans = [dec.prepare_kv_span(p, t, m) for p, (t, m, _) in zip(reqs8, shipped)]
        got = _concurrent(lambda i: dec.submit(reqs8[i], max_new_tokens=MAX_NEW,
                                               kv_span=spans[i]), list(range(N_REQ)))
        dstats = dict(dec.stats)
    finally:
        pre.stop()
        dec.stop()
    colo, _ = streams_of(m32, dict(ENGINE, paged_attn_impl="kernel"), reqs8)
    c["paged_prefill_to_dense_decode"] = {
        "identical": got == colo, "prefill_pieces": dstats["prefill_pieces"],
        "kv_injected": dstats["kv_injected"]}
    del m32
    out["c_f32"] = c
    checks["c"] = (c["k4"]["identical"] and c["k4"]["spec_accepted"] > 0
                   and c["chunked_prefix"]["identical"]
                   and c["chunked_prefix"]["prefix_hits"] > 0
                   and c["seeded_resume"]["identical"]
                   and c["seeded_resume"]["resume_identical"]
                   and c["window"]["identical"]
                   and c["paged_prefill_to_dense_decode"]["identical"]
                   and c["paged_prefill_to_dense_decode"]["prefill_pieces"] == 0
                   and c["paged_prefill_to_dense_decode"]["kv_injected"] == N_REQ)
    out["seconds"] = time.perf_counter() - t_phase
    out["checks"] = checks
    out["ok"] = all(checks.values()) and len(checks) == 3
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 10: the KServe BERT predictor
# --------------------------------------------------------------------------- #

#: the JAX ``bench_serving`` request (``bench.py:736-744``) and its counts
BERT_TEXT = "the quick brown fox [MASK] over the lazy dog in the bright morning"
BERT_WARM, BERT_REQ, BERT_CLIENTS = 3, 40, 32
BERT_BUCKETS = dict(batch_sizes=(1, 8), seq_lens=(128,))
#: f32 logits of flash and plain attention, or of two batch shapes, sum
#: in other orders through 12 layers: a few 1e-6 on the CPU at bert-tiny
BERT_LOGIT_TOL = 1e-3
#: an f32 argmax divergence counts as a tie when the reference's top-2
#: margin at that position is below this (the logits' own tolerance)
F32_TIE = BERT_LOGIT_TOL
BERT_WORDS = ("the", "a", "cat", "dog", "sat", "on", "mat", "model", "served",
              "quick", "brown", "fox", "jumps", "over", "lazy", "river", "city",
              "of", "and", "to", "in", "is", "was", "bright", "morning", "paris",
              "capital", "france", "[MASK]", ",", ".", "?")


def bert_texts():
    """The burst's texts: one a client, 8-100 words each, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [" ".join(rng.choice(BERT_WORDS, size=int(n)))
            for n in rng.integers(8, 101, size=BERT_CLIENTS)]


def _bert_post(base, path, body):
    status, _, text = _http(base, "POST", path, body)
    if status != 200:
        raise RuntimeError(f"{path} answered {status}: {text[:200]}")
    return json.loads(text)


def _pct(ms, q):
    srt = sorted(ms)
    return srt[min(len(srt) - 1, int(len(srt) * q))]


def _bert_rows(torch, tok, texts, S):
    """Token ids and masks of ``texts`` padded to S, on the card."""
    ids = torch.zeros(len(texts), S, dtype=torch.int32)
    mask = torch.zeros_like(ids)
    for i, t in enumerate(texts):
        row = tok.encode(t)
        ids[i, :len(row)] = torch.tensor(row)
        mask[i, :len(row)] = 1
    return ids.cuda(), mask.cuda()


def _tie_judged(torch, ref_logits, want, got, valid):
    """Argmax rows ``got`` against ``want`` on the ``valid`` positions:
    ``(equal, divergences)``, where a divergence is allowed only at an
    f32 tie (the reference's top-2 margin below ``F32_TIE``)."""
    diff = (want != got) & valid
    top2 = ref_logits.float().topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1])[diff].tolist()
    return all(m < F32_TIE for m in margins), margins


def _bert_window(fa, pa):
    fa.LAUNCHES = 0
    for k in fa.LAUNCHES_BY_BODY:
        fa.LAUNCHES_BY_BODY[k] = 0
    pa.LAUNCHES = 0


def _bert_profile(torch, mod, tok, texts):
    """Where a predictor forward's time goes: the f32 forward and argmax
    of one bucket (B=1 and B=8, S=128), its wall ms unprofiled (median
    of 5, synchronized) and under ``torch.profiler``: kernels, device
    busy ms and share, the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.inference_mode():
        for B in (1, 8):
            ids, mask = _bert_rows(torch, tok, (texts * 8)[:B], 128)

            def fwd():
                mod(ids, mask).argmax(-1).to(torch.int32).cpu()

            fwd()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                fwd()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fwd()
            n, busy, top = _device_summary(prof)
            wall = statistics.median(walls)
            out[f"b{B}"] = {
                "wall_ms": wall, "kernels": n, "device_busy_ms": busy,
                "busy_share": busy / wall,
                "top": [{"name": k, "count": c, "ms": ms}
                        for k, (c, ms) in top[:6]]}
    return out


def phase_bert(torch, state):
    """The KServe BERT predictor at bert-base width (random weights from
    seed 0, the flash forward non-causal with padding segments). (a)
    ``BertRuntimeModel`` behind ``ModelServer`` with the JAX
    ``bench_serving`` traffic: cold start (``load`` + ``warmup``), 3 + 40
    sequential ``:predict`` requests, p50/p99 and the model's
    ``predict_ms``, in f32 (the default) and bf16. (b) f32: 32 concurrent
    clients, one text each, through a second server with a batcher
    (max 8, 5 ms): requests/s, p50/p99, mean occupancy > 1, each answer
    equal on its valid positions to the text served alone (f32 ties
    allowed). (d) v2 ``/infer`` with ``input_ids`` and ``attention_mask``
    equals the v1 answer. (e) every forward of the f32 window ((a), (b),
    (d)) and of the bf16 one launches the flash forward 12 times, on the
    ``fma`` body in f32 and ``wgmma`` in bf16, and no paged kernel. (c) f32
    flash against plain attention on the same weights, and a row's answer
    alone (S=32) against beside a longer row (S=128)."""
    from kubeflow_tpu_torch.models.bert import BertForMaskedLM, bert_base
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.batcher import BatcherConfig
    from kubeflow_tpu_torch.serve.model import BucketSpec
    from kubeflow_tpu_torch.serve.runtimes import BertRuntimeModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    L = bert_base().num_layers
    out = {"phase": "bert", "card": state["card"], "model": "bert-base, seed 0",
           "buckets": BERT_BUCKETS}
    checks = {}
    launches = {}
    texts = bert_texts()
    servers = []
    m32 = None
    try:
        for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t0 = time.perf_counter()
            m = BertRuntimeModel("bert", None, config=bert_base(dtype=dt),
                                 buckets=BucketSpec(**BERT_BUCKETS), device="cuda")
            m.load()
            m.warmup()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            server = ModelServer([m], http_port=0).start()
            servers.append(server)
            base = f"http://127.0.0.1:{server.port}"
            req0 = m.stats["requests"]
            _bert_window(fa, pa)
            # (a) bench_serving: sequential single-text requests
            for _ in range(BERT_WARM):
                _bert_post(base, "/v1/models/bert:predict", {"instances": [BERT_TEXT]})
            n_ms0 = len(m.stats["predict_ms"])
            lat, answer = [], None
            for _ in range(BERT_REQ):
                t = time.perf_counter()
                answer = _bert_post(base, "/v1/models/bert:predict",
                                    {"instances": [BERT_TEXT]})["predictions"]
                lat.append((time.perf_counter() - t) * 1e3)
            pred_ms = list(m.stats["predict_ms"])[n_ms0:]
            out.setdefault("a", {})[dn] = {
                "cold_start_s": cold_s, "p50_ms": statistics.median(lat),
                "p99_ms": _pct(lat, 0.99), "min_ms": min(lat),
                "predict_ms_median": statistics.median(pred_ms),
                "requests": BERT_REQ}
            n_tok = len(m.tokenizer.encode(BERT_TEXT))
            checks[f"a_{dn}"] = (len(answer) == 1 and len(answer[0]) == 128
                                 and all(0 <= t < m.config.vocab_size
                                         for t in answer[0]))
            if dn == "f32":
                m32 = m
                # (b) the batched burst, and each text alone
                bserver = ModelServer([m], http_port=0, batcher=BatcherConfig(
                    max_batch_size=8, max_latency_ms=5)).start()
                servers.append(bserver)
                bbase = f"http://127.0.0.1:{bserver.port}"

                def client(text, url=bbase):
                    t = time.perf_counter()
                    p = _bert_post(url, "/v1/models/bert:predict",
                                   {"instances": [text]})["predictions"][0]
                    return p, (time.perf_counter() - t) * 1e3

                t0 = time.perf_counter()
                burst = _concurrent(client, texts)
                wall = time.perf_counter() - t0
                alone = [client(t, base)[0] for t in texts]
                batcher = bserver.batchers["bert"]
                blat = [ms for _, ms in burst]
                out["b"] = {
                    "clients": BERT_CLIENTS, "wall_s": wall,
                    "requests_per_s": BERT_CLIENTS / wall,
                    "p50_ms": statistics.median(blat), "p99_ms": _pct(blat, 0.99),
                    "batches": batcher.stats["batches"],
                    "mean_occupancy": batcher.mean_occupancy,
                    "tokens": [len(m.tokenizer.encode(t)) for t in texts]}
                # (d) v2 /infer with input_ids + attention_mask against v1
                ids = m.tokenizer.encode(BERT_TEXT)
                v2 = _bert_post(base, "/v2/models/bert/infer", {"inputs": [
                    {"name": "input_ids", "shape": [1, len(ids)],
                     "datatype": "INT32", "data": ids},
                    {"name": "attention_mask", "shape": [1, len(ids)],
                     "datatype": "INT32", "data": [1] * len(ids)}]})
                o = v2["outputs"][0]
                out["d"] = {"shape": o["shape"], "datatype": o["datatype"],
                            "equal_v1": o["data"] == answer[0] and o["shape"] == [1, 128]}
                checks["d"] = out["d"]["equal_v1"]
            torch.cuda.synchronize()
            fwd = m.stats["requests"] - req0
            launches[dn] = {"forwards": fwd, "flash": fa.LAUNCHES,
                            "by_body": dict(fa.LAUNCHES_BY_BODY),
                            "paged": pa.LAUNCHES}
            body = "fma" if dn == "f32" else "wgmma"
            checks[f"e_{dn}"] = (fwd > 0 and fa.LAUNCHES == L * fwd
                                 and fa.LAUNCHES_BY_BODY[body] == L * fwd
                                 and pa.LAUNCHES == 0)
            out["a"][dn]["tokens"] = n_tok
        mod = m32.module  # kept past the servers' unload
    finally:
        for s in servers:
            s.stop()
    out["e"] = launches
    state["bert_flash_launches"] = sum(v["flash"] for v in launches.values())
    state["bert_flash_by_body"] = {dn: v["by_body"] for dn, v in launches.items()}
    state["bert_paged_launches"] = sum(v["paged"] for v in launches.values())

    # (b)'s judgement: each burst answer against the text alone, on its
    # valid positions; a divergence only at an f32 tie of the text's logits
    tok = m32.tokenizer
    rows_equal, margins = 0, []
    with torch.inference_mode():
        for i, (text, (got, _), want) in enumerate(zip(texts, burst, alone)):
            n = len(tok.encode(text))
            if got[:n] == want[:n]:
                rows_equal += 1
                continue
            ids, mask = _bert_rows(torch, tok, [text], 128)
            logits = mod(ids, mask)[0]
            ok_row, mg = _tie_judged(
                torch, logits, torch.tensor(want, device="cuda"),
                torch.tensor(got, device="cuda"), mask[0].bool())
            margins.append({"text": i, "margins": mg, "ok": ok_row})
    out["b"].update(rows_equal=rows_equal, diverged=margins)
    checks["b"] = (out["b"]["mean_occupancy"] > 1
                   and all(d["ok"] for d in margins))

    # (c) f32 parity on the card: flash against plain attention, and a
    # row's answer alone against beside a longer row
    ref = BertForMaskedLM(bert_base(attn_impl="reference"), device="cuda")
    ref.load_state_dict(mod.state_dict())
    ref.eval().requires_grad_(False)
    c = {}
    with torch.inference_mode():
        ids, mask = _bert_rows(torch, tok, texts[:8], 128)
        lf, lr = mod(ids, mask), ref(ids, mask)
        valid = mask.bool()
        err = (lf - lr).abs()[valid].max().item()
        same, mg = _tie_judged(torch, lr, lr.argmax(-1), lf.argmax(-1), valid)
        c["flash_vs_reference"] = {"max_abs_err": err, "tol": BERT_LOGIT_TOL,
                                   "argmax_ok": same, "tie_margins": mg}
        longest = max(texts, key=len)
        ids1, mask1 = _bert_rows(torch, tok, [BERT_TEXT], 32)
        ids2, mask2 = _bert_rows(torch, tok, [BERT_TEXT, longest], 128)
        alone_l = mod(ids1, mask1)[0]
        beside_l = mod(ids2, mask2)[0, :32]
        v1 = mask1[0].bool()
        err_pad = (alone_l - beside_l).abs()[v1].max().item()
        same_pad, mg_pad = _tie_judged(torch, alone_l, alone_l.argmax(-1),
                                       beside_l.argmax(-1), v1)
        c["padding_invariance"] = {"max_abs_err": err_pad, "tol": BERT_LOGIT_TOL,
                                   "argmax_ok": same_pad, "tie_margins": mg_pad,
                                   "finite": bool(torch.isfinite(lf).all())}
    out["c"] = c
    checks["c"] = (err <= BERT_LOGIT_TOL and same and err_pad <= BERT_LOGIT_TOL
                   and same_pad and c["padding_invariance"]["finite"])
    out["profile_f32"] = _bert_profile(torch, mod, tok, texts)
    del ref, mod
    out["seconds"] = time.perf_counter() - t_phase
    out["checks"] = checks
    out["ok"] = all(checks.values()) and len(checks) == 7
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 11: training through Trainer.fit at full width
# --------------------------------------------------------------------------- #

TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_WARM, TRAIN_TIMED = 3, 20
PARITY_STEPS = 5


def _train_data(start_step=0):
    from kubeflow_tpu_torch.data import TokenLMDataset, local_shard_iterator

    ds = TokenLMDataset(vocab_size=MODEL["vocab_size"], seq_len=TRAIN_SEQ, seed=0)
    return local_shard_iterator(ds, TRAIN_BATCH, start_step=start_step)


def train_flops_per_step():
    """Model FLOPs of one training step: 6 * N * tokens over the N weights
    that enter matrix products (the projections and the unembed; the
    embedding is a gather), plus causal attention, 4 * D flops per
    visible (query, key) pair forward (q.k and p.v) and twice that
    backward, in every head and layer."""
    d, f, L, V = MODEL["d_model"], MODEL["d_ff"], MODEL["n_layers"], MODEL["vocab_size"]
    n_matmul = L * (4 * d * d + 3 * d * f) + d * V
    tokens = TRAIN_BATCH * TRAIN_SEQ
    visible = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * d * visible * L  # H * D = d_model
    return 6 * n_matmul * tokens + attn


def _plain_steps(model, opt, loss_fn, batches):
    """One optimizer step a placed batch, outside the trainer, with the
    trainer's step keys: ``(losses, aux of each step, step-1 gradients of
    every parameter that got one)``."""
    from kubeflow_tpu_torch.serve.threefry import key_of

    losses, auxes, grads = [], [], None
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, batch, key_of(0, i))
        loss.backward()
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        opt.step()
        losses.append(loss.item())
        auxes.append({k: v.item() for k, v in aux.items()})
    return losses, auxes, grads


def _zero_flash_counts(fa, fb):
    fa.LAUNCHES = fb.DQ_LAUNCHES = fb.DKV_LAUNCHES = 0
    for counts in (fa.LAUNCHES_BY_BODY, fb.DQ_LAUNCHES_BY_BODY, fb.DKV_LAUNCHES_BY_BODY):
        for k in counts:
            counts[k] = 0
    for counts in (fa.LAUNCHES_BY_SHAPE, fb.DQ_LAUNCHES_BY_SHAPE,
                   fb.DKV_LAUNCHES_BY_SHAPE):
        counts.clear()


def _flash_counts_by_body(fa, fb):
    return {"flash_forward": dict(fa.LAUNCHES_BY_BODY),
            "flash_bwd_dq": dict(fb.DQ_LAUNCHES_BY_BODY),
            "flash_bwd_dkv": dict(fb.DKV_LAUNCHES_BY_BODY)}


def phase_train(torch, state):
    """(a) f32 parity with TF32 off: the same initial weights and batches
    through flash attention (forward and backward kernels) and through
    plain attention under autograd, 5 steps of adamw(1e-3): step-1
    gradients of every parameter and the per-step losses must agree, and
    the flash run's forward, dq and dk/dv launches all run the ``fma``
    bodies, once per layer per step. (b)
    ``Trainer.fit`` in bf16 over f32 master weights, 3 warm-up and 20
    timed steps: finite, falling loss, and each attention kernel launched
    once per layer per step."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw
    from kubeflow_tpu_torch.train.prefetch import device_placer, live_kft_threads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_fn = make_loss_fn()
    place = device_placer(torch.device("cuda"))
    batches = [place(b).claim() for b, _ in zip(_train_data(), range(PARITY_STEPS))]
    runs = {}
    sd0 = None
    for impl in ("flash", "reference"):
        cfg = TransformerConfig(dtype=torch.float32, attn_impl=impl, **MODEL)
        model = make_init_fn(cfg)(0, torch.device("cuda"))
        if sd0 is None:
            sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd0)
        opt = adamw(1e-3)(model.parameters())
        _zero_flash_counts(fa, fb)
        losses, _, grads = _plain_steps(model, opt, loss_fn, batches)
        runs[impl] = (losses, grads)
        if impl == "flash":
            torch.cuda.synchronize()
            parity_launches = _flash_counts_by_body(fa, fb)
        del model, opt
        torch.cuda.empty_cache()
    (fl, fg), (rl, rg) = runs["flash"], runs["reference"]
    grad_tol, loss_rtol = 1e-3, 1e-4
    grad_rel = {n: ((fg[n] - rg[n]).abs().max() / rg[n].abs().max()).item()
                for n in rg}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(fl, rl)]
    worst = max(grad_rel, key=grad_rel.get)
    want_p = MODEL["n_layers"] * PARITY_STEPS
    parity_ok = (max(grad_rel.values()) <= grad_tol
                 and max(loss_rel) <= loss_rtol
                 and parity_launches == {
                     "flash_forward": {"wgmma": 0, "fma": want_p},
                     "flash_bwd_dq": {"wgmma": 0, "fma": want_p},
                     "flash_bwd_dkv": {"wgmma": 0, "fma": want_p}})
    state["train_parity_launches"] = parity_launches
    emit({"phase": "train_parity", "dtype": "f32", "tf32": False,
          "shape": [TRAIN_BATCH, TRAIN_SEQ], "steps": PARITY_STEPS,
          "losses_flash": fl, "losses_reference": rl,
          "loss_rel_err_max": max(loss_rel), "loss_rtol": loss_rtol,
          "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst_param": worst,
          "grad_tol": grad_tol, "launches_by_body": parity_launches,
          "launches_wanted": want_p, "ok": parity_ok})
    del runs, fg, rg, sd0, batches
    torch.cuda.empty_cache()

    steps = TRAIN_WARM + TRAIN_TIMED
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    trainer = Trainer(
        init_params=make_init_fn(cfg), loss_fn=loss_fn, optimizer=adamw(1e-3),
        config=TrainConfig(mesh=None, global_batch=TRAIN_BATCH, steps=steps,
                           log_every=1, prefetch_depth=2),
    )
    ready = {}

    def stamp(step, m):  # drain thread: step ``step`` has run on the card
        ready[step] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts(fa, fb)
    _, history = trainer.fit(_train_data, hooks=[stamp])
    torch.cuda.synchronize()
    launches = {"flash_forward": fa.LAUNCHES, "flash_bwd_dq": fb.DQ_LAUNCHES,
                "flash_bwd_dkv": fb.DKV_LAUNCHES}
    # the bf16 step's forward, dq and dk/dv launches all ran the tensor cores
    by_body = _flash_counts_by_body(fa, fb)
    state["train_launches"] = launches
    losses = [h["loss"] for h in history]
    timed_s = ready[steps] - ready[TRAIN_WARM]
    step_ms = timed_s / TRAIN_TIMED * 1e3
    flops = train_flops_per_step()
    want = MODEL["n_layers"] * steps
    finite = all(map(math.isfinite, losses))
    ok = (parity_ok and finite and len(losses) == steps and losses[-1] < losses[0]
          and all(n == want for n in launches.values())
          and by_body == {"flash_forward": {"wgmma": want, "fma": 0},
                          "flash_bwd_dq": {"wgmma": want, "fma": 0},
                          "flash_bwd_dkv": {"wgmma": want, "fma": 0}}
          and live_kft_threads() == [])
    emit({"phase": "train", "dtype": "bf16", "param_dtype": "f32",
          "shape": [TRAIN_BATCH, TRAIN_SEQ], "steps": steps,
          "timed_steps": TRAIN_TIMED, "first_loss": losses[0],
          "last_loss": losses[-1], "finite": finite,
          "step_ms": step_ms, "steps_per_s": TRAIN_TIMED / timed_s,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_TIMED / timed_s,
          "compile_ms": history[0].get("compile_ms"),
          "data_stall_ms": history[-1].get("data_stall_ms"),
          "model_flops_per_step": flops,
          "mfu_bf16_dense": flops / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_by_body": by_body,
          "launches_wanted": want, "card": state["card"], "ok": ok})
    return ok


# --------------------------------------------------------------------------- #
# phase 12: the rest of the training path (BERT MLM, remat, checked
# numerics, the MNIST CNN and ResNet-50)
# --------------------------------------------------------------------------- #

#: ``bench.py`` BERT_BATCH x BERT_SEQ; the f32 parity steps at rows 3c/4c's B
MLM_BATCH, MLM_SEQ, MLM_PARITY_BATCH = 32, 128, 8
MLM_WARM, MLM_TIMED, MLM_PARITY_STEPS = 3, 20, 5
REMAT_STEPS = 2
#: ``examples/mnist.py``'s defaults; ResNet-50 on CIFAR shapes
MNIST_BATCH, MNIST_STEPS, RESNET_BATCH, RESNET_STEPS = 64, 100, 64, 10


def bert_train_flops_per_step(batch, seq, *, layers=12, hidden=768,
                              inter=3072, vocab=30522):
    """Matmul FLOPs of one ``BertForMaskedLM`` train step (a copy of
    ``bench.py:209-221``): fwd = 2·S·P_matmul + 4·L·S²·H (QKᵀ and AV,
    bidirectional), train = 3 × fwd; gathers and norms excluded."""
    p_matmul = layers * (4 * hidden * hidden + 2 * hidden * inter)
    p_head = hidden * hidden + hidden * vocab  # mlm_transform + unembed
    fwd = 2 * seq * (p_matmul + p_head) + 4 * layers * seq * seq * hidden
    return 3.0 * batch * fwd


def _mlm_data(batch, start_step=0):
    from kubeflow_tpu_torch.data import TokenLMDataset, local_shard_iterator

    ds = TokenLMDataset(vocab_size=30522, seq_len=MLM_SEQ, seed=0)
    return local_shard_iterator(ds, batch, start_step=start_step)


def _quiet_writer():
    """A metric writer whose step lines go nowhere (the phase prints its
    own summary); its NaN alarm stays on."""
    import io

    from kubeflow_tpu_torch.train.metrics import MetricWriter

    return MetricWriter(None, stdout=io.StringIO())


def _stamped_fit(torch, trainer, data):
    """``trainer.fit(data)`` with each step's ready time (drain thread):
    ``(history, {step: perf_counter})``."""
    ready = {}

    def stamp(step, m):
        ready[step] = time.perf_counter()

    _, history = trainer.fit(data, writer=_quiet_writer(), hooks=[stamp])
    torch.cuda.synchronize()
    return history, ready


def _rel_errs(torch, got, want):
    """max |got − want| / max(max |want|, 1e-3 · G) of each named tensor,
    G the largest |want| of all: a gradient that is 0 in exact arithmetic
    (a key projection's bias: softmax ignores a shift shared by every key)
    is rounding noise in both runs, measured against the model's scale."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    return {n: ((got[n] - want[n]).abs().max().item()
                / max(want[n].abs().max().item(), floor)) for n in want}


def _mlm_parity(torch, fa, fb):
    """(a): bert-base in f32, TF32 off, flash against plain attention: the
    same initial weights, batches and threefry masks, 5 steps of
    adamw(1e-4); each flash step launches forward, dq and dk/dv 12 times
    on ``fma``."""
    from kubeflow_tpu_torch.models.bert import (
        bert_base, make_mlm_init_fn, make_mlm_loss_fn,
    )
    from kubeflow_tpu_torch.train import adamw
    from kubeflow_tpu_torch.train.prefetch import device_placer

    place = device_placer(torch.device("cuda"))
    batches = [place(b).claim() for b, _ in zip(_mlm_data(MLM_PARITY_BATCH),
                                                range(MLM_PARITY_STEPS))]
    loss_fn = make_mlm_loss_fn()
    runs, sd0, launches = {}, None, None
    for impl in ("flash", "reference"):
        model = make_mlm_init_fn(bert_base(attn_impl=impl))(0, torch.device("cuda"))
        if sd0 is None:
            sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd0)
        opt = adamw(1e-4)(model.parameters())
        _zero_flash_counts(fa, fb)
        # the pooler is not on the MLM path: it gets no gradient
        losses, auxes, grads = _plain_steps(model, opt, loss_fn, batches)
        accs = [a["masked_accuracy"] for a in auxes]
        if impl == "flash":
            torch.cuda.synchronize()
            launches = _flash_counts_by_body(fa, fb)
        runs[impl] = (losses, accs, grads)
        del model, opt
    torch.cuda.empty_cache()
    (fl, fa_, fg), (rl, ra, rg) = runs["flash"], runs["reference"]
    grad_tol, loss_rtol = 1e-3, 1e-4
    grad_rel = _rel_errs(torch, fg, rg)
    worst = max(grad_rel, key=grad_rel.get)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(fl, rl)]
    want = 12 * MLM_PARITY_STEPS
    ok = (set(fg) == set(rg) and grad_rel[worst] <= grad_tol
          and max(loss_rel) <= loss_rtol
          and launches == {k: {"wgmma": 0, "fma": want} for k in launches})
    return {"part": "a_f32_parity", "dtype": "f32", "tf32": False,
            "shape": [MLM_PARITY_BATCH, MLM_SEQ], "steps": MLM_PARITY_STEPS,
            "losses_flash": fl, "losses_reference": rl,
            "masked_accuracy_flash": fa_, "masked_accuracy_reference": ra,
            "loss_rel_err_max": max(loss_rel), "loss_rtol": loss_rtol,
            "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst_param": worst,
            "grad_tol": grad_tol, "params_with_grad": len(fg),
            "launches_by_body": launches, "launches_wanted": want, "ok": ok}


def _mlm_fit(torch, fa, fb, card):
    """(b): ``Trainer.fit`` in bf16 over f32 master weights at the bench's
    shape, 3 warm-up and 20 timed steps; each step launches every flash
    kernel 12 times on ``wgmma``."""
    from kubeflow_tpu_torch.models.bert import (
        bert_base, make_mlm_init_fn, make_mlm_loss_fn,
    )
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw
    from kubeflow_tpu_torch.train.prefetch import live_kft_threads

    steps = MLM_WARM + MLM_TIMED
    trainer = Trainer(
        init_params=make_mlm_init_fn(bert_base(dtype=torch.bfloat16)),
        loss_fn=make_mlm_loss_fn(), optimizer=adamw(1e-4),
        config=TrainConfig(mesh=None, global_batch=MLM_BATCH, steps=steps,
                           log_every=1, prefetch_depth=2),
    )
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts(fa, fb)
    history, ready = _stamped_fit(torch, trainer, lambda s: _mlm_data(MLM_BATCH, s))
    by_body = _flash_counts_by_body(fa, fb)
    losses = [h["loss"] for h in history]
    timed_s = ready[steps] - ready[MLM_WARM]
    step_ms = timed_s / MLM_TIMED * 1e3
    flops = bert_train_flops_per_step(MLM_BATCH, MLM_SEQ)
    want = 12 * steps
    finite = all(map(math.isfinite, losses))
    ok = (finite and len(losses) == steps and losses[-1] < losses[0]
          and by_body == {k: {"wgmma": want, "fma": 0} for k in by_body}
          and live_kft_threads() == [])
    return {"part": "b_fit_bf16", "dtype": "bf16", "param_dtype": "f32",
            "shape": [MLM_BATCH, MLM_SEQ], "steps": steps,
            "timed_steps": MLM_TIMED, "first_loss": losses[0],
            "last_loss": losses[-1], "finite": finite,
            "masked_accuracy_last": history[-1]["masked_accuracy"],
            "step_ms": step_ms, "tokens_per_s":
                MLM_BATCH * MLM_SEQ * MLM_TIMED / timed_s,
            "compile_ms": history[0].get("compile_ms"),
            "data_stall_ms": history[-1].get("data_stall_ms"),
            "model_flops_per_step": flops,
            "mfu_bf16_dense": flops / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_by_body": by_body, "launches_wanted": want,
            "card": card, "ok": ok}


def _remat(torch, fa, fb):
    """(c): the train phase's LM in f32 with remat None and "dots" against
    no remat, 2 steps each from one initial state on the same batches:
    losses and step-1 gradients agree, and the forward launches twice a
    layer a step under remat (once without), dq and dk/dv once."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.train import adamw
    from kubeflow_tpu_torch.train.prefetch import device_placer

    place = device_placer(torch.device("cuda"))
    batches = [place(b).claim() for b, _ in zip(_train_data(), range(REMAT_STEPS))]
    loss_fn = make_loss_fn()
    out, runs, sd0 = {}, {}, None
    L = MODEL["n_layers"]
    for name, knobs in (("none", {}), ("full", dict(remat=True)),
                        ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = TransformerConfig(dtype=torch.float32, attn_impl="flash", **MODEL,
                                **knobs)
        model = make_init_fn(cfg)(0, torch.device("cuda"))
        if sd0 is None:
            sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd0)
        opt = adamw(1e-3)(model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_flash_counts(fa, fb)
        losses, _, grads = _plain_steps(model, opt, loss_fn, batches)
        torch.cuda.synchronize()
        fwd_each = 2 if knobs else 1
        counts = {"flash_forward": fa.LAUNCHES, "flash_bwd_dq": fb.DQ_LAUNCHES,
                  "flash_bwd_dkv": fb.DKV_LAUNCHES}
        wanted = {"flash_forward": fwd_each * L * REMAT_STEPS,
                  "flash_bwd_dq": L * REMAT_STEPS, "flash_bwd_dkv": L * REMAT_STEPS}
        out[name] = {"losses": losses, "launches": counts,
                     "launches_wanted": wanted,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "peak_over_state_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9}
        runs[name] = (losses, grads)
        # the optimizer sits in a reference cycle: collect it now, or the
        # next variant's base holds this one's state until a collection
        # frees it part way through that variant's steps
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    ok = all(o["launches"] == o["launches_wanted"] for o in out.values())
    tol = 1e-5
    for name in ("full", "dots"):
        rel = _rel_errs(torch, runs[name][1], runs["none"][1])
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(runs[name][0], runs["none"][0]))
        out[name].update(grad_rel_err_max=max(rel.values()),
                         loss_rel_err_max=loss_rel,
                         grads_bitwise=all(torch.equal(runs[name][1][n],
                                                       runs["none"][1][n])
                                           for n in rel))
        ok &= max(rel.values()) <= tol and loss_rel <= tol
    return {"part": "c_remat", "dtype": "f32", "shape": [TRAIN_BATCH, TRAIN_SEQ],
            "steps": REMAT_STEPS, "tol": tol, "variants": out, "ok": ok}


def _mnist_trainer(torch, steps, models, batch=MNIST_BATCH, **cfg):
    from kubeflow_tpu_torch.models.mnist_cnn import make_init_fn, make_loss_fn
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adam

    init = make_init_fn()

    def init_params(seed, device):
        model = init(seed, device)
        models.append(model)
        return model

    return Trainer(init_params=init_params, loss_fn=make_loss_fn(),
                   optimizer=adam(1e-3),
                   config=TrainConfig(mesh=None, global_batch=batch, steps=steps,
                                      log_every=1, **cfg))


def _mnist_stream(poison_at=None, image_shape=(28, 28, 1), batch=MNIST_BATCH):
    import numpy as np

    from kubeflow_tpu_torch.data import ClassPrototypeDataset, local_shard_iterator

    def factory(start_step):
        it = local_shard_iterator(ClassPrototypeDataset(image_shape=image_shape),
                                  batch, start_step=start_step)
        for step, (x, y) in enumerate(it, start=start_step):
            if step == poison_at:
                x = x.copy()
                x[0, 0, 0, 0] = np.nan  # one poisoned pixel
            yield x, y

    return factory


def _checked(torch):
    """(d): checkify and debug_nans on a poisoned MNIST batch (the second):
    each raises its located error and leaves the weights as the last
    update left them; clean runs in each mode equal the default run
    (deterministic cuDNN for the comparison); step ms a mode."""
    from kubeflow_tpu_torch.train.numerics import CheckifyError

    out, ok = {}, True
    for mode, knob, err in (("checkify", {"check_numerics": "checkify"}, CheckifyError),
                            ("debug_nans", {"debug_nans": True}, FloatingPointError)):
        models, snaps = [], []
        trainer = _mnist_trainer(torch, 3, models, **knob)
        real = trainer.optimizer

        def optimizer(params, real=real, snaps=snaps):
            opt = real(params)
            opt.register_step_post_hook(lambda o, a, k: snaps.append(
                [p.detach().clone() for g in o.param_groups for p in g["params"]]))
            return opt

        trainer.optimizer = optimizer
        message = None
        try:
            trainer.fit(_mnist_stream(poison_at=1), writer=_quiet_writer())
        except err as e:
            message = str(e)
        unchanged = bool(snaps) and all(
            torch.equal(a, b) for a, b in zip(models[0].parameters(), snaps[-1]))
        hooks_gone = all(not m._forward_hooks for m in models[0].modules())
        good = (message is not None and "nan" in message and "Conv_0" in message
                and len(snaps) == 1 and unchanged and hooks_gone
                and not torch.is_anomaly_enabled())
        out[mode] = {"error": message, "updates_before": len(snaps),
                     "weights_unchanged": unchanged, "hooks_gone": hooks_gone,
                     "ok": good}
        ok &= good
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for mode, knob in (("default", {}), ("checkify", {"check_numerics": "checkify"}),
                           ("debug_nans", {"debug_nans": True})):
            steps = 20
            hist, ready = _stamped_fit(torch, _mnist_trainer(torch, steps, [], **knob),
                                       _mnist_stream())
            runs[mode] = [h["loss"] for h in hist]
            out.setdefault("step_ms", {})[mode] = (ready[steps] - ready[5]) / (steps - 5) * 1e3
    finally:
        torch.backends.cudnn.deterministic = prev
    for mode in ("checkify", "debug_nans"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs[mode], runs["default"]))
        out[f"{mode}_clean_loss_rel_err"] = rel
        ok &= rel <= 1e-6
    return {"part": "d_checked_numerics", "model": "mnist_cnn", "batch": MNIST_BATCH,
            "poisoned_step": 2, **out, "ok": ok}


def _zoo(torch, card):
    """(e): ``examples/mnist.py``'s fit (batch 64, adam(1e-3), 100 steps)
    and ResNet-50 CIFAR at full width in bf16, batch 64, 10 steps of
    adam(3e-5)."""
    from kubeflow_tpu_torch.models.mnist_cnn import make_loss_fn
    from kubeflow_tpu_torch.models.resnet import make_init_fn, resnet50_cifar
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adam

    hist, _ = _stamped_fit(torch, _mnist_trainer(torch, MNIST_STEPS, []),
                           _mnist_stream())
    mnist = {"first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
             "last_accuracy": hist[-1]["accuracy"]}
    mnist_ok = (mnist["last_accuracy"] > 0.9
                or mnist["last_loss"] < mnist["first_loss"])
    # adam(3e-5): without a warm-up the bench's sgd(0.1, momentum 0.9), and
    # adam at 1e-4, throw this GroupNorm ResNet's loss up for several steps
    trainer = Trainer(
        init_params=make_init_fn(resnet50_cifar(dtype=torch.bfloat16)),
        loss_fn=make_loss_fn(), optimizer=adam(3e-5),
        config=TrainConfig(mesh=None, global_batch=RESNET_BATCH,
                           steps=RESNET_STEPS, log_every=1))
    torch.cuda.reset_peak_memory_stats()
    hist, ready = _stamped_fit(torch, trainer, _mnist_stream(
        image_shape=(32, 32, 3), batch=RESNET_BATCH))
    losses = [h["loss"] for h in hist]
    resnet = {"dtype": "bf16", "param_dtype": "f32", "batch": RESNET_BATCH,
              "steps": RESNET_STEPS, "losses": losses,
              "step_ms": (ready[RESNET_STEPS] - ready[2]) / (RESNET_STEPS - 2) * 1e3,
              "images_per_s": RESNET_BATCH * (RESNET_STEPS - 2)
                  / (ready[RESNET_STEPS] - ready[2]),
              "compile_ms": hist[0].get("compile_ms"),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    resnet_ok = all(map(math.isfinite, losses)) and losses[-1] < losses[0]
    return {"part": "e_zoo", "mnist": {**mnist, "steps": MNIST_STEPS,
                                       "batch": MNIST_BATCH, "ok": mnist_ok},
            "resnet50": {**resnet, "ok": resnet_ok}, "card": card,
            "ok": mnist_ok and resnet_ok}


def phase_mlm(torch, state):
    """BERT MLM training through the non-causal flash kernels ((a) f32
    parity, (b) the bf16 fit), remat (c), checked numerics (d) and the
    CNNs (e); one JSON line a part. No part depends on another."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ok = True
    for part in (lambda: _mlm_parity(torch, fa, fb),
                 lambda: _mlm_fit(torch, fa, fb, state["card"]),
                 lambda: _remat(torch, fa, fb),
                 lambda: _checked(torch),
                 lambda: _zoo(torch, state["card"])):
        r = part()
        emit({"phase": "mlm", **r})
        ok &= r["ok"]
        if r["part"] == "a_f32_parity":
            state["mlm_parity_launches"] = r["launches_by_body"]
        elif r["part"] == "b_fit_bf16":
            state["mlm_launches"] = r["launches_by_body"]
        torch.cuda.empty_cache()
    return ok


# --------------------------------------------------------------------------- #
# phase 13: the parallel training path, four ranks on one card
# --------------------------------------------------------------------------- #

MESH_RANKS = 4
#: (a)'s shapes: row 2 (bf16) and row 2d's causal f32 at S=512
MESH_ATTN = dict(B=8, H=16, S=512, D=64)
#: the LM fits' steps (one timed after the first: the whole run stays
#: inside its time), f32 parity steps and layers
MESH_STEPS, MESH_PARITY_STEPS, MESH_PARITY_LAYERS = 2, 2, 2
#: the pipeline check: ``dryrun_multichip``'s stages and data
#: (``__graft_entry__.py:139-182``)
MESH_PIPE = dict(stages=4, width=64, batch=16, micro=4)


#: the flash kernels' launch counters, by the kernels line's names
FLASH_KERNELS = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")


def _mesh_counts():
    """This rank's flash launches by kernel and body, by kernel and shape
    (``<kernel>_by_shape``), and ring hops."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.parallel import ring_attention as ra

    shapes = (fa.LAUNCHES_BY_SHAPE, fb.DQ_LAUNCHES_BY_SHAPE, fb.DKV_LAUNCHES_BY_SHAPE)
    return {**_flash_counts_by_body(fa, fb),
            **{f"{k}_by_shape": dict(c) for k, c in zip(FLASH_KERNELS, shapes)},
            "ring_hops": ra.HOPS}


def _mesh_zero():
    from kubeflow_tpu_torch.core import collectives as coll
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.parallel import ring_attention as ra

    _zero_flash_counts(fa, fb)
    ra.HOPS = 0
    coll.reset_counters()


def _mesh_attention(torch, dist, dev):
    """(a) ring and Ulysses over seq=4 against one-rank flash on the same
    inputs, forward and gradients; every rank checks its own block."""
    from kubeflow_tpu_torch.core.mesh import Axis, MeshSpec, build_mesh
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_attention_local, shard_global)
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention_local

    mesh = build_mesh(MeshSpec(seq=MESH_RANKS), device=dev)
    out = {}
    c = MESH_ATTN
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gen = torch.Generator(device=dev).manual_seed(20)
        shape = (c["B"], c["H"], c["S"], c["D"])
        q, k, v, dout = (torch.randn(shape, device=dev, generator=gen) / (
            1.0 if i == 3 else c["D"] ** 0.5) for i in range(4))
        q, k, v = (t.to(dt) for t in (q, k, v))

        def grads(fn, q, k, v, dout):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*leaves)
            o.backward(dout.to(o.dtype))
            return [o.detach()] + [t.grad for t in leaves]

        full = lambda *a: flash_attention(*a, causal=True)  # noqa: E731
        for impl, local in (("ring", ring_attention_local),
                            ("ulysses", ulysses_attention_local)):
            _mesh_zero()
            blk = lambda t: shard_global(t, mesh, Axis.SEQ).contiguous()  # noqa: E731
            got = grads(lambda a, b, cc: local(a, b, cc, causal=True, mesh=mesh),
                        blk(q), blk(k), blk(v), blk(dout))
            _mesh_sync(torch, dev)
            counts = _mesh_counts()
            # the one-rank kernel and, in f32 units, the f32 run of the same
            # rounded inputs: the parallel strategy is judged by how far it
            # sits from f32 against how far one-rank flash in this dtype does
            want = [blk(t) for t in grads(full, q, k, v, dout)]
            ref32 = [blk(t) for t in grads(full, q.float(), k.float(), v.float(),
                                            dout.float())]
            errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
            err32 = [float((g.float() - r).abs().max()) for g, r in zip(got, ref32)]
            base32 = [float((w.float() - r).abs().max()) for w, r in zip(want, ref32)]
            scale = [float(r.abs().max()) for r in ref32]
            if dt == torch.float32:
                ok = errs[0] <= 2e-5 and max(errs[1:]) <= 5e-4
            else:  # f32 units: no worse than twice one-rank bf16's error + 1e-3 of scale
                ok = all(e <= 2 * b + 1e-3 * s for e, b, s in zip(err32, base32, scale))
            out[f"{impl}_{dt_name}"] = {
                "ok": bool(ok), "max_abs_err_vs_one_rank": errs,
                "max_abs_err_vs_f32": err32, "one_rank_err_vs_f32": base32,
                "launches": counts, "seq_rank": mesh.index(Axis.SEQ)}
    dist.barrier()
    return out


def _mesh_lm(torch, dev, spec_kw, *, dtype, layers, steps, attn_impl, moe,
             reference=False):
    """``Trainer.fit`` of the full-width LM (``layers`` deep) under a mesh,
    or with ``reference`` the one-rank trainer on the same weights and
    global batches. Returns its figures and, for the parity check, the
    full final parameters (rank 0)."""
    import numpy as np

    from kubeflow_tpu_torch.core import collectives as coll
    from kubeflow_tpu_torch.core.mesh import MeshSpec
    from kubeflow_tpu_torch.data import TokenLMDataset, local_shard_iterator
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn)
    from kubeflow_tpu_torch.parallel.expert import MoEConfig
    from kubeflow_tpu_torch.parallel.sharding import transformer_rules
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw

    spec = MeshSpec(**spec_kw)
    cfg = TransformerConfig(**dict(MODEL, n_layers=layers), dtype=dtype,
                            attn_impl=attn_impl, embed_impl="onehot",
                            moe_every=2 if moe else 0, moe=MoEConfig())
    ds = TokenLMDataset(vocab_size=MODEL["vocab_size"], seq_len=TRAIN_SEQ, seed=0)
    trainer = Trainer(
        init_params=make_init_fn(cfg), loss_fn=make_loss_fn(), optimizer=adamw(1e-3),
        config=TrainConfig(mesh=None if reference else spec,
                           global_batch=TRAIN_BATCH, steps=steps, log_every=1,
                           prefetch_depth=0),
        param_spec_fn=None if reference else transformer_rules(), device=dev)

    def data(start):
        if not reference:
            return local_shard_iterator(ds, TRAIN_BATCH, start_step=start,
                                        mesh=trainer.mesh)

        def glob():  # the partitions' rows in partition order
            parts = spec.batch_partitions
            step = start
            while True:
                rows = [ds.batch(TRAIN_BATCH // parts, step=step, offset=p)
                        for p in range(parts)]
                yield {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
                step += 1
        return glob()

    _mesh_zero()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ready = {}

    def stamp(step, m):
        ready[step] = time.perf_counter()

    state, history = trainer.fit(data, writer=_quiet_writer(), hooks=[stamp])
    _mesh_sync(torch, dev)
    counts = _mesh_counts()
    step_ms = [(ready[s] - ready[s - 1]) * 1e3 for s in range(2, steps + 1)]
    res = {"losses": [h["loss"] for h in history],
           "moe_dropped_frac": [h.get("moe_dropped_frac") for h in history],
           "moe_aux": [h.get("moe_aux") for h in history],
           "step_ms": statistics.median(step_ms) if step_ms else None,
           "launches_per_step": {k: ({b: n / steps for b, n in v.items()}
                                     if isinstance(v, dict) else v / steps)
                                 for k, v in counts.items()},
           "staged_bytes_per_step": coll.STAGED_BYTES / steps,
           "collective_ms_per_step": coll.COLLECTIVE_S * 1e3 / steps,
           "collective_calls_per_step": {k: n / steps for k, n in
                                         coll.COLLECTIVE_CALLS.items()},
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev.type == "cuda" else None)}
    return res, trainer, state


def _mesh_pipeline(torch, dev):
    """(e) 1F1B against GPipe on pipe=4 with ``dryrun_multichip``'s stage
    function and data."""
    import numpy as np

    from kubeflow_tpu_torch.core.mesh import MeshSpec, build_mesh
    from kubeflow_tpu_torch.parallel.pipeline import (
        live_activation_buffers, pipeline_value_and_grad)

    p = MESH_PIPE
    mesh = build_mesh(MeshSpec(pipe=p["stages"]), device=dev)
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.randn(p["stages"], p["width"], p["width"]) * 0.2,
                     dtype=torch.float32, device=dev)
    x = torch.tensor(rng.randn(p["batch"], p["width"]), dtype=torch.float32,
                     device=dev)
    stage = lambda prm, h: torch.tanh(h @ prm["w"])  # noqa: E731
    loss = lambda y: (y ** 2).mean()  # noqa: E731
    out = {}
    for sched in ("gpipe", "1f1b"):
        stats = {}
        lv, g = pipeline_value_and_grad(stage, loss, {"w": w}, x, mesh,
                                        n_microbatches=p["micro"],
                                        schedule=sched, stats=stats)
        out[sched] = (float(lv), g["w"].float().cpu(), stats["live_buffers"])
    (lg, gg, bg), (l1, g1, b1) = out["gpipe"], out["1f1b"]
    gerr = float((gg - g1).abs().max())
    return {"loss_gpipe": lg, "loss_1f1b": l1, "loss_diff": abs(lg - l1),
            "grad_max_abs_diff": gerr,
            "ok": abs(lg - l1) < 1e-5 and gerr < 1e-4,
            "live_buffers_measured": {"gpipe": bg, "1f1b": b1},
            "live_activation_buffers": {
                s: live_activation_buffers(s, p["stages"], p["micro"])
                for s in ("gpipe", "1f1b")}}


def _mesh_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_rank(device="cuda"):
    """One rank of the mesh phase (all four run this): (a)-(e) in order;
    returns this rank's figures. Any exception fails the world.
    (``device="cpu"`` runs the same code on the kernels' plain twins.)"""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.core.mesh import Axis

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    res = {"rank": rank, "backend": dist.get_backend(),
           "a_attention": _mesh_attention(torch, dist, dev)}
    # (b) the full-width LM over model=2 x seq=2 with ring attention
    ring_kw = dict(model=2, seq=2)
    res["b_ring_lm"], tr, st = _mesh_lm(
        torch, dev, ring_kw, dtype=torch.bfloat16, layers=MODEL["n_layers"],
        steps=MESH_STEPS, attn_impl="ring", moe=False)
    res["b_ring_lm"]["seq_rank"] = tr.mesh.index(Axis.SEQ)
    del tr, st
    # (c) the same LM with MoE every second block over fsdp=2 x expert=2
    moe_kw = dict(fsdp=2, expert=2)
    res["c_moe_lm"], tr, st = _mesh_lm(
        torch, dev, moe_kw, dtype=torch.bfloat16, layers=MODEL["n_layers"],
        steps=MESH_STEPS, attn_impl="flash", moe=True)
    del tr, st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (d) f32 parity at 2 layers against the one-rank trainer (rank 0)
    res["d_parity"] = {}
    for name, kw, impl, moe in (("ring", ring_kw, "ring", False),
                                ("moe", moe_kw, "flash", True)):
        got, tr, st = _mesh_lm(torch, dev, kw, dtype=torch.float32,
                               layers=MESH_PARITY_LAYERS,
                               steps=MESH_PARITY_STEPS, attn_impl=impl, moe=moe)
        full = {k: v.float().cpu() for k, v in
                tr.full_state_dict(st)["model"].items()}
        del tr, st
        entry = {"losses": got["losses"], "moe_dropped_frac": got["moe_dropped_frac"]}
        if rank == 0:
            want, ref, rst = _mesh_lm(torch, dev, kw, dtype=torch.float32,
                                      layers=MESH_PARITY_LAYERS,
                                      steps=MESH_PARITY_STEPS, attn_impl="flash",
                                      moe=moe, reference=True)
            wfull = {k: v.float().cpu() for k, v in rst.model.state_dict().items()}
            del ref, rst
            diffs = {k: (full[k] - wfull[k]).abs() for k in wfull}
            worst = max(diffs, key=lambda k: float(diffs[k].max()))
            close = float(sum(int((d <= 1e-5).sum()) for d in diffs.values())
                          / sum(d.numel() for d in diffs.values()))
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(got["losses"], want["losses"]))
            drop = [abs(a - b) for a, b in zip(got["moe_dropped_frac"],
                                                want["moe_dropped_frac"])
                    if a is not None]
            tokens = TRAIN_BATCH * TRAIN_SEQ * 2  # top-2 choices a token
            entry.update({
                "reference_losses": want["losses"],
                "reference_moe_dropped_frac": want["moe_dropped_frac"],
                "loss_max_rel_diff": loss_rel,
                "moe_dropped_frac_max_diff": max(drop) if drop else 0.0,
                "param_max_abs_diff": float(diffs[worst].max()),
                "param_worst": worst, "param_frac_within_1e-5": close,
                # losses within 2e-5; drops within 4 of the k x T choices;
                # weights within 2 lr (all Adam can part two runs in 2
                # steps) and nearly all within 1e-5
                "ok": (loss_rel <= 2e-5 and (max(drop) if drop else 0.0) <= 4 / tokens
                       and float(diffs[worst].max()) <= 2e-3 and close >= 0.999)})
        dist.barrier()
        res["d_parity"][name] = entry
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    res["e_pipeline"] = _mesh_pipeline(torch, dev)
    return res


def phase_mesh(torch, state):
    """One world of four ranks on this card (gloo, host-staged; spawned
    once, the kernels built here first): (a) ring and Ulysses over seq=4
    against one-rank flash at rows 2 and 2d's shapes, forward and
    gradients, with each rank's launches (ring: 1 + j forward, dq and
    dk/dv launches on seq rank j) and hops; (b) ``Trainer.fit`` of the
    full-width LM in bf16 over f32 weights, 2 steps of 8 x 512 under
    ``MeshSpec(model=2, seq=2)`` with ring attention, the ``onehot``
    embedding and ``transformer_rules()``: step ms, tokens/s, MFU
    (989 TFLOP/s, one card), the loss, flash launches a step by rank
    (12 (1 + j) of each), bytes staged through the host a step, peak
    memory by rank; (c) the same LM with MoE every second block
    (``MoEConfig()``) under ``MeshSpec(fsdp=2, expert=2)`` on flash:
    the same figures and ``moe_dropped_frac`` and the aux loss; (d) f32
    at full width, 2 layers, 2 steps, both meshes against the one-rank
    trainer on the same weights and batches (losses, drops, weights);
    (e) 1F1B against GPipe on ``MeshSpec(pipe=4)`` with
    ``dryrun_multichip``'s stages (losses within 1e-5, gradients 1e-4,
    the live activation buffers). A line a part and a closing one with
    the backend and the wall seconds. The step times of four ranks
    sharing one card and the host link say nothing of a multi-card job."""
    from kubeflow_tpu_torch.core.distributed import launch

    t0 = time.perf_counter()
    ranks = launch(_mesh_rank, MESH_RANKS, timeout_s=900.0, pg_timeout_s=300.0)
    ok = True
    by_rank = sorted(ranks, key=lambda r: r["rank"])
    # (a)
    for name in by_rank[0]["a_attention"]:
        rows = [r["a_attention"][name] for r in by_rank]
        good = all(x["ok"] for x in rows)
        if name.startswith("ring"):
            # rank j ran the diagonal and j full hops, each kernel once a hop
            for x in rows:
                j = x["seq_rank"]
                c = x["launches"]
                good &= all(sum(c[k].values()) == 1 + j for k in
                            ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"))
                good &= c["ring_hops"] == 2 * (1 + j)
        else:  # one kernel of each over the full sequence, local heads
            good &= all(sum(x["launches"][k].values()) == 1 for x in rows
                        for k in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"))
        ok &= good
        emit({"phase": "mesh", "part": "a_attention", "case": name, "ok": good,
              "shape": MESH_ATTN, "causal": True,
              "tolerance": ("2e-5 out, 5e-4 grads against one-rank flash"
                            if name.endswith("f32") else
                            "f32 units: error against f32 <= 2 x one-rank "
                            "bf16 flash's + 1e-3 x the largest value"),
              "by_rank": [{k: x[k] for k in ("seq_rank", "launches",
                                             "max_abs_err_vs_one_rank",
                                             "max_abs_err_vs_f32",
                                             "one_rank_err_vs_f32")} for x in rows]})
    # (b), (c)
    flops = train_flops_per_step()
    for part in ("b_ring_lm", "c_moe_lm"):
        rows = [r[part] for r in by_rank]
        r0 = rows[0]
        losses = r0["losses"]
        good = all(math.isfinite(x) for x in losses) and all(
            x["losses"] == losses for x in rows)
        if part == "b_ring_lm":
            for x in rows:
                want = MODEL["n_layers"] * (1 + x["seq_rank"])
                good &= all(sum(x["launches_per_step"][k].values()) == want
                            for k in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"))
        else:
            good &= all(sum(x["launches_per_step"][k].values()) == MODEL["n_layers"]
                        for x in rows for k in ("flash_forward", "flash_bwd_dq",
                                                "flash_bwd_dkv"))
            good &= all(f is not None and 0.0 <= f < 1.0 for f in r0["moe_dropped_frac"])
        step_ms = statistics.median(x["step_ms"] for x in rows)
        ok &= good
        emit({"phase": "mesh", "part": part, "ok": good,
              "mesh": {"model": 2, "seq": 2} if part == "b_ring_lm" else
              {"fsdp": 2, "expert": 2},
              "attn_impl": "ring" if part == "b_ring_lm" else "flash",
              "steps": MESH_STEPS, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
              "loss": losses, "step_ms": step_ms,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
              "mfu_bf16_one_card": flops / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
              **({"moe_dropped_frac": r0["moe_dropped_frac"],
                  "moe_aux": r0["moe_aux"]} if part == "c_moe_lm" else {}),
              "by_rank": [{k: x.get(k) for k in (
                  "seq_rank", "launches_per_step", "staged_bytes_per_step",
                  "collective_ms_per_step", "collective_calls_per_step",
                  "peak_gb", "step_ms")} for x in rows]})
    # (d)
    for name, entry in by_rank[0]["d_parity"].items():
        good = entry["ok"] and all(r["d_parity"][name]["losses"] == entry["losses"]
                                   for r in by_rank)
        ok &= good
        emit({"phase": "mesh", "part": "d_parity", "case": name, "ok": good,
              "dtype": "f32", "tf32": False, "layers": MESH_PARITY_LAYERS,
              "steps": MESH_PARITY_STEPS, **entry})
    # (e)
    pipe = by_rank[0]["e_pipeline"]
    good = all(r["e_pipeline"]["ok"] for r in by_rank)
    ok &= good
    emit({"phase": "mesh", "part": "e_pipeline", "ok": good, **pipe,
          "by_rank_live_buffers": [r["e_pipeline"]["live_buffers_measured"]
                                   for r in by_rank]})
    # the flash launches of the phase's main path, every rank and part,
    # by body and by shape
    total, by_shape = {}, {}
    for r in by_rank:
        for x in (r["b_ring_lm"], r["c_moe_lm"]):
            for k in FLASH_KERNELS:
                for into, got in ((total, x["launches_per_step"][k]),
                                  (by_shape, x["launches_per_step"][f"{k}_by_shape"])):
                    for b, n in got.items():
                        into.setdefault(k, {}).setdefault(b, 0)
                        into[k][b] += int(round(n * MESH_STEPS))
    state["mesh_launches_by_shape"] = by_shape
    # every shape the phase launched a kernel at, in (a), (b) and (c), is
    # one the kernels phase holds against the plain twin
    held = {"flash_forward": {case_shape(c) for _, c in flash_cases(torch)}}
    held["flash_bwd_dq"] = held["flash_bwd_dkv"] = {
        case_shape(c) for _, c in bwd_cases(torch)}
    launched = {k: set(by_shape.get(k, {})) for k in FLASH_KERNELS}
    for r in by_rank:
        for x in r["a_attention"].values():
            for k in FLASH_KERNELS:
                launched[k] |= set(x["launches"][f"{k}_by_shape"])
    unheld = {k: sorted(launched[k] - held[k]) for k in FLASH_KERNELS
              if launched[k] - held[k]}
    ok &= not unheld
    backend = sorted({r["backend"] for r in by_rank})
    emit({"phase": "mesh", "ok": bool(ok), "ranks": MESH_RANKS,
          "backend": backend, "host_staged": backend == ["gloo"],
          "launches_b_c": total, "launches_b_c_by_shape": by_shape,
          "shapes_not_held": unheld, "seconds": time.perf_counter() - t0})
    return ok


# --------------------------------------------------------------------------- #
# phase 14: open-loop load through the gateway over an autoscaled fleet
# --------------------------------------------------------------------------- #

#: bench_serving_load's mix (``bench.py:627-642``): 4 shapes, SLO 2 s
LOAD_SLO_MS = 2_000.0


def load_configs(torch):
    """The three runs of bench_serving_load (``bench.py:643-660``) through
    the port's harness: steady (Poisson 4/s for 8 s on 2 pinned
    replicas), chaos (the same schedule with an engine wedged for 3 s at
    3 s), scale (on/off 1/30 per s, 4 s period, 8 s, from 1 replica with
    ``min_replicas=0``, then a timed cold request). The replicas run the
    full-width ``MODEL`` in bf16 on the paged pool with the kernel."""
    import dataclasses

    from kubeflow_tpu_torch.chaos.plan import FaultPlan, WedgeEngine
    from kubeflow_tpu_torch.loadgen import (
        ChaosOverlay,
        HarnessConfig,
        TenantSpec,
        WorkloadMix,
    )
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    mix = WorkloadMix(
        prompt_lens=(6, 10), output_lens=(4, 8),
        tenants=(TenantSpec("interactive", weight=2.0, priority=2,
                            deadline_ms=30_000.0, slo_ms=LOAD_SLO_MS),
                 TenantSpec("batch", weight=1.0, priority=0, adapter="batch-v1",
                            slo_ms=LOAD_SLO_MS)),
        vocab=80, seed=7)
    replicas = dict(
        model_config=TransformerConfig(dtype=torch.bfloat16, attn_impl="flash",
                                       **MODEL),
        engine_kwargs=dict(kv_pool_tokens=ENGINE["kv_pool_tokens"],
                           page_size=ENGINE["page_size"], paged_attn_impl="kernel"),
        device="cuda")
    steady = HarnessConfig(seed=7, process="poisson", rate_rps=4.0, duration_s=8.0,
                           mix=mix, initial_replicas=2, max_replicas=2,
                           min_replicas=2, **replicas)
    chaos = dataclasses.replace(steady, chaos=ChaosOverlay(
        plan=FaultPlan(faults=(WedgeEngine(model="m", hold_s=3.0),), seed=7),
        at_s=3.0, window_s=5.0))
    scale = HarnessConfig(seed=7, process="onoff", rate_rps=1.0, burst_rps=30.0,
                          period_s=4.0, duration_s=8.0, mix=mix, initial_replicas=1,
                          max_replicas=2, min_replicas=0, kpa_target=0.3,
                          measure_cold_recovery=True, **replicas)
    return {"steady": steady, "chaos": chaos, "scale": scale}


def _median_max(values):
    return ({"median": statistics.median(values), "max": max(values), "n": len(values)}
            if values else None)


def phase_load(torch, state):
    """bench_serving_load's three runs through the port's
    ``run_serving_load``: the load client, the gateway, the KPA autoscaler
    and the fleet of full-width bf16 replicas on the paged kernel, all in
    this process. One line a run: goodput and outcomes, TTFT p50/p99 and
    TPOT p50 (server histograms), client e2e p99, the chaos window, the
    scale-up latency, cold recovery and fleet events, how late the
    client fired against its schedule, the autoscaler's scrape ms a tick,
    and the paged launches by span and body. Gates: no error in the
    steady run, no client-visible failure in the chaos run, the scale run
    reaching 2 replicas, draining to 0 and completing its cold request;
    every completed request got its whole budget; each run launched the
    paged kernel, S=1 on ``decode`` and S=32 on ``mma``."""
    from kubeflow_tpu_torch.loadgen import run_serving_load
    from kubeflow_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    checks = {}
    by_body_all = {}
    for name, cfg in load_configs(torch).items():
        t_run = time.perf_counter()
        stats = {}
        _zero_paged(pa)
        rep = run_serving_load(cfg, harness_stats=stats)
        launches, by_s, by_body = _paged_counts(pa)
        for k, n in by_body.items():
            by_body_all[k] = by_body_all.get(k, 0) + n
        g = rep["goodput"]["overall"]
        lat = rep["latency"]
        out = {"phase": "load", "run": name, "card": state["card"],
               "offered": g["offered"], "goodput": g["goodput"],
               "outcomes": {k: g[k] for k in ("completed_in_slo", "completed_late",
                                              "shed", "error")},
               "ttft_ms_p50": lat["ttft_ms"]["p50"], "ttft_ms_p99": lat["ttft_ms"]["p99"],
               "tpot_ms_p50": lat["tpot_ms"]["p50"],
               "client_ttft_ms_p50": lat["client_ttft_ms"]["p50"],
               "client_e2e_ms_p99": lat["client_e2e_ms"]["p99"],
               "server": rep["server"],
               "client_lag_ms": _median_max(stats["client_lag_ms"]),
               "scrape_ms": _median_max(stats["scrape_ms"]),
               "paged_launches": launches, "paged_launches_by_s": by_s,
               "paged_launches_by_body": by_body}
        if "chaos" in rep:
            c = rep["chaos"]
            out["chaos"] = {"faults": c["faults"], "window_s": c["window_s"],
                            "goodput_in_window": c["in_window"]["goodput"],
                            "goodput_outside_window": c["outside_window"]["goodput"],
                            "goodput_dip": c["goodput_dip"],
                            "client_visible_failures": c["client_visible_failures"]}
        if "autoscale" in rep:
            a = rep["autoscale"]
            out["autoscale"] = {k: a[k] for k in ("replicas_peak", "first_reached_s",
                                                  "scale_up_latency_s", "events")}
        if "cold_recovery" in rep:
            out["cold_recovery"] = rep["cold_recovery"]
        results = stats["results"]
        whole = all(r.tokens == min(spec.max_new_tokens, cfg.max_new_tokens_cap)
                    for r, spec in zip(results, cfg.mix.plan(len(results)))
                    if r.outcome.startswith("completed"))
        ok = (g["offered"] == len(results) == rep["run"]["offered_requests"] > 0
              and whole and by_body.get("decode", 0) == by_s.get(1, 0) > 0
              and by_body.get("mma", 0) > 0
              and _bodies_follow_rule(pa, by_s, by_body, torch.bfloat16))
        if name == "steady":
            ok &= g["error"] == 0
        elif name == "chaos":
            ok &= (g["error"] == 0 and out["chaos"]["client_visible_failures"] == 0
                   and out["chaos"]["faults"] == ["WedgeEngine"])
        else:
            events = out.get("autoscale", {}).get("events", [])
            ok &= (out.get("autoscale", {}).get("replicas_peak", 0) >= 2
                   and any(e["replicas"] == 0 for e in events)
                   and str(rep.get("cold_recovery", {}).get("outcome", "")
                           ).startswith("completed"))
        out["whole_budgets"] = whole
        out["seconds"] = time.perf_counter() - t_run
        out["ok"] = bool(ok)
        checks[name] = bool(ok)
        emit(out)
        torch.cuda.empty_cache()
    state["load_paged_launches_by_body"] = by_body_all
    emit({"phase": "load", "card": state["card"], "paged_launches_by_body": by_body_all,
          "seconds": time.perf_counter() - t_phase, "checks": checks,
          "ok": all(checks.values()) and len(checks) == 3})
    return all(checks.values()) and len(checks) == 3


# --------------------------------------------------------------------------- #
# phase 15: tensor-parallel serving, two ranks on one card
# --------------------------------------------------------------------------- #

#: the f32 parity run's depth (full width)
TP_F32_LAYERS = 2


def _tp_burst(torch, dist, eng, reqs):
    """The burst on a started TP engine: the leader submits every request
    at once and stops the engine; a follower follows until that stop.
    Returns the leader's streams and wall seconds (None on a follower)."""
    if not eng.is_leader:
        eng.start()
        return None, None
    eng.start()
    try:
        t0 = time.perf_counter()
        got = _concurrent(lambda p: eng.submit(p, max_new_tokens=MAX_NEW), reqs)
        return got, time.perf_counter() - t0
    finally:
        eng.stop()


def _tp_counts(torch, dev):
    """This rank's paged launches (by span, shape and body), staged bytes,
    collective seconds and calls since they were set to 0, and its peak
    memory."""
    from kubeflow_tpu_torch.core import collectives as coll
    from kubeflow_tpu_torch.ops import paged_attention as pa

    return {"paged_launches": pa.LAUNCHES,
            "paged_by_s": dict(pa.LAUNCHES_BY_S),
            "paged_by_shape": dict(pa.LAUNCHES_BY_SHAPE),
            "paged_by_body": dict(pa.LAUNCHES_BY_BODY),
            "staged_bytes": coll.STAGED_BYTES,
            "collective_s": coll.COLLECTIVE_S,
            "collective_calls": dict(coll.COLLECTIVE_CALLS),
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None)}


def _tp_zero(torch, dist, dev):
    from kubeflow_tpu_torch.core import collectives as coll
    from kubeflow_tpu_torch.ops import paged_attention as pa

    dist.barrier()
    _zero_paged(pa)
    coll.reset_counters()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _tp_free(torch, dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _moe_drops(torch):
    """Collect the ``moe_dropped_frac`` of every MoE call the block runs
    (the served forward keeps no stats): yields the list of the calls'
    device scalars."""
    from kubeflow_tpu_torch.models import transformer as ttf

    inner, drops = ttf.moe_ffn, []

    def counted(*args, **kw):
        out = inner(*args, **kw)
        drops.append(out[2]["moe_dropped_frac"].detach())
        return out

    ttf.moe_ffn = counted
    try:
        yield drops
    finally:
        ttf.moe_ffn = inner


def tp_parts(torch):
    """The tp phase's parts ``(name, dtype, layers, prompts, engine kwargs,
    moe)``: (a) the serving burst at full width in bf16 and (b) f32 at
    ``TP_F32_LAYERS``; (c) the engine phase's motif prompts at K=4,
    likewise; (d) the MoE LM (every second FFN ``MoEConfig()``'s)."""
    import numpy as np

    reqs, motif = prompts(), motif_prompts(np.random.default_rng(3))
    spec = dict(spec_draft_tokens=SPEC_K, spec_ngram=3)
    full, f32 = MODEL["n_layers"], TP_F32_LAYERS
    bf, fl = torch.bfloat16, torch.float32
    return [("a_bf16", bf, full, reqs, {}, False),
            ("b_f32", fl, f32, reqs, {}, False),
            ("c_spec_bf16", bf, full, motif, spec, False),
            ("c_spec_f32", fl, f32, motif, spec, False),
            ("d_moe_bf16", bf, full, reqs, {}, True),
            ("d_moe_f32", fl, f32, reqs, {}, True)]


def _tp_rank(device="cuda"):
    """One rank of the tp phase (both run this), a part at a time
    (:func:`tp_parts`): the model served over ``MeshSpec(model=2)`` on the
    paged kernel, a warm burst and then the counted one; rank 0 then
    serves the same burst on the one-rank engine (the same knobs) over
    the full weights. (``device="cpu"`` runs the same code on the
    kernel's plain twin.)"""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.core.mesh import MeshSpec, build_mesh
    from kubeflow_tpu_torch.serve.engine import LMEngine

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    mesh = build_mesh(MeshSpec(model=TP_RANKS), device=dev)
    res = {"rank": rank, "backend": dist.get_backend()}
    for part, dtype, layers, reqs, knobs, moe in tp_parts(torch):
        t_part = time.perf_counter()
        kw = dict(ENGINE, paged_attn_impl="kernel", **knobs)
        sd = sharpened_state(torch, dtype, layers, dev, moe=moe)
        model = _model(torch, dtype, "flash", state_dict=sd, layers=layers,
                       device=dev, moe=moe)
        # the warm burst (kernel libraries loaded, allocator warm) ...
        _tp_burst(torch, dist, LMEngine(model, mesh=mesh, **kw), reqs)
        gc.collect()
        _tp_free(torch, dev)
        # ... then the counted one: every count set to 0 just before it
        eng = LMEngine(model, mesh=mesh, **kw)
        _tp_zero(torch, dist, dev)
        with _moe_drops(torch) as drops:
            got, wall = _tp_burst(torch, dist, eng, reqs)
        _mesh_sync(torch, dev)
        out = _tp_counts(torch, dev)
        out["records"] = eng.tp_records
        out["kv_heads_held"] = next(iter(eng.cache.values()))["k"].shape[0]
        if moe:
            # every rank routes the whole batch: its drops are the leader's
            out["moe_calls"] = len(drops)
            out["moe_dropped_frac"] = (torch.stack(drops).mean().item()
                                       if drops else None)
        if eng.is_leader:
            tokens = sum(len(t) for t in got)
            steps = eng.stats["chunks"] * eng.chunk_steps
            out.update({
                "streams": got, "wall_s": wall, "tokens": tokens,
                "tokens_per_s": tokens / wall,
                "ttft_p50_ms": statistics.median(eng.ttft_ms),
                "decode_step_ms": eng.overlap["decode_gap_ms"] / eng.chunk_steps,
                "chunks": eng.stats["chunks"],
                "prefill_pieces": eng.stats["prefill_pieces"],
                "spec_proposed": eng.stats["spec_proposed"],
                "spec_accepted": eng.stats["spec_accepted"],
                "staged_bytes_per_step": out["staged_bytes"] / max(steps, 1),
                "collective_share": out["collective_s"] / wall,
            })
        del eng, model
        gc.collect()
        _tp_free(torch, dev)
        dist.barrier()
        if rank == 0:
            full = _model(torch, dtype, "flash", state_dict=sd, layers=layers,
                          device=dev, moe=moe)
            want = _engine_streams(torch, full, "kernel", reqs, **knobs)
            if dtype == torch.float32:
                same, bad = _compare_greedy(torch, full, reqs, want, got)
                judged = same
            else:
                judged, bad = _judged(torch, full, reqs, want, got)
                same = want == got
            out.update({"one_rank_streams_equal": same, "judged": judged,
                        "divergences": bad})
            del full
            gc.collect()
            _tp_free(torch, dev)
        dist.barrier()
        del sd
        out["seconds"] = time.perf_counter() - t_part
        res[part] = out
    return res


def phase_tp(torch, state):
    """Tensor-parallel serving in one world of two ranks on this card
    (gloo, ``LOCAL_WORLD_SIZE=2``, collectives staged through pinned host
    memory; spawned once, the kernels built here first), over
    ``MeshSpec(model=2)`` on the paged pool with the kernel, a line a
    part (:func:`tp_parts`): (a) the full-width ``MODEL`` in bf16, the
    serving phase's burst (``N_REQ`` requests, ``MAX_NEW`` new tokens),
    held against the one-rank engine on the same weights by the near-tie
    rule, and (b) at f32 with ``TP_F32_LAYERS`` blocks, token-identical;
    (c) speculative decoding (K=4) on the engine phase's motif prompts,
    against the one-rank K=4 engine, in bf16 and f32 likewise, with
    drafts accepted and verifies (S=5) launched on both ranks; (d) the
    MoE LM (every second FFN ``MoEConfig()``'s), K=0, likewise, each
    rank's mean drop share of its MoE calls the leader's. A line: tokens/s,
    TTFT p50, the decode-step ms (the decode-gap EWMA over the chunk's
    steps), bytes staged a decode step (prefill pieces included), the
    collective share of the burst's wall, paged launches by rank, span,
    shape and body, and peak memory by rank; then ``shapes_not_held``,
    which fails the phase when a shape the ranks launched the paged kernel
    at has no kernels-phase case. Two ranks sharing one card and the host
    link say nothing of a multi-card TP server."""
    from kubeflow_tpu_torch.core.distributed import launch

    t0 = time.perf_counter()
    ranks = sorted(launch(_tp_rank, TP_RANKS, timeout_s=900.0, pg_timeout_s=300.0),
                   key=lambda r: r["rank"])
    ok = True
    launched: dict[str, int] = {}
    for part, dtype, layers, reqs, knobs, moe in tp_parts(torch):
        rows = [r[part] for r in ranks]
        lead = rows[0]
        heads = MODEL["n_heads"] // TP_RANKS
        good = (lead["judged"] and all(x["paged_launches"] > 0 for x in rows)
                and all(x["kv_heads_held"] == heads for x in rows)
                and len({x["records"] for x in rows}) == 1)
        if dtype == torch.float32:
            good &= lead["one_rank_streams_equal"]
        extra = {}
        if knobs.get("spec_draft_tokens"):
            good &= (lead["spec_accepted"] > 0
                     and all(x["paged_by_s"].get(SPEC_K + 1, 0) > 0 for x in rows))
            extra = {k: lead[k] for k in ("spec_proposed", "spec_accepted")}
        if moe:
            good &= (lead["moe_calls"] > 0
                     and len({(x["moe_calls"], x["moe_dropped_frac"])
                              for x in rows}) == 1)
            extra = {k: lead[k] for k in ("moe_calls", "moe_dropped_frac")}
        for x in rows:
            for k, n in x["paged_by_shape"].items():
                launched[k] = launched.get(k, 0) + n
        ok &= good
        emit({"phase": "tp", "part": part, "ok": good,
              "mesh": {"model": TP_RANKS}, "dtype": _dtname(torch, dtype),
              "layers": layers, "moe": moe, **knobs,
              "requests": len(reqs), "max_new": MAX_NEW,
              "one_rank_streams_equal": lead["one_rank_streams_equal"],
              "judged_by_near_tie": dtype != torch.float32, "near_tie": NEAR_TIE,
              "divergences": lead["divergences"],
              **{k: lead[k] for k in (
                  "tokens", "wall_s", "tokens_per_s", "ttft_p50_ms",
                  "decode_step_ms", "chunks", "prefill_pieces",
                  "staged_bytes_per_step", "collective_share")},
              **extra, "records": lead["records"], "seconds": lead["seconds"],
              "by_rank": [{k: x[k] for k in (
                  "paged_launches", "paged_by_s", "paged_by_shape",
                  "paged_by_body", "staged_bytes", "collective_s",
                  "collective_calls", "peak_gb", "kv_heads_held")}
                  for x in rows]})
    held = {paged_case_key(torch, c) for _, c in paged_cases(torch)}
    unheld = sorted(set(launched) - held)
    ok &= not unheld
    state["tp_launches_by_shape"] = launched
    backend = sorted({r["backend"] for r in ranks})
    emit({"phase": "tp", "ok": bool(ok), "ranks": TP_RANKS, "backend": backend,
          "host_staged": backend == ["gloo"], "launches_by_shape": launched,
          "shapes_not_held": unheld, "seconds": time.perf_counter() - t0,
          "note": "two ranks share one card and its host link: no figure "
                  "here says anything of a multi-card TP server"})
    return ok


# --------------------------------------------------------------------------- #
# phase 16: JAXJobs on the port's control plane
# --------------------------------------------------------------------------- #

#: each job's limit (seconds)
JOB_TIMEOUT_S = 240
#: the checkout's root: every worker imports the package from it
REPO = os.path.dirname(os.path.abspath(__file__))
#: (d): Katib trials as jobs under a quota of two cards' worth of chips.
#: Three trials are in flight at once, so the quota, not the controller,
#: holds the card to two trainers and the third waits in the queue.
JOB_TRIALS, JOB_TRIAL_PARALLEL, JOB_TRIAL_STEPS, JOB_QUOTA = 4, 3, 8, 2
#: (e): the borrower's steps (enough to outlast the preemption notice)
PREEMPT_STEPS = 200


class _ClusterRecord:
    """What phase 16 reads of a ``LocalCluster`` as it happens: the
    conditions each job turns on, in order, with their reasons and times
    (taken as the controller writes the job store), each worker's env at
    each launch, each worker's exit code an attempt, the most gangs the
    scheduler held at once, and the controller's passes since
    (``kft_reconcile_seconds``)."""

    def __init__(self, cluster):
        from kubeflow_tpu_torch.orchestrator.cluster import SYNC_SECONDS

        self._sync = SYNC_SECONDS._default_child()
        self._sync0 = (self._sync.count, self._sync.total)
        self.conditions: dict[str, list] = {}
        self.envs: dict[tuple[str, int], dict] = {}
        self.exits: dict[tuple[str, int], int] = {}
        self.max_held = 0
        self._on: dict[str, dict] = {}
        update, mutate = cluster.jobs.update, cluster.workers.mutate
        start, admit = cluster.launcher.start, cluster.scheduler._admit_locked

        def on_update(key, obj):
            on = self._on.setdefault(key, {})
            for c in obj.status.conditions:
                now = (c.status, c.reason)
                if c.status and on.get(c.type.value) != now:
                    self.conditions.setdefault(key, []).append(
                        (c.type.value, c.reason, time.time()))
                on[c.type.value] = now
            return update(key, obj)

        def on_mutate(key, fn):
            w = mutate(key, fn)
            if w.exit_code is not None:
                self.exits[(key, w.restarts)] = w.exit_code
            return w

        def on_start(worker, command, env):
            self.envs[(worker.key, worker.restarts)] = dict(env)
            return start(worker, command, env)

        def on_admit(group):
            ok = admit(group)
            if ok:
                self.max_held = max(self.max_held, len(cluster.scheduler._held))
            return ok

        cluster.jobs.update, cluster.workers.mutate = on_update, on_mutate
        cluster.launcher.start, cluster.scheduler._admit_locked = on_start, on_admit

    def trail(self, uid):
        return [(t, r) for t, r, _ in self.conditions.get(uid, [])]

    def reconcile(self):
        """The controller's passes since this record began, and their mean
        and total ms (``kft_reconcile_seconds``)."""
        n = self._sync.count - self._sync0[0]
        total = self._sync.total - self._sync0[1]
        return {"passes": n, "ms_mean": total / n * 1e3 if n else None,
                "ms_total": total * 1e3}

    def when(self, uid, ctype, reason):
        return next((at for t, r, at in self.conditions.get(uid, [])
                     if (t, r) == (ctype, reason)), None)


def _gpu_cluster(root, **kw):
    """A port ``LocalCluster`` whose workers inherit this host's CUDA
    env (``WiringConfig(platform="gpu")``), and its record."""
    from kubeflow_tpu_torch.orchestrator import LocalCluster
    from kubeflow_tpu_torch.orchestrator.envwire import WiringConfig

    cluster = LocalCluster(wiring=WiringConfig(platform="gpu"), base_dir=root,
                           resync_period=0.05, restart_backoff_base=0.05, **kw)
    return cluster, _ClusterRecord(cluster)


def _job_manifest(name, module, argv, replicas=2):
    """A JAXJob of ``kubeflow_tpu/examples/manifests/base/mnist_job.yaml``'s
    shape running ``kubeflow_tpu_torch.examples.<module>``."""
    return {"kind": "JAXJob", "metadata": {"name": name}, "spec": {
        "jaxReplicaSpecs": {"Worker": {"replicas": replicas, "template": {"spec": {
            "containers": [{
                "name": "torch",
                "command": [sys.executable, "-m",
                            f"kubeflow_tpu_torch.examples.{module}", *argv],
                "env": [{"name": "PYTHONPATH", "value": REPO}]}]}}}}}}


def _kv_line(log, prefix):
    """``{key: float value}`` of the ``key=value`` pairs on the first line
    of ``log`` that starts with ``prefix``."""
    import re

    line = next((x for x in log.splitlines() if x.startswith(prefix)), "")
    return {k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", line)}


def _shared_card_env(record, uid, ranks):
    """Each launch of the job's workers had the shared-card wiring: the
    job's ranks in ``LOCAL_WORLD_SIZE`` and no card of its own."""
    envs = [e for (k, _), e in record.envs.items() if k.startswith(f"{uid}/")]
    return len(envs) >= ranks and all(
        e.get("LOCAL_WORLD_SIZE") == str(ranks) and "JAX_LOCAL_DEVICE_IDS" not in e
        for e in envs)


def _job_workers(torch, state, root):
    """(a)–(c): the MNIST and multislice workers, each run a JAXJob; (c)
    runs beside (a), (b) after (a), from its checkpoint. A part's seconds
    run from its submission to its last condition."""
    from kubeflow_tpu_torch.orchestrator import kinds
    from kubeflow_tpu_torch.train.metrics import parse_stdout_metrics

    ckpt = os.path.join(root, "ckpt")
    flow = [("Created", "JobCreated"), ("Running", "AllWorkersRunning"),
            ("Succeeded", "AllWorkersSucceeded")]
    cluster, record = _gpu_cluster(os.path.join(root, "abc"))

    def submit(name, module, argv):
        return cluster.submit(kinds.from_manifest(
            _job_manifest(name, module, argv))), time.time()

    def finished(uid, t0):
        """(the job's status, its two workers' logs and attempt-0 exit
        codes, whether its conditions and envs were right, a line's
        common fields)"""
        status = cluster.wait(uid, timeout=JOB_TIMEOUT_S)
        logs = [cluster.logs(uid, "worker", i) for i in range(2)]
        rcs = [record.exits.get((f"{uid}/worker-{i}", 0)) for i in range(2)]
        good = (status.phase == "Succeeded" and rcs == [0, 0]
                and record.trail(uid) == flow and _shared_card_env(record, uid, 2))
        return logs, good, {
            "returncodes": rcs, "conditions": record.trail(uid),
            "local_world_size_2_no_card_ids": _shared_card_env(record, uid, 2),
            "seconds": (status.completion_time or time.time()) - t0,
            "card": state["card"]}

    def mnist(steps):
        return submit(f"mnist-{steps}", "mnist", [
            "--steps", str(steps), "--global-batch", "32", "--log-every", "2",
            "--lr", "3e-3", "--checkpoint-dir", ckpt, "--checkpoint-every", "3"])

    lines = []
    with cluster:
        jobs = {"a_mnist": mnist(6), "c_multislice": submit(
            "multislice", "multislice", ["--steps", "4", "--seq-len", "64"])}
        for part in ("a_mnist", "b_resume", "c_multislice"):
            if part == "b_resume":
                jobs[part] = mnist(8)
            logs, good, common = finished(*jobs[part])
            if part == "c_multislice":
                oks = ("dcn placement ok: 2 slices x 1 devices",
                       "cross-slice psum ok: 3.0", "multislice training ok: steps=4")
                good &= (all(x in logs[0] for x in oks)
                         and oks[0] in logs[1] and oks[2] not in logs[1])
                line = {"ok_lines_rank0": [x for x in oks if x in logs[0]],
                        "attn_impl": "reference"}
            else:
                m0, m1 = parse_stdout_metrics(logs[0]), parse_stdout_metrics(logs[1])
                final = _kv_line(logs[0], "final_loss=")
                good &= ([m["step"] for m in m0] == ([2, 4, 6] if part == "a_mnist"
                                                    else [8])
                         and m1 == [] and "final_loss=" not in logs[1] and bool(final)
                         and all("1 local / 2 global cuda devices (backend gloo)"
                                 in x for x in logs))
                if part == "a_mnist":
                    good &= len(m0) == 3 and m0[-1]["loss"] < m0[0]["loss"]
                    good &= any(os.scandir(ckpt))
                else:
                    good &= all("resume_step=6" in x for x in logs)
                line = {"rank0_metric_steps": [m["step"] for m in m0],
                        "rank1_metric_lines": len(m1),
                        "losses": [m["loss"] for m in m0], **final}
            lines.append({"phase": "job", "part": part, "ok": good, **common, **line,
                          **({} if good else {"logs": [x[-3000:] for x in logs]})})
    return lines


def _trial_worker(argv=None) -> int:
    """(d)'s trial: ``Trainer.fit`` of the full-width LM in bf16 over f32
    at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (phase 18's setup, no checkpoint)
    with ``--lr``, printing a ``step=N loss=X`` line a step, then one
    line of its own flash launches (all, and on ``wgmma``) and its ms a
    step (steps 2 .. steps - 1, as phase 18 times them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, required=True)
    ap.add_argument("--steps", type=int, default=JOB_TRIAL_STEPS)
    args = ap.parse_args(argv)
    import torch

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    trainer = Trainer(
        init_params=make_init_fn(cfg), loss_fn=make_loss_fn(),
        optimizer=adamw(args.lr),
        config=TrainConfig(mesh=None, global_batch=TRAIN_BATCH, steps=args.steps,
                           log_every=1, prefetch_depth=2))
    _zero_flash_counts(fa, fb)
    ready = {}
    trainer.fit(_train_data,
                hooks=[lambda step, m: ready.__setitem__(step, time.perf_counter())])
    torch.cuda.synchronize()
    by_body = _flash_counts_by_body(fa, fb)
    S = args.steps
    print(f"trial_kernels flash_forward={fa.LAUNCHES} flash_bwd_dq={fb.DQ_LAUNCHES} "
          f"flash_bwd_dkv={fb.DKV_LAUNCHES} "
          f"wgmma_forward={by_body['flash_forward']['wgmma']} "
          f"wgmma_dq={by_body['flash_bwd_dq']['wgmma']} "
          f"wgmma_dkv={by_body['flash_bwd_dkv']['wgmma']} "
          f"step_ms={(ready[S - 1] - ready[1]) / (S - 2) * 1e3:.6f}", flush=True)
    return 0


TRIAL_WORKER = """import sys
sys.path.insert(0, {repo!r})
import chip_smoke
sys.exit(chip_smoke._trial_worker(sys.argv[1:]))
"""


def _job_trials(torch, state, root):
    """(d): Katib's normal mode on the card. ``ExperimentController`` with
    ``JobTrialRunner`` runs a TPE search of the LM's learning rate, each
    trial a one-worker JAXJob asking one h100 chip in a LocalQueue whose
    ClusterQueue has a quota of two on a fleet of two."""
    import re

    from kubeflow_tpu_torch.orchestrator.resources import Fleet
    from kubeflow_tpu_torch.sched import ClusterQueue, LocalQueue
    from kubeflow_tpu_torch.tune import spec as S
    from kubeflow_tpu_torch.tune.controller import (
        ExperimentController, JobTrialRunner,
    )

    worker = os.path.join(root, "trial_worker.py")
    with open(worker, "w") as f:
        f.write(TRIAL_WORKER.format(repo=REPO))
    template = {
        "replicas": {"worker": {
            "replicas": 1,
            "command": [sys.executable, worker, "--lr", "${trialParameters.lr}",
                        "--steps", str(JOB_TRIAL_STEPS)],
            "env": {"PYTHONPATH": REPO},
            "tpu": {"chips": 1, "generation": "h100"}}},
        "run_policy": {"backoff_limit": 0, "scheduling": {"queue": "trials"}},
    }
    spec = S.ExperimentSpec(
        name="lm-lr-jobs",
        parameters=(S.ParameterSpec("lr", S.ParameterType.DOUBLE, min=1e-4,
                                    max=3e-3, log_scale=True),),
        objective=S.Objective("loss", S.ObjectiveType.MINIMIZE),
        algorithm=S.AlgorithmSpec("tpe", {"n_initial": 2}),
        parallel_trial_count=JOB_TRIAL_PARALLEL, max_trial_count=JOB_TRIALS,
        max_failed_trial_count=0, trial_template=template)
    cluster, record = _gpu_cluster(
        os.path.join(root, "d"), fleet=Fleet.single_host(chips=2, generation="h100"),
        queues=[ClusterQueue("card", {"h100": JOB_QUOTA}),
                LocalQueue("trials", "card")])
    t0 = time.perf_counter()
    with cluster:
        status = ExperimentController(
            spec, JobTrialRunner(cluster, timeout_s=JOB_TIMEOUT_S), seed=0).run()
        wall = time.perf_counter() - t0
        jobs = {j.spec.name: (uid, j) for uid, j in cluster.jobs.list()}
        waits = list(cluster.scheduler._waits.get("card", []))
        trials, launches, wgmma = [], {k: 0 for k in FLASH_KERNELS}, 0
        for t in status.trials:
            uid, job = jobs[f"{spec.name}-{t.assignment.trial_id}"]
            log = cluster.logs(uid, "worker", 0)
            own = re.findall(r"\bloss=(\S+)", log)
            kern = _kv_line(log, "trial_kernels")
            for k in FLASH_KERNELS:
                launches[k] += int(kern.get(k, 0))
            wgmma += sum(int(kern.get(k, 0))
                         for k in ("wgmma_forward", "wgmma_dq", "wgmma_dkv"))
            st = job.status
            trials.append({
                "lr": t.assignment.parameters["lr"], "state": t.state.value,
                "loss": t.metrics.get("loss"), "own_last_loss":
                    float(own[-1]) if own else None,
                "objective": t.metrics.get("__objective__"),
                "queued": ("Queued", "GangPending") in record.trail(uid),
                "seconds": (st.completion_time - st.start_time
                            if st.start_time and st.completion_time else None),
                "step_ms": float(kern["step_ms"]) if "step_ms" in kern else None,
                "env": {k: record.envs.get((f"{uid}/worker-0", 0), {}).get(k)
                        for k in ("LOCAL_WORLD_SIZE", "JAX_LOCAL_DEVICE_IDS")},
                "message": t.message})
    want = JOB_TRIALS * JOB_TRIAL_STEPS * MODEL["n_layers"]
    objs = [t["objective"] for t in trials]
    finite = all(t["loss"] is not None and math.isfinite(t["loss"]) for t in trials)
    best = status.optimal
    argmin = (finite and best is not None
              and best.metrics["__objective__"] == min(objs))
    ok = (len(trials) == JOB_TRIALS and status.succeeded == JOB_TRIALS
          and all(t["state"] == "Succeeded" for t in trials) and finite and argmin
          and all(t["loss"] == t["own_last_loss"] for t in trials)
          and record.max_held <= JOB_QUOTA and any(t["queued"] for t in trials)
          and all(n == want for n in launches.values()) and wgmma == 3 * want)
    state["job_flash_launches"] = launches
    queued_waits = sorted(w for w in waits if w > 0.5)
    return {"phase": "job", "part": "d_trials_as_jobs", "ok": ok,
            "algorithm": "tpe", "trials": trials, "wall_s": wall,
            "trial_seconds": [t["seconds"] for t in trials],
            "worker_step_ms": [t["step_ms"] for t in trials],
            "admission_waits_s": waits, "queued_trial_wait_s": queued_waits,
            "max_admitted": record.max_held, "quota_chips": JOB_QUOTA,
            "trials_in_flight": JOB_TRIAL_PARALLEL, "steps": JOB_TRIAL_STEPS,
            "shape": [TRAIN_BATCH, TRAIN_SEQ], "dtype": "bf16",
            "optimal": best.assignment.parameters if best else None,
            "optimal_is_argmin": argmin, "launches": launches,
            "launches_wgmma": wgmma, "launches_wanted": want,
            "reason": status.reason, "reconcile": record.reconcile(),
            "card": state["card"]}


def _job_preemption(torch, state, root):
    """(e): two ClusterQueues of one h100 chip each in one cohort. A
    low-priority two-worker MNIST job borrows the second chip; a
    one-worker high-priority job in the other queue (a sleeper, as in
    ``tests/test_sched.py``'s preemption case) reclaims it."""
    import re

    from kubeflow_tpu_torch.orchestrator import JobSpec
    from kubeflow_tpu_torch.orchestrator.resources import Fleet
    from kubeflow_tpu_torch.sched import ClusterQueue, LocalQueue
    from kubeflow_tpu_torch.train.metrics import parse_stdout_metrics

    def job(name, argv, replicas, queue, priority):
        """A JAXJob of ``replicas`` workers, a chip each: the MNIST worker
        with ``argv``, or (None) a second's sleep, as the JAX test's
        reclaimer."""
        command = ([sys.executable, "-m", "kubeflow_tpu_torch.examples.mnist", *argv]
                   if argv is not None
                   else [sys.executable, "-c", "import time; time.sleep(1.0)"])
        return JobSpec.from_dict({
            "name": name,
            "replicas": {"worker": {
                "replicas": replicas,
                "command": command,
                "env": {"PYTHONPATH": REPO}, "restart_policy": "ExitCode",
                "tpu": {"chips": 1, "generation": "h100"}}},
            "run_policy": {"scheduling": {"queue": queue, "priority": priority}}})

    cluster, record = _gpu_cluster(
        os.path.join(root, "e"), fleet=Fleet.single_host(chips=2, generation="h100"),
        queues=[ClusterQueue("low", {"h100": 1}, cohort="card"),
                ClusterQueue("high", {"h100": 1}, cohort="card"),
                LocalQueue("team-low", "low"), LocalQueue("team-high", "high")],
        preemption_grace_seconds=120.0)  # the checkpoint is never cut
    t0 = time.perf_counter()
    resumed_at = None
    with cluster:
        low = cluster.submit(job(
            "borrower", ["--steps", str(PREEMPT_STEPS), "--global-batch", "64",
                         "--log-every", "1", "--lr", "3e-3",
                         "--checkpoint-dir", os.path.join(root, "e-ckpt"),
                         "--checkpoint-every", "100"], 2, "team-low", 0))
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while time.monotonic() < deadline:  # the borrower's progress, not a clock
            log = cluster.logs(low, "worker", 0, attempt=0)
            if any(m["step"] >= 10 for m in parse_stdout_metrics(log)):
                break
            if cluster.status(low).finished:
                break
            time.sleep(0.05)
        high = cluster.submit(job("reclaimer", None, 1, "team-high", 10))
        deadline = time.monotonic() + 2 * JOB_TIMEOUT_S
        while time.monotonic() < deadline and not cluster.status(low).finished:
            if resumed_at is None and parse_stdout_metrics(
                    cluster.logs(low, "worker", 0, attempt=1)):
                resumed_at = time.time()
            time.sleep(0.02)
        high_status = cluster.wait(high, timeout=JOB_TIMEOUT_S)
        low_status = cluster.wait(low, timeout=JOB_TIMEOUT_S)
        low_job = cluster.get(low)
        logs0 = [cluster.logs(low, "worker", i, attempt=0) for i in range(2)]
        logs1 = [cluster.logs(low, "worker", i, attempt=1) for i in range(2)]
    secs = time.perf_counter() - t0
    trail = record.trail(low)
    order = [("Restarting", "Preempting"), ("Restarting", "Preempted"),
             ("Queued", "GangPending")]
    at = [trail.index(x) if x in trail else -1 for x in order]
    preempted = [re.search(r"preempted at step (\d+)", x) for x in logs0]
    resumed = [re.search(r"resume_step=(\d+)", x) for x in logs1]
    step0 = int(preempted[0].group(1)) if preempted[0] else None
    first1 = [m["step"] for m in parse_stdout_metrics(logs1[0])][:1]
    exits0 = [record.exits.get((f"{low}/worker-{i}", 0)) for i in range(2)]
    notice = record.when(low, "Restarting", "Preempting")
    ok = (high_status.phase == "Succeeded" and low_status.phase == "Succeeded"
          and min(at) >= 0 and at == sorted(at)
          and trail[-1] == ("Succeeded", "AllWorkersSucceeded")
          and exits0 == [143, 143] and all(preempted)
          and all(m and int(m.group(1)) == step0 for m in resumed)
          and step0 is not None and first1 == [step0 + 1]
          and low_status.restart_count == 0 and low_job.next_restart_at == 0.0
          and _shared_card_env(record, low, 2))
    return {"phase": "job", "part": "e_preemption", "ok": ok,
            "conditions": trail, "exit_codes_attempt0": exits0,
            "preempted_at_step": step0,
            "resume_steps": [int(m.group(1)) if m else None for m in resumed],
            "first_resumed_step": first1, "restart_count": low_status.restart_count,
            "backoff_next_restart_at": low_job.next_restart_at,
            "high_phase": high_status.phase,
            "notice_to_resumed_step_s": (resumed_at - notice
                                         if resumed_at and notice else None),
            "seconds": secs, "reconcile": record.reconcile(), "card": state["card"],
            **({} if ok else {"logs0": [x[-2000:] for x in logs0],
                              "logs1": [x[-2000:] for x in logs1]})}


def phase_job(torch, state):
    """JAXJobs on the port's control plane (``kubeflow_tpu_torch/
    orchestrator``, ``sched``), each worker a process on this card wired
    by ``WiringConfig(platform="gpu")``: the job's ranks share the card,
    so ``LOCAL_WORLD_SIZE`` is their count and no rank names a card of its
    own (gloo). (a) ``examples/mnist.py`` as a two-worker JAXJob, 6 steps
    of 32 with a checkpoint every 3 (the JAX ``test_e2e_mnist`` run): both
    exit 0, the conditions run Created → Running → Succeeded, the metrics
    of steps 2, 4 and 6 only on rank 0, the loss falls, a checkpoint is
    written; (b) the same to 8 steps: both ranks resume at step 6 and rank
    0 logs step 8 alone; (c) ``examples/multislice.py``, 4 steps at
    sequence 64, beside (a): its three ``ok`` lines; (d) Katib trials as jobs under a
    quota (``_job_trials``): every trial Succeeded with a finite loss, the
    scraped loss its worker's own last one, the optimum the argmin, never
    more than two trials admitted and one waiting in the queue, each flash
    kernel launched once a layer a step over all the trials, on
    ``wgmma``; (e) preemption (``_job_preemption``): the borrower goes
    through Restarting (Preempting, then Preempted) and Queued, its workers
    exit 143 after a forced checkpoint, the reclaimer succeeds, the
    borrower is readmitted, resumes at the step it saved and succeeds with
    neither a restart nor backoff counted. A line a part with its seconds
    (process start and CUDA set-up included) and the card."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="kft-job-")
    ok = True
    try:
        for part in (lambda: _job_workers(torch, state, root),
                     lambda: [_job_trials(torch, state, root)],
                     lambda: [_job_preemption(torch, state, root)]):
            for line in part():
                ok &= line["ok"]
                emit(line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ok


# --------------------------------------------------------------------------- #
# phase 17: the tabular predictors and ModelMesh
# --------------------------------------------------------------------------- #

#: the checkpoints phase 17 writes (seeded), at the published widths of
#: the datasets such boosters are trained on: HIGGS (28 features) and
#: Covertype (54 features, 7 classes)
TABULAR = dict(
    higgs_features=28, higgs_trees=1000, cover_features=54, cover_classes=7,
    cover_rounds=200, forest_trees=100, depth=8,
)
TAB_ROWS = (1, 64, 4096)
TAB_NAN = 0.01  # share of missing (NaN) features in a request
TAB_REL, TAB_ABS = 1e-5, 1e-6  # served error bound: REL * sum|leaf| + ABS
TAB_REPS = {1: 20, 64: 20, 4096: 10}


def _tab_tree(rng, n_feat, depth):
    """One random regression tree in breadth-first node order: every node
    above depth 3 splits, a deeper one stops early with probability 0.1,
    and nothing splits past ``depth``. Lists of (feature, threshold,
    default_left, left, right, leaf value); children -1 at a leaf."""
    n_max = 2 ** (depth + 1) - 1
    feats = rng.integers(0, n_feat, n_max)
    thr = rng.normal(size=n_max).astype("float32")
    dl = rng.random(n_max) < 0.5
    stop = rng.random(n_max) < 0.1
    val = (0.1 * rng.normal(size=n_max)).astype("float32")
    dep, left, right = [0], [], []
    i = 0
    while i < len(dep):
        if dep[i] < depth and (dep[i] < 3 or not stop[i]):
            left.append(len(dep))
            right.append(len(dep) + 1)
            dep += [dep[i] + 1, dep[i] + 1]
        else:
            left.append(-1)
            right.append(-1)
        i += 1
    n = len(dep)
    leaf = [c == -1 for c in left]
    return dict(
        feat=[0 if leaf[k] else int(feats[k]) for k in range(n)],
        thresh=[float(val[k]) if leaf[k] else float(thr[k]) for k in range(n)],
        default_left=[bool(dl[k]) for k in range(n)], left=left, right=right,
        leaf=leaf)


def _xgb_doc(trees, *, n_feat, num_class, objective):
    """An XGBoost ``save_model("model.json")`` document."""
    return {"version": [2, 0, 0], "learner": {
        "learner_model_param": {"base_score": "5E-1", "num_class": str(num_class),
                                "num_feature": str(n_feat)},
        "objective": {"name": objective},
        "gradient_booster": {"model": {
            "trees": [{"split_indices": t["feat"], "split_conditions": t["thresh"],
                       "left_children": t["left"], "right_children": t["right"],
                       "default_left": [int(d) for d in t["default_left"]],
                       "base_weights": [0.0] * len(t["left"]),
                       "tree_param": {"num_nodes": str(len(t["left"]))}}
                      for t in trees],
            "tree_info": [i % max(1, num_class) for i in range(len(trees))]}}}}


def _lgb_text(trees, rng, *, n_feat):
    """A LightGBM ``save_model("model.txt")`` booster of ``trees`` (binary):
    internal nodes and leaves numbered apart, a leaf child as ``-leaf-1``,
    ``<=`` thresholds as doubles, a mix of NaN-missing and None-missing
    ``decision_type``s. Returns the text and the trees in that layout."""
    lines = ["tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
             "label_index=0", f"max_feature_idx={n_feat - 1}",
             "objective=binary sigmoid:1",
             "feature_names=" + " ".join(f"f{i}" for i in range(n_feat)), ""]
    out = []
    for ti, t in enumerate(trees):
        internal = [k for k in range(len(t["left"])) if not t["leaf"][k]]
        leaves = [k for k in range(len(t["left"])) if t["leaf"][k]]
        inner = {k: i for i, k in enumerate(internal)}
        lidx = {k: i for i, k in enumerate(leaves)}

        def ref(k):
            return inner[k] if k in inner else -lidx[k] - 1

        lt = dict(
            num_leaves=len(leaves),
            split_feature=[t["feat"][k] for k in internal],
            threshold=[float(t["thresh"][k]) + 1e-9 * float(rng.normal())
                       for k in internal],
            decision_type=[int(rng.choice([0, 2, 8, 10])) for _ in internal],
            left_child=[ref(t["left"][k]) for k in internal],
            right_child=[ref(t["right"][k]) for k in internal],
            leaf_value=[t["thresh"][k] for k in leaves])
        out.append(lt)
        lines += [f"Tree={ti}", f"num_leaves={lt['num_leaves']}", "num_cat=0"]
        for key in ("split_feature", "threshold", "decision_type", "left_child",
                    "right_child", "leaf_value"):
            lines.append(f"{key}=" + " ".join(repr(v) for v in lt[key]))
        lines.append("")
    lines += ["end of trees", ""]
    return "\n".join(lines), out


def _lgb_oracle(trees, x):
    """LightGBM's own traversal (``<=``, negative-child leaves, NaN by
    ``decision_type``) of binary ``trees``: the margins of rows ``x``."""
    out = []
    for row in x:
        s = 0.0
        for t in trees:
            node = 0
            while node >= 0:
                v = row[t["split_feature"][node]]
                dt = t["decision_type"][node]
                if math.isnan(v):
                    go_left = (bool(dt & 2) if ((dt >> 2) & 3) == 2
                               else 0.0 <= t["threshold"][node])
                else:
                    go_left = v <= t["threshold"][node]
                node = t["left_child" if go_left else "right_child"][node]
            s += t["leaf_value"][-node - 1]
        out.append(s)
    return out


def _pmml_node(t, k, pred):
    if t["leaf"][k]:
        return f'<Node score="{t["thresh"][k]!r}">{pred}</Node>'
    f, v = t["feat"][k], repr(t["thresh"][k])
    return (f"<Node>{pred}"
            + _pmml_node(t, t["left"][k], f'<SimplePredicate field="x{f}" '
                         f'operator="lessOrEqual" value="{v}"/>')
            + _pmml_node(t, t["right"][k], f'<SimplePredicate field="x{f}" '
                         f'operator="greaterThan" value="{v}"/>')
            + "</Node>")


def _pmml_header(n_feat):
    return ('<?xml version="1.0"?><PMML xmlns="http://www.dmg.org/PMML-4_4" '
            'version="4.4"><DataDictionary>'
            + "".join(f'<DataField name="x{i}" optype="continuous" dataType="double"/>'
                      for i in range(n_feat))
            + '<DataField name="y" optype="continuous" dataType="double"/>'
            "</DataDictionary>")


def _pmml_forest(trees, n_feat):
    """A PMML ``MiningModel`` summing ``trees`` (each a ``TreeModel``)."""
    schema = ("<MiningSchema>" + "".join(f'<MiningField name="x{i}"/>'
                                         for i in range(n_feat))
              + '<MiningField name="y" usageType="target"/></MiningSchema>')
    return (_pmml_header(n_feat) + f'<MiningModel functionName="regression">{schema}'
            '<Segmentation multipleModelMethod="sum">'
            + "".join('<Segment><True/><TreeModel functionName="regression">'
                      + _pmml_node(t, 0, "<True/>") + "</TreeModel></Segment>"
                      for t in trees)
            + "</Segmentation></MiningModel></PMML>")


def _pmml_logistic(W, b, n_feat):
    """A logistic PMML ``RegressionModel``: sigmoid(x @ W + b)."""
    return (_pmml_header(n_feat)
            + '<RegressionModel functionName="classification" '
            'normalizationMethod="logit"><MiningSchema>'
            '<MiningField name="y" usageType="target"/></MiningSchema>'
            f'<RegressionTable intercept="{float(b)!r}" targetCategory="1">'
            + "".join(f'<NumericPredictor name="x{i}" coefficient="{float(w)!r}"/>'
                      for i, w in enumerate(W))
            + "</RegressionTable></RegressionModel></PMML>")


def tabular_checkpoints(root):
    """Write phase 17's seeded checkpoints under ``root``: ``{name: (format,
    directory, features, extra)}``, the LightGBM trees and the logistic
    weights in ``extra`` for their oracles."""
    import os

    import numpy as np

    cfg = TABULAR
    rng = np.random.default_rng(17)
    out = {}

    def put(name, fmt, filename, text, n_feat, extra=None):
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, filename), "w") as f:
            f.write(text)
        out[name] = (fmt, d, n_feat, extra)

    F, D = cfg["higgs_features"], cfg["depth"]
    higgs = [_tab_tree(rng, F, D) for _ in range(cfg["higgs_trees"])]
    put("higgs_xgb", "xgboost", "model.json", json.dumps(_xgb_doc(
        higgs, n_feat=F, num_class=0, objective="binary:logistic")), F)
    Fc, C = cfg["cover_features"], cfg["cover_classes"]
    cover = [_tab_tree(rng, Fc, D) for _ in range(C * cfg["cover_rounds"])]
    put("covtype_xgb", "xgboost", "model.json", json.dumps(_xgb_doc(
        cover, n_feat=Fc, num_class=C, objective="multi:softprob")), Fc)
    text, lgb_trees = _lgb_text([_tab_tree(rng, F, D) for _ in range(cfg["higgs_trees"])],
                                rng, n_feat=F)
    put("higgs_lgb", "lightgbm", "model.txt", text, F, lgb_trees)
    put("forest_pmml", "pmml", "model.pmml", _pmml_forest(
        [_tab_tree(rng, F, D) for _ in range(cfg["forest_trees"])], F), F)
    W, b = 0.3 * rng.normal(size=F), float(rng.normal())
    put("logit_pmml", "pmml", "model.pmml", _pmml_logistic(W, b, F), F, (W, b))
    return out


def _tab_rows(n, n_feat, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
    x[rng.random(x.shape) < TAB_NAN] = np.nan
    return x


def _tab_reference(torch, model, x, extra):
    """The plain reference of ``model`` on rows ``x``, on the host:
    ``(outputs, class outputs, per-output error bound, extra numbers)``.
    Trees: :func:`leaves_numpy`'s leaves (``margin_numpy``'s rule), the
    leaf values summed in f64 and the objective's link; the bound is
    ``TAB_REL`` x the sum of |leaf value| on the row's paths (per class
    for margins, over the row for probabilities) + ``TAB_ABS``. The
    logistic model: sigmoid of an f64 product, bound from sum |x_i w_i|."""
    import numpy as np

    from kubeflow_tpu_torch.serve.xgboost_runtime import _base_margin, leaves_numpy

    if extra is not None and isinstance(extra, tuple):  # the logistic table
        W, b = extra
        terms = x.astype(np.float64) * W[None, :]
        margin = terms.sum(1) + b
        out = 1.0 / (1.0 + np.exp(-margin))
        scale = np.abs(terms).sum(1) + abs(b)
        return out, margin > 0, TAB_REL * scale + TAB_ABS, {}
    bst = model.booster if hasattr(model, "booster") else None
    if bst is None:
        bst = model.predictor.booster
    leaves = leaves_numpy(bst, x)  # (T, B)
    vals = np.take_along_axis(bst.leaf_value, leaves, axis=1).astype(np.float64)
    C = bst.num_class
    margin = np.zeros((x.shape[0], C))
    scale = np.zeros((x.shape[0], C))
    for c in range(C):
        rows = bst.tree_class == c
        margin[:, c] = vals[rows].sum(0)
        scale[:, c] = np.abs(vals[rows]).sum(0)
    margin += _base_margin(bst)
    if bst.objective.startswith("binary:logistic"):
        out = 1.0 / (1.0 + np.exp(-margin[:, 0]))
        return out, margin[:, 0] > 0, TAB_REL * scale[:, 0] + TAB_ABS, {"leaves": leaves}
    if bst.objective == "multi:softprob":
        e = np.exp(margin - margin.max(1, keepdims=True))
        bound = TAB_REL * scale.sum(1, keepdims=True) + TAB_ABS
        return (e / e.sum(1, keepdims=True), margin.argmax(1),
                np.broadcast_to(bound, margin.shape), {"leaves": leaves})
    return margin[:, 0], None, TAB_REL * scale[:, 0] + TAB_ABS, {"leaves": leaves}


def _tab_classes(out):
    import numpy as np

    out = np.asarray(out)
    return out.argmax(1) if out.ndim == 2 else out > 0.5


def _tab_v2(x):
    return {"inputs": [{"name": "x", "shape": list(x.shape), "datatype": "FP32",
                        "data": x.reshape(-1).tolist()}]}


def _tab_profile(torch, model, x):
    """One predict under ``torch.profiler`` (a warm-up step first, whose
    events the schedule discards): its kernels and copies on the device,
    its kernel launches and copies as the host issued them (CUDA runtime
    calls), and the device's busy ms."""
    from torch.profiler import ProfilerActivity, profile, schedule

    model.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            model.predict(x)
            torch.cuda.synchronize()
            prof.step()
    n, busy, top = _device_summary(prof)
    copies = sum(c for name, (c, _) in top if name.startswith(("Memcpy", "Memset")))
    calls = [e.name for e in prof.events() if e.name.startswith(("cudaLaunchKernel",
                                                                 "cudaMemcpy"))]
    return {"device_ops": n, "kernels": n - copies, "copies": copies,
            "launch_calls": sum(c.startswith("cudaLaunchKernel") for c in calls),
            "copy_calls": sum(c.startswith("cudaMemcpy") for c in calls),
            "busy_ms": busy}


def _tab_serve(torch, state, ckpts, dev):
    """(a) every tabular checkpoint behind one ``ModelServer``: v1 and v2 at
    each of ``TAB_ROWS``, held against the plain reference; the direct
    walk's leaves and margins at the largest batch; p50s, launches,
    busy share and resident bytes. Returns (ok, the loaded models)."""
    import numpy as np

    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.spec import PredictorSpec
    from kubeflow_tpu_torch.serve.xgboost_runtime import (
        _base_margin, build_device_predict, margin_numpy)

    reg = default_registry()
    models = {}
    for name, (fmt, path, _, _) in ckpts.items():
        t0 = time.perf_counter()
        rt = reg.resolve(PredictorSpec(model_format=fmt))
        m = rt.factory(name, path, device=dev)
        m.load()
        models[name] = (m, rt.name, (time.perf_counter() - t0) * 1e3)
    srv = ModelServer([m for m, _, _ in models.values()], http_port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    ok = True
    try:
        for name, (fmt, path, n_feat, extra) in ckpts.items():
            m, runtime, load_ms = models[name]
            walk = getattr(m, "walk", None) or m.predictor
            line = {"phase": "tabular", "part": "a_serve", "model": name,
                    "runtime": runtime, "card": state["card"], "load_ms": load_ms,
                    "features": n_feat, "resident_bytes": walk.resident_bytes}
            if hasattr(walk, "booster"):
                b = walk.booster
                line.update(trees=b.n_trees, classes=b.num_class, depth=b.max_depth,
                            nodes_a_tree=int(b.feat.shape[1]))
            worst, mism, ties, by_rows = 0.0, 0, 0, {}
            for n in TAB_ROWS:
                x = _tab_rows(n, n_feat, seed=n)
                want, classes, bound, info = _tab_reference(torch, m, x, extra)
                _, _, t1 = _http(base, "POST", f"/v1/models/{name}:predict",
                                 {"instances": x.tolist()})
                _, _, t2 = _http(base, "POST", f"/v2/models/{name}/infer", _tab_v2(x))
                v1 = np.asarray(json.loads(t1)["predictions"], np.float64)
                o2 = json.loads(t2)["outputs"][0]
                v2 = np.asarray(o2["data"], np.float64).reshape(o2["shape"])
                same = v1.shape == want.shape and np.array_equal(v1, v2, equal_nan=True)
                nan_ok = np.array_equal(np.isnan(v1), np.isnan(want))
                fin = ~np.isnan(want)
                err = np.abs(v1 - want)[fin] / np.asarray(bound)[fin]
                worst = max(worst, float(err.max()) if err.size else 0.0)
                if classes is not None:
                    got_cls = _tab_classes(np.where(np.isnan(v1), 0.0, v1))
                    bad = np.flatnonzero(got_cls != np.asarray(classes))
                    if want.ndim == 2:  # a flip is a tie when the top-2 gap is in the bound
                        top2 = np.sort(want, 1)[:, -2:]
                        tie = (top2[:, 1] - top2[:, 0]) <= 2 * np.asarray(bound)[:, 0]
                    else:
                        tie = np.abs(want - 0.5) <= np.asarray(bound)
                    bad = bad[fin[bad] if want.ndim == 1 else fin[bad].all(-1)]
                    ties += int(tie[bad].sum())
                    mism += int((~tie[bad]).sum())
                ok_n = same and nan_ok and (err <= 1.0).all()
                by_rows[str(n)] = {"v1_eq_v2": bool(same), "nan_rows_match": bool(nan_ok),
                                   "max_err_over_bound": float(err.max()) if err.size else 0.0,
                                   "rows_with_nan": int(np.isnan(x).any(1).sum())}
                ok &= bool(ok_n)
                if "leaves" in info and n == TAB_ROWS[-1]:
                    # the walk itself: final cursors against the plain walk
                    lv = walk.leaves(x)
                    line["leaves_equal"] = bool(np.array_equal(lv, info["leaves"]))
                    mw = build_device_predict(walk.booster, "margin", device=dev)
                    got = mw(x).cpu().numpy().astype(np.float64)
                    vals = np.take_along_axis(walk.booster.leaf_value, lv, 1)
                    mref = np.zeros_like(got)
                    mscale = np.zeros_like(got)
                    for c in range(walk.booster.num_class):
                        sel = walk.booster.tree_class == c
                        mref[:, c] = vals[sel].astype(np.float64).sum(0)
                        mscale[:, c] = np.abs(vals[sel]).sum(0)
                    mref += _base_margin(walk.booster)
                    merr = np.abs(got - mref) / (TAB_REL * mscale + TAB_ABS)
                    line["margin_max_err_over_bound"] = float(merr.max())
                    # the vectorised walk is margin_numpy's rule, row by row
                    line["margin_numpy_rows_agree"] = bool(np.allclose(
                        margin_numpy(walk.booster, x[:8]), mref[:8], rtol=0, atol=1e-9))
                    ok &= (line["leaves_equal"] and line["margin_max_err_over_bound"] <= 1.0
                           and line["margin_numpy_rows_agree"])
                    if fmt == "lightgbm":  # LightGBM's own <= walk on a few rows
                        lg = np.asarray(_lgb_oracle(extra, x[:16].astype(np.float64)))
                        line["lightgbm_oracle_max_err"] = float(np.abs(lg - mref[:16, 0]).max())
                        ok &= line["lightgbm_oracle_max_err"] <= 1e-6
            line["served"] = by_rows
            line["max_err_over_bound"] = worst
            line["class_mismatches"], line["class_ties"] = mism, ties
            ok &= mism == 0
            # timing: the runtime's predict (upload, walk, copy back) and a
            # v1 request through the server, by batch size
            p50, http_p50, prof = {}, {}, {}
            for n in TAB_ROWS:
                x = _tab_rows(n, n_feat, seed=100 + n)
                ms = []
                for _ in range(TAB_REPS[n]):
                    t0 = time.perf_counter()
                    m.predict(x)
                    ms.append((time.perf_counter() - t0) * 1e3)
                p50[str(n)] = statistics.median(ms)
                body = {"instances": x.tolist()}
                hs = []
                for _ in range(max(3, TAB_REPS[n] // 4)):
                    t0 = time.perf_counter()
                    _http(base, "POST", f"/v1/models/{name}:predict", body)
                    hs.append((time.perf_counter() - t0) * 1e3)
                http_p50[str(n)] = statistics.median(hs)
                if dev != "cpu":
                    pr = _tab_profile(torch, m, x)
                    pr["busy_share"] = pr["busy_ms"] / p50[str(n)]
                    prof[str(n)] = pr
            line.update(predict_p50_ms=p50, http_p50_ms=http_p50, profile=prof)
            line["ok"] = bool(ok)
            emit(line)
    finally:
        srv.stop()
    return ok


def _tab_mesh(torch, state, ckpts, dev):
    """(b) a ModelMesh over the card: 8 ``kubeflow-tpu-bert-tiny``
    predictors (weights from seeds 0-7) and the two XGBoost boosters
    behind ``MeshBackedModel``s on one ``ModelServer``, under a budget
    that holds 3 BERT-tiny models (a booster's arrays count 0 bytes, the
    JAX rule); two round-robin rounds of requests. Every answer equals the
    model's alone; loads, evictions and residents follow an LRU model of
    the same requests; ``resident_bytes`` is the resident models' weight
    bytes; each evicted model's unload frees at least its bytes of
    ``torch.cuda.memory_allocated`` and nothing keeps the evicted model
    alive; a pinned model stays resident while five others load."""
    import weakref

    import numpy as np

    from kubeflow_tpu_torch.models.bert import BertForMaskedLM, bert_tiny, init_bert_weights
    from kubeflow_tpu_torch.serve.modelmesh import MeshBackedModel, ModelMesh, _device_bytes
    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.spec import PredictorSpec

    reg = default_registry()
    bert_rt = reg.resolve(PredictorSpec(model_format="bert-tiny"))
    xgb_rt = reg.resolve(PredictorSpec(model_format="xgboost"))
    sds = []
    for seed in range(8):
        mod = BertForMaskedLM(bert_tiny(), device="cpu")
        init_bert_weights(mod, seed)
        sds.append({k: v.clone() for k, v in mod.state_dict().items()})
    per = sum(t.numel() * t.element_size()
              for t in list(mod.parameters()) + list(mod.buffers()))
    budget = 3 * per + per // 2
    texts = ["the cat sat on the [MASK] mat", "a model [MASK] served the dog"]
    rows = {n: _tab_rows(64, ckpts[n][2], seed=64) for n in ("higgs_xgb", "covtype_xgb")}
    frees, made = [], []

    def make_bert(i):
        def factory():
            m = bert_rt.factory(f"bert{i}", None, state_dict=sds[i], device=dev)
            unload = m.unload

            def audited():
                if dev != "cpu":
                    torch.cuda.synchronize()
                before = torch.cuda.memory_allocated() if dev != "cpu" else 0
                unload()
                after = torch.cuda.memory_allocated() if dev != "cpu" else 0
                frees.append((m.name, before - after))

            m.unload = audited
            made.append(weakref.ref(m))
            return m
        return factory

    def make_xgb(name):
        return lambda: xgb_rt.factory(name, ckpts[name][1], device=dev)

    # each model's answers alone, before the mesh
    alone = {}
    for i in range(8):
        m = make_bert(i)()
        m.load()
        alone[f"bert{i}"] = m.postprocess(m.predict(m.preprocess({"instances": texts})))
        del m
    booster_bytes = 0
    for n in rows:
        m = make_xgb(n)()
        m.load()
        alone[n] = m.postprocess(m.predict(rows[n]))
        booster_bytes += m.walk.resident_bytes
        m.unload()
    frees.clear()
    made.clear()
    gc.collect()

    mesh = ModelMesh(budget)
    names = [f"bert{i}" for i in range(8)] + ["higgs_xgb", "covtype_xgb"]
    proxies = [MeshBackedModel(mesh, n, make_bert(int(n[4:])) if n.startswith("bert")
                               else make_xgb(n)) for n in names]
    sizes = {n: per if n.startswith("bert") else 0 for n in names}
    srv = ModelServer(proxies, http_port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    ok, trail = True, []
    lru, clock, loads, evictions = [], 0, 0, 0  # the LRU model: (name, last use)
    try:
        for n in names + names:
            clock += 1
            if n in dict(lru):
                lru = [(k, clock if k == n else t) for k, t in lru]
            else:
                while sum(sizes[k] for k, _ in lru) + sizes[n] > budget:
                    victim = min(lru, key=lambda kt: kt[1])
                    lru.remove(victim)
                    evictions += 1
                lru.append((n, clock))
                loads += 1
            body = ({"instances": texts} if n.startswith("bert")
                    else {"instances": rows[n].tolist()})
            status, _, text = _http(base, "POST", f"/v1/models/{n}:predict", body)
            got = json.loads(text) if status == 200 else text
            want = alone[n]
            same = status == 200 and (got == want if n.startswith("bert") else
                                      np.array_equal(np.asarray(got["predictions"]),
                                                     np.asarray(want["predictions"])))
            resident = mesh.resident()
            weight_bytes = 0
            for k in resident:
                inner = mesh._entries[k].model
                weight_bytes += _device_bytes(inner)
            step = {"request": n, "answer_equal": bool(same), "resident": resident,
                    "lru_model": sorted(k for k, _ in lru),
                    "resident_bytes": mesh.resident_bytes(),
                    "weight_bytes": weight_bytes}
            trail.append(step)
            ok &= (same and resident == step["lru_model"]
                   and step["resident_bytes"] == weight_bytes
                   == per * sum(k.startswith("bert") for k in resident)
                   and step["resident_bytes"] <= budget)
        rr_stats = dict(mesh.stats)
        ok &= rr_stats["loads"] == loads and rr_stats["evictions"] == evictions
        gc.collect()
        alive = sum(r() is not None for r in made)
        bert_frees = [b for name, b in frees if name.startswith("bert")]
        frees_ok = bool(bert_frees) and (dev == "cpu" or min(bert_frees) >= per)
        ok &= frees_ok and alive == sum(k.startswith("bert") for k in mesh.resident())
        # a pinned model stays resident while five others load
        pin_ok = True
        with mesh.pinned("bert0") as m0:
            for i in range(1, 6):
                _http(base, "POST", f"/v1/models/bert{i}:predict", {"instances": texts})
                pin_ok &= "bert0" in mesh.resident() and m0.module is not None
            status, _, text = _http(base, "POST", "/v1/models/bert0:predict",
                                    {"instances": texts})
            pin_ok &= status == 200 and json.loads(text) == alone["bert0"]
        ok &= pin_ok
        emit({"phase": "tabular", "part": "b_modelmesh", "ok": bool(ok),
              "card": state["card"], "bert_tiny_bytes": per, "budget_bytes": budget,
              "requests": len(trail), "stats": rr_stats,
              "stats_after_pinned_part": dict(mesh.stats),
              "lru_loads": loads, "lru_evictions": evictions,
              "answers_equal": all(s["answer_equal"] for s in trail),
              "residents_follow_lru": all(s["resident"] == s["lru_model"] for s in trail),
              "resident_bytes_are_weights": all(
                  s["resident_bytes"] == s["weight_bytes"] for s in trail),
              "evicted_bert_frees_min_bytes": min(bert_frees) if bert_frees else None,
              "evicted_bert_unloads": len(bert_frees), "models_alive": alive,
              "pinned_stayed": bool(pin_ok),
              "booster_arrays_bytes_uncounted": booster_bytes,
              **({} if ok else {"trail": trail})})
    finally:
        srv.stop()
    return ok


def phase_tabular(torch, state):
    """The KServe tabular predictors and ModelMesh on the card. (a) seeded
    checkpoints in the published formats — XGBoost JSON ``binary:logistic``
    (1000 trees of depth 8, 28 features: HIGGS's width) and
    ``multi:softprob`` (7 classes x 200 rounds, 54 features: Covertype's),
    a LightGBM text model of the first one's shape, a PMML ``MiningModel``
    forest of 100 depth-8 trees and a logistic ``RegressionModel`` — each
    served through ``ModelServer`` (v1 and v2) at 1, 64 and 4096 rows with
    about 1% NaN features: answers within the bound of the plain walk, v2
    equal to v1, class outputs identical, and the walk's final cursors
    equal to the plain walk's leaves; the p50 of a predict by batch size,
    its launches under ``torch.profiler``, the busy share and the bytes
    resident. (b) a ModelMesh of BERT-tiny predictors and the boosters
    (:func:`_tab_mesh`). A line a model, then one for the mesh."""
    import shutil
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kft-tabular-")
    try:
        ckpts = tabular_checkpoints(root)
        write_s = time.perf_counter() - t0
        ok = _tab_serve(torch, state, ckpts, "cuda")
        ok &= _tab_mesh(torch, state, ckpts, "cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "tabular", "part": "total", "ok": bool(ok),
          "checkpoint_write_s": write_s, "seconds": time.perf_counter() - t0})
    return ok


# --------------------------------------------------------------------------- #
# phase 18: Katib — a hyperparameter search on the LM, the registry handoff
# of the best trial to a served model, DARTS and ENAS
# --------------------------------------------------------------------------- #

#: trials, trials at a time, steps a trial (a checkpoint at the last one)
TUNE_TRIALS, TUNE_PARALLEL, TUNE_STEPS = 4, 2, 8
#: bilevel steps a NAS searcher takes on the card and on the CPU (few, so
#: the whole run stays inside its time)
NAS_STEPS = 5
#: card against CPU after NAS_STEPS f32 steps: losses (relative) and the
#: DARTS alphas (absolute: adam moves every alpha by about its lr a step)
NAS_LOSS_RTOL, NAS_ALPHA_ATOL = 1e-4, 5e-4
#: an ENAS decision whose two best Gumbel-perturbed scores (on the CPU)
#: are closer than this may be drawn differently on the card
NAS_NEAR_TIE = 1e-4


def _tune_search(torch, state, root):
    """(a) and (b)'s search: ``ExperimentController`` over ``Trainer.fit``
    trials of the full-width LM, the winner registered in a
    ``ModelStore``. Returns ``(part a's line, controller, store, trial
    directories)``."""
    import os
    import shutil

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.registry import ModelStore, set_default_store
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig
    from kubeflow_tpu_torch.train.prefetch import live_kft_threads
    from kubeflow_tpu_torch.tune import spec as S
    from kubeflow_tpu_torch.tune.controller import (
        CallableTrialRunner, ExperimentController,
    )

    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    dirs, runs, lock = {}, [], threading.Lock()
    kept = {"loss": math.inf, "dir": None}

    def trial(params):
        t0 = time.perf_counter()
        d = os.path.join(root, "trials", f"lr-{params['lr']:.9e}")
        trainer = Trainer(
            init_params=make_init_fn(cfg), loss_fn=make_loss_fn(),
            optimizer=adamw(params["lr"]),
            config=TrainConfig(mesh=None, global_batch=TRAIN_BATCH,
                               steps=TUNE_STEPS, log_every=1, prefetch_depth=2,
                               checkpoint=CheckpointConfig(
                                   directory=d, save_every_steps=TUNE_STEPS)),
        )
        history, ready = _stamped_fit(torch, trainer, _train_data)
        losses = [h["loss"] for h in history]
        with lock:
            dirs[params["lr"]] = d
            # only the best trial's weights are ever served: a worse
            # trial's checkpoint (3.2 GB) leaves the disk at once
            drop = kept["dir"]
            if losses[-1] < kept["loss"]:
                kept.update(loss=losses[-1], dir=d)
            else:
                drop = d
            # steps 2 .. TUNE_STEPS - 1: the first builds cuBLAS handles,
            # the last copies the state to the host for the checkpoint
            runs.append({"lr": params["lr"], "seconds": time.perf_counter() - t0,
                         "step_ms": (ready[TUNE_STEPS - 1] - ready[1])
                         / (TUNE_STEPS - 2) * 1e3,
                         "compile_ms": history[0].get("compile_ms"),
                         "losses": losses})
        if drop is not None:
            shutil.rmtree(drop, ignore_errors=True)
        return [(h["step"], h["loss"]) for h in history]

    spec = S.ExperimentSpec(
        name="lm-lr",
        parameters=(S.ParameterSpec("lr", S.ParameterType.DOUBLE, min=1e-4,
                                    max=3e-3, log_scale=True),),
        objective=S.Objective("loss", S.ObjectiveType.MINIMIZE),
        algorithm=S.AlgorithmSpec("tpe", {"n_initial": 2}),
        parallel_trial_count=TUNE_PARALLEL, max_trial_count=TUNE_TRIALS,
        max_failed_trial_count=0,
        early_stopping=S.EarlyStoppingSpec(min_trials_required=2, start_step=2))
    store = ModelStore(os.path.join(root, "registry"))
    set_default_store(store)
    picked = {}

    def best_path(t):
        picked["t"] = time.perf_counter()
        return dirs[t.assignment.parameters["lr"]]

    ctrl = ExperimentController(
        spec, CallableTrialRunner(trial), seed=0, model_registry=store,
        register_best_as="lm-tuned", best_model_path=best_path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    _zero_flash_counts(fa, fb)
    t0 = time.perf_counter()
    status = ctrl.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    register_s = time.perf_counter() - picked["t"] if "t" in picked else None
    launches = {"flash_forward": fa.LAUNCHES, "flash_bwd_dq": fb.DQ_LAUNCHES,
                "flash_bwd_dkv": fb.DKV_LAUNCHES}
    by_body = _flash_counts_by_body(fa, fb)
    state["tune_flash_launches"] = launches
    want = TUNE_TRIALS * TUNE_STEPS * MODEL["n_layers"]
    terminal = ("Succeeded", "EarlyStopped")
    objs = {t.assignment.trial_id: t.metrics.get("__objective__") for t in status.trials}
    finite = all(v is not None and math.isfinite(v) for v in objs.values())
    best = status.optimal
    argmin = finite and best is not None and best.metrics["__objective__"] == min(objs.values())
    ok = (len(status.trials) == TUNE_TRIALS
          and all(t.state.value in terminal for t in status.trials)
          and status.failed == 0 and finite and argmin
          and all(n == want for n in launches.values())
          and all(b == {"wgmma": want, "fma": 0} for b in by_body.values())
          and ctrl.registered_best is not None and live_kft_threads() == [])
    line = {"phase": "tune", "part": "search", "algorithm": "tpe",
            "trials": [{"params": t.assignment.parameters, "state": t.state.value,
                        "loss": t.metrics.get("__objective__"), "message": t.message}
                       for t in status.trials],
            "runs": sorted(runs, key=lambda r: r["lr"]),
            "trial_seconds": [r["seconds"] for r in runs],
            "step_ms_median": statistics.median(r["step_ms"] for r in runs) if runs else None,
            "trials_at_a_time": TUNE_PARALLEL, "steps": TUNE_STEPS,
            "shape": [TRAIN_BATCH, TRAIN_SEQ], "dtype": "bf16", "param_dtype": "f32",
            "reason": status.reason, "wall_s": wall, "register_s": register_s,
            "optimal": best.assignment.parameters if best else None,
            "optimal_is_argmin": argmin, "early_stopped": status.early_stopped,
            "launches": launches, "launches_by_body": by_body,
            "launches_wanted": want, "card": state["card"], "ok": ok}
    return line, ctrl, store, dirs


def _tune_serve(torch, state, root, ctrl, store, dirs, register_s):
    """(b): promote the registered winner, fetch it by
    ``registry://lm-tuned@production``, serve the burst from the fetched
    directory and from the trial's checkpoint directly."""
    import os

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.registry import stages
    from kubeflow_tpu_torch.registry.store import content_hash
    from kubeflow_tpu_torch.serve import storage
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    mv = ctrl.registered_best
    (edge,) = store.lineage_of("lm-tuned", mv.version)
    stages.promote(store, "lm-tuned", mv.version, "production")
    t0 = time.perf_counter()
    local = storage.download("registry://lm-tuned@production", os.path.join(root, "mnt"))
    fetch_s = time.perf_counter() - t0
    blob = store.blob_path(mv.sha256)
    # a directory's sha256 is that of its sorted (path, file sha256) list:
    # equal digests, equal files
    fetched_sha = content_hash(local)[0]
    verified = storage.verify(local, uri=f"registry://lm-tuned@v{mv.version}")
    best = ctrl.optimal_trial()
    direct = dirs[best.assignment.parameters["lr"]]
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    models = {name: LMEngineModel(
        name, path, config=cfg, device="cuda", max_new_tokens=MAX_NEW,
        paged_attn_impl="kernel", **ENGINE,
    ) for name, path in (("lm-tuned", local), ("lm-direct", direct))}
    server = ModelServer(list(models.values()), http_port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    reqs = prompts()
    try:
        for lm in models.values():  # warm-up: cuBLAS handles, allocator
            _post(base, lm.name, reqs[0][:8])
        torch.cuda.synchronize()
        _zero_paged(pa)
        fa.LAUNCHES = 0
        outs, run = _served_burst(base, models["lm-tuned"], reqs)
        paged_launches, by_s, by_body = _paged_counts(pa)
        flash_launches = fa.LAUNCHES
        direct_outs, _ = _served_burst(base, models["lm-direct"], reqs)
    finally:
        server.stop()
    state["tune_paged_launches_by_body"] = by_body
    well_formed = all(1 <= len(o) <= MAX_NEW and all(0 <= t < MODEL["vocab_size"] for t in o)
                      for o in outs)
    bodies = (set(by_s) == {1, 32} and by_body["decode"] == by_s[1] > 0
              and by_body["mma"] == by_s[32] > 0)
    ok = (fetched_sha == mv.sha256 and verified and edge.kind == "tune_trial"
          and edge.ref == f"lm-lr/{best.assignment.trial_id}"
          and mv.metadata["trial_id"] == best.assignment.trial_id
          and store.resolve("lm-tuned", "production").version == mv.version
          and outs == direct_outs and well_formed and bodies)
    return {"phase": "tune", "part": "handoff", "version": mv.version,
            "sha256": mv.sha256, "fetched_sha256": fetched_sha,
            "fetch_verified": verified, "lineage": edge.to_dict(),
            "register_s": register_s, "fetch_s": fetch_s,
            "blob_bytes": sum(os.path.getsize(os.path.join(r, f))
                              for r, _, fs in os.walk(blob) for f in fs),
            "tokens_equal_direct": outs == direct_outs,
            "rows_differing": [i for i, (a, b) in enumerate(zip(outs, direct_outs))
                               if a != b],
            "tokens": run["tokens"], "tokens_per_s": run["tokens_per_s"],
            "ttft_ms_p50": run["ttft_ms_p50"], "wall_s": run["wall_s"],
            "paged_launches": paged_launches, "paged_launches_by_s": by_s,
            "paged_launches_by_body": by_body, "flash_launches": flash_launches,
            "card": state["card"], "ok": ok}


def _nas_data(step):
    """``tests/test_nas_pbt.py``'s synthetic batches: 4 class prototypes on
    8 x 8 x 1 images plus noise, 16 a batch, (train, val) a step."""
    import numpy as np

    protos = np.random.RandomState(0).randn(4, 8, 8, 1).astype(np.float32)

    def batch(seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 4, size=16)
        x = protos[y] + 0.3 * r.randn(16, 8, 8, 1).astype(np.float32)
        return {"image": x.astype(np.float32), "label": y}

    return batch(step * 2), batch(step * 2 + 1)


def _enas_gap(torch, ctrl, key):
    """The smallest gap between the two best Gumbel-perturbed scores over
    the decisions of ``ctrl``'s sampled rollout from ``key``: how close
    the draw came to picking another input or op."""
    from kubeflow_tpu_torch.serve import threefry

    sp, cell = ctrl.space, ctrl.OptimizedLSTMCell_0
    zero = ctrl.start.new_zeros(1, ctrl.hidden)
    carry, x, rng, gaps = (zero, zero), ctrl.start[None], key, []
    with torch.no_grad():
        for j in range(1, sp.nodes + 1):
            for _slot in range(2):
                for head, table, mask in ((ctrl.head_input, ctrl.inp_embed,
                                           ctrl._masks[j - 1]),
                                          (ctrl.head_op, ctrl.op_embed, 0.0)):
                    carry = cell(carry, x)
                    rng, k = threefry.split(rng)
                    logits = head(carry[1])[0] + mask
                    u = threefry.uniform_one_key(k, logits[None].shape, logits.device,
                                                 threefry.TINY, 1.0)[0]
                    score = -torch.log(-torch.log(u)) + logits
                    top = torch.topk(score, 2).values
                    gaps.append((top[0] - top[1]).item())
                    x = table[torch.argmax(score)][None]
    return min(gaps)


def _tune_nas(torch, state):
    """(c): DARTS and ENAS at ``NASSpace`` defaults, f32 with TF32 off,
    on the card and on the CPU in lockstep from one seed."""
    import numpy as np

    from kubeflow_tpu_torch.tune.nas import DARTSSearcher, ENASSearcher, NASSpace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp = NASSpace()
    out = {"phase": "tune", "part": "nas", "space": {
        "ops": list(sp.ops), "nodes": sp.nodes, "channels": sp.channels,
        "num_classes": sp.num_classes, "input_shape": list(sp.input_shape)},
        "steps": NAS_STEPS, "batch": 16, "loss_rtol": NAS_LOSS_RTOL,
        "alpha_atol": NAS_ALPHA_ATOL, "near_tie": NAS_NEAR_TIE}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    # DARTS
    card, cpu = (DARTSSearcher(sp, seed=0, device=d) for d in ("cuda", "cpu"))
    loss_err, ms = 0.0, []
    for i in range(NAS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card.step(*_nas_data(i))
        ms.append((time.perf_counter() - t0) * 1e3)
        want = cpu.step(*_nas_data(i))
        loss_err = max(loss_err, *(rel(got[k], want[k]) for k in want))
    alpha_err = float(np.abs(card.alpha.detach().cpu().numpy()
                             - cpu.alpha.detach().numpy()).max())
    darts_cell, cpu_cell = card.derive().to_dict(), cpu.derive().to_dict()
    darts_ok = (loss_err <= NAS_LOSS_RTOL and alpha_err <= NAS_ALPHA_ATOL
                and darts_cell == cpu_cell)
    out["darts"] = {"ms_per_step_median": statistics.median(ms), "ms_per_step": ms,
                    "loss_rel_err_max": loss_err, "alpha_abs_err_max": alpha_err,
                    "cell": darts_cell, "cell_cpu": cpu_cell,
                    "entropy": card.alpha_entropy(), "last": got, "ok": darts_ok}

    # ENAS: the sampled architectures step for step
    card, cpu = (ENASSearcher(sp, seed=0, device=d) for d in ("cuda", "cpu"))
    loss_err, ms, first_diff, gap = 0.0, [], None, None
    for i in range(NAS_STEPS):
        key_cpu = cpu._rng
        before = {k: v.clone() for k, v in cpu.controller.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card.step(*_nas_data(i))
        ms.append((time.perf_counter() - t0) * 1e3)
        want = cpu.step(*_nas_data(i))
        if card.sampled[i] != cpu.sampled[i]:
            # replay the CPU's two rollouts of this step from its keys
            from kubeflow_tpu_torch.serve import threefry

            probe = ENASSearcher(sp, seed=0, device="cpu").controller
            probe.load_state_dict(before)
            _, k1, k2 = threefry.split(key_cpu, 3)
            first_diff, gap = i, min(_enas_gap(torch, probe, k1), _enas_gap(torch, probe, k2))
            break
        loss_err = max(loss_err, *(rel(got[k], want[k]) for k in
                                   ("w_loss", "ctrl_loss", "baseline")))
        if got["reward"] != want["reward"]:
            first_diff, gap = i, None
            break
    enas_cell, cpu_cell = card.derive().to_dict(), cpu.derive().to_dict()
    enas_ok = (first_diff is None and loss_err <= NAS_LOSS_RTOL and enas_cell == cpu_cell) \
        or (first_diff is not None and gap is not None and gap < NAS_NEAR_TIE)
    out["enas"] = {"ms_per_step_median": statistics.median(ms), "ms_per_step": ms,
                   "sampled_equal_steps": first_diff if first_diff is not None else NAS_STEPS,
                   "first_divergence": first_diff, "divergence_gap": gap,
                   "loss_rel_err_max": loss_err, "cell": enas_cell, "cell_cpu": cpu_cell,
                   "baseline": got["baseline"], "last": got, "ok": enas_ok}
    out.update(card=state["card"], ok=darts_ok and enas_ok)
    return out


def phase_tune(torch, state):
    """Katib on the card: (a) a TPE search of the full-width LM's learning
    rate by ``ExperimentController`` — 4 ``Trainer.fit`` trials, 2 at a
    time, 8 steps of 8 x 512 in bf16 over f32 each and a checkpoint at the
    last, medianstop on — every trial terminal with a finite loss, the
    optimum the argmin, the flash forward, dq and dk/dv kernels launched
    once a layer a step; (b) the controller registers the winner in a
    ``ModelStore`` (``tune_trial`` lineage), ``stages`` promotes it,
    ``storage.download("registry://lm-tuned@production")`` fetches the
    registered blob's files and sha256, and ``LMEngineModel`` serves the
    burst from the fetched directory with tokens identical to the same
    burst served from the trial's checkpoint directly (paged kernel
    launches counted); (c) DARTS and ENAS at ``NASSpace`` defaults, f32
    with TF32 off, on the card against the CPU from one seed: derived
    cells equal, ENAS's samples equal step for step (or parting first at
    a stated near-tie), losses and alphas within tolerance. A line a
    part."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="kft-tune-")
    try:
        line, ctrl, store, dirs = _tune_search(torch, state, root)
        emit(line)
        ok = line["ok"]
        if ctrl.registered_best is not None:
            served = _tune_serve(torch, state, root, ctrl, store, dirs,
                                 line["register_s"])
            emit(served)
            ok &= served["ok"]
        else:
            ok = False
        store.close()
    finally:
        from kubeflow_tpu_torch.registry import set_default_store

        set_default_store(None)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    nas = _tune_nas(torch, state)
    emit(nas)
    return bool(ok and nas["ok"])


# --------------------------------------------------------------------------- #
# phase 19: Kubeflow Pipelines, the steps jobs on the card
# --------------------------------------------------------------------------- #

#: ``lm-pipeline``'s parameter defaults
PIPE_LR, PIPE_STEPS = 1e-3, 8
#: the registered name the train step asks for (``register_as``)
PIPE_MODEL = "lm-pipeline"


# The components below are module-level functions whose bodies import what
# they use: the executor re-executes each one's source alone, in a step job
# or in process. Their annotations name the port's DSL types, which
# ``lm_pipeline`` binds here before it decorates them.

def make_data(steps: int, vocab_size: int, batch: int, seq: int,
              data: Output[Dataset]) -> None:
    """The train phase's seeded stream (``TokenLMDataset`` seed 0): the
    tokens of ``steps`` batches, ``[steps, batch, seq + 1]`` int32."""
    import torch

    from kubeflow_tpu_torch.data import TokenLMDataset, local_shard_iterator

    it = local_shard_iterator(
        TokenLMDataset(vocab_size=vocab_size, seq_len=seq, seed=0), batch)
    rows = []
    for _ in range(steps):
        b = next(it)
        rows.append(torch.cat([torch.from_numpy(b["inputs"]),
                               torch.from_numpy(b["targets"][:, -1:])], 1))
    torch.save(torch.stack(rows), data.path)
    data.metadata["shape"] = [steps, batch, seq + 1]


def train_lm(data: Input[Dataset], lr: float, steps: int, config: dict,
             dtype: str, device: str, init: str, model: Output[Model]) -> float:
    """``Trainer.fit`` of the LM (``config``, computing in ``dtype`` over
    f32 weights, flash attention) on the Dataset's batches, from
    ``init`` (a saved ``state_dict``) or else from seed 0, with a
    checkpoint at the last step into the Model. Prints a ``step=N
    loss=X`` line a step, then one line of its flash launches (all, and
    on ``wgmma``) and its ms a step (steps 2 .. steps - 1); returns the
    last loss."""
    import time

    import torch

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw
    from kubeflow_tpu_torch.train.checkpoint import CheckpointConfig

    toks = torch.load(data.path)

    def stream(start):
        for t in toks[start:]:
            yield {"inputs": t[:, :-1].numpy(), "targets": t[:, 1:].numpy()}

    cfg = TransformerConfig(dtype=getattr(torch, dtype), attn_impl="flash", **config)
    fresh = make_init_fn(cfg)

    def init_params(seed, dev):
        m = fresh(seed, dev)
        if init:
            m.load_state_dict(torch.load(init))
        return m

    trainer = Trainer(
        init_params=init_params, loss_fn=make_loss_fn(), optimizer=adamw(lr),
        config=TrainConfig(mesh=None, global_batch=toks.shape[1], steps=steps,
                           log_every=1, prefetch_depth=2,
                           checkpoint=CheckpointConfig(directory=model.path,
                                                       save_every_steps=steps)),
        device=device)
    ready = {}
    _, history = trainer.fit(
        stream, hooks=[lambda step, m: ready.__setitem__(step, time.perf_counter())])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    step_ms = ((ready[steps - 1] - ready[1]) / (steps - 2) * 1e3
               if steps > 2 else float("nan"))
    print(f"pipeline_kernels flash_forward={fa.LAUNCHES} "
          f"flash_bwd_dq={fb.DQ_LAUNCHES} flash_bwd_dkv={fb.DKV_LAUNCHES} "
          f"wgmma_forward={fa.LAUNCHES_BY_BODY['wgmma']} "
          f"wgmma_dq={fb.DQ_LAUNCHES_BY_BODY['wgmma']} "
          f"wgmma_dkv={fb.DKV_LAUNCHES_BY_BODY['wgmma']} "
          f"step_ms={step_ms:.6f}", flush=True)
    model.metadata["register_as"] = "lm-pipeline"
    model.metadata["losses"] = [h["loss"] for h in history]
    return history[-1]["loss"]


def eval_lm(model: Input[Model], steps: int, config: dict, dtype: str,
            device: str, batch: int, seq: int, metrics: Output[Metrics]) -> None:
    """The loss of the held-out batch (the stream's step ``steps``, the
    first the train step did not see) through the forward alone, logged
    as ``eval_loss``; prints a line of its flash launches and its ms."""
    import time

    import torch

    from kubeflow_tpu_torch.data import TokenLMDataset, local_shard_iterator
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.serve.generate import restore_state

    cfg = TransformerConfig(dtype=getattr(torch, dtype), attn_impl="flash", **config)
    lm = make_init_fn(cfg)(0, torch.device(device))
    lm.load_state_dict(restore_state(model.path))
    lm.eval()
    b = next(local_shard_iterator(
        TokenLMDataset(vocab_size=config["vocab_size"], seq_len=seq, seed=0),
        batch, start_step=steps))
    held = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = make_loss_fn()(lm, held)
        value = loss.item()
    ms = (time.perf_counter() - t0) * 1e3
    metrics.log_metric("eval_loss", value)
    print(f"pipeline_eval flash_forward={fa.LAUNCHES} "
          f"wgmma_forward={fa.LAUNCHES_BY_BODY['wgmma']} ms={ms:.6f} "
          f"eval_loss={value!r}", flush=True)


def lm_pipeline(config=None, *, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                dtype="bfloat16", device="cuda", init=""):
    """``lm-pipeline`` on the port's DSL: ``make-data`` in process, then
    ``train-lm`` and ``eval-lm``, each asking one chip (a step job under
    a cluster). Phase 19 runs it at ``MODEL``'s width; the CPU tests
    build it small with ``device="cpu"``."""
    from kubeflow_tpu_torch import pipelines as kp

    globals().update(Input=kp.Input, Output=kp.Output, Dataset=kp.Dataset,
                     Model=kp.Model, Metrics=kp.Metrics)
    config = dict(MODEL if config is None else config)
    make, train, evaluate = map(kp.component, (make_data, train_lm, eval_lm))
    shared = dict(config=config, dtype=dtype, device=device)

    @kp.pipeline(name="lm-pipeline", description="make-data → train-lm → eval-lm")
    def pipe(lr: float = PIPE_LR, steps: int = PIPE_STEPS):
        d = make(steps=steps, vocab_size=config["vocab_size"], batch=batch, seq=seq)
        t = train(data=d.output, lr=lr, steps=steps, init=init,
                  **shared).set_tpu_request(chips=1)
        evaluate(model=t.outputs["model"], steps=steps, batch=batch, seq=seq,
                 **shared).set_tpu_request(chips=1)

    return pipe


def phase_pipeline(torch, state):
    """Kubeflow Pipelines on the card (``kubeflow_tpu_torch/pipelines``):
    ``lm_pipeline()`` compiled and run by ``PipelineRunner`` over a
    ``LocalCluster`` with the ``gpu`` wiring and one chip of the fleet's
    default label (a step's ``TPURequest`` names no generation, as in the
    JAX runner), a ``StepCache``, a sqlite ``LineageStore`` and a
    ``ModelStore``. (a) The first run: SUCCEEDED, one attempt a task, no
    cache hit; each step job's conditions Created → Running → Succeeded;
    the train step's returned loss its worker's last ``loss=`` line,
    finite and below step 1's; a finite ``eval_loss``; 3 executions in
    the lineage, the Dataset and the Model each an output and then an
    input; ``lm-pipeline`` v1 in the registry with its ``pipeline_run``
    edge; the train worker's flash launches ``steps`` x 12 of each kernel
    and the eval worker's forward 12, all on ``wgmma``. (b)
    ``registry://lm-pipeline@v1`` fetched through ``serve/storage.py``
    (its content hash the registered sha256) and served by
    ``ModelServer`` + ``LMEngineModel`` on the paged kernel, the burst's
    greedy streams identical to serving the Model artifact's directory.
    (c) The same run again: every task a cache hit, no job submitted, v2
    registered with ``cache_hit`` True and v1's blob. A line a part, with
    its seconds and the card."""
    import re
    import shutil
    import tempfile

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.orchestrator.resources import Fleet
    from kubeflow_tpu_torch.pipelines import (
        ArtifactStore, LineageStore, PipelineRunner, StepCache, compile_pipeline,
    )
    from kubeflow_tpu_torch.registry import ModelStore, set_default_store
    from kubeflow_tpu_torch.registry.store import content_hash
    from kubeflow_tpu_torch.serve import storage
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    root = tempfile.mkdtemp(prefix="kft-pipe-")
    params = {"lr": PIPE_LR, "steps": PIPE_STEPS}
    flow = [("Created", "JobCreated"), ("Running", "AllWorkersRunning"),
            ("Succeeded", "AllWorkersSucceeded")]
    ok = True
    try:
        ir = compile_pipeline(lm_pipeline())
        store = ModelStore(os.path.join(root, "registry"))
        set_default_store(store)
        register_s = []
        register = store.register_version

        def timed_register(*a, **kw):
            t = time.perf_counter()
            mv = register(*a, **kw)
            register_s.append(time.perf_counter() - t)
            return mv

        store.register_version = timed_register
        lineage = LineageStore(os.path.join(root, "mlmd.db"))
        cluster, record = _gpu_cluster(os.path.join(root, "cluster"),
                                       fleet=Fleet.single_host(chips=1))
        runner = PipelineRunner(
            artifact_store=ArtifactStore(os.path.join(root, "artifacts")),
            cache=StepCache(os.path.join(root, "cache")), lineage=lineage,
            cluster=cluster, model_registry=store, job_timeout_s=JOB_TIMEOUT_S)
        with cluster:
            # (a) the first run
            t0 = time.perf_counter()
            res = runner.run(ir, params)
            wall = time.perf_counter() - t0
            jobs = {j.spec.labels.get("task"): (uid, j) for uid, j in cluster.jobs.list()}
            steps_out = {}
            for task in ("train-lm", "eval-lm"):
                uid, job = jobs.get(task, (None, None))
                log = cluster.logs(uid, "worker", 0) if uid else ""
                st = job.status if job else None
                steps_out[task] = {
                    "conditions": record.trail(uid) if uid else [],
                    "seconds": (st.completion_time - st.start_time
                                if st and st.start_time and st.completion_time
                                else None),
                    "log": log}
            train_log = steps_out["train-lm"]["log"]
            worker_losses = [float(x) for x in re.findall(r"\bloss=(\S+)", train_log)]
            tk = _kv_line(train_log, "pipeline_kernels")
            ek = _kv_line(steps_out["eval-lm"]["log"], "pipeline_eval")
            loss = res.output("train-lm", "Output") if res.state == "SUCCEEDED" else None
            model_art = res.output("train-lm", "model") if loss is not None else None
            eval_loss = (res.output("eval-lm", "metrics").metadata.get("eval_loss")
                         if loss is not None else None)
            execs = lineage.executions(res.run_id)
            uses = {}
            if model_art is not None:
                data_uri = res.tasks["make-data"].outputs["data"]["uri"]
                uses = {name: sorted((x["task"], x["direction"])
                                     for x in lineage.lineage(uri))
                        for name, uri in (("dataset", data_uri),
                                          ("model", model_art.uri))}
            v1 = store.resolve(PIPE_MODEL, "v1") if loss is not None else None
            edges = ([{"kind": e.kind, "ref": e.ref, "metadata": e.metadata}
                      for e in store.lineage_of(PIPE_MODEL, 1)] if v1 else [])
            want = PIPE_STEPS * MODEL["n_layers"]
            kernels_ok = (
                all(tk.get(k) == want for k in FLASH_KERNELS)
                and all(tk.get(k) == want for k in
                        ("wgmma_forward", "wgmma_dq", "wgmma_dkv"))
                and ek.get("flash_forward") == MODEL["n_layers"]
                and ek.get("wgmma_forward") == MODEL["n_layers"])
            good = (
                res.state == "SUCCEEDED"
                and all(t.attempts == 1 and not t.cache_hit for t in res.tasks.values())
                and all(steps_out[t]["conditions"] == flow for t in steps_out)
                and loss is not None and math.isfinite(loss)
                and len(worker_losses) == PIPE_STEPS
                and float(f"{loss:.6g}") == worker_losses[-1]
                and loss < model_art.metadata["losses"][0]
                and eval_loss is not None and math.isfinite(eval_loss)
                and [e["task"] for e in execs] == ["make-data", "train-lm", "eval-lm"]
                and uses == {"dataset": [("make-data", "output"), ("train-lm", "input")],
                             "model": [("eval-lm", "input"), ("train-lm", "output")]}
                and v1 is not None and edges == [{
                    "kind": "pipeline_run", "ref": res.run_id,
                    "metadata": {"pipeline": "lm-pipeline", "task": "train-lm",
                                 "output": "model", "cache_hit": False}}]
                and kernels_ok)
            state["pipeline_flash_launches"] = {
                "flash_forward": int(tk.get("flash_forward", 0)
                                     + ek.get("flash_forward", 0)),
                "flash_bwd_dq": int(tk.get("flash_bwd_dq", 0)),
                "flash_bwd_dkv": int(tk.get("flash_bwd_dkv", 0))}
            line = {"phase": "pipeline", "part": "a_run", "ok": good,
                    "state": res.state, "wall_s": wall,
                    "tasks": {n: {"state": t.state, "attempts": t.attempts,
                                  "cache_hit": t.cache_hit, "error": t.error[-2000:]}
                              for n, t in res.tasks.items()},
                    "step_jobs": {t: {k: v for k, v in o.items() if k != "log"}
                                  for t, o in steps_out.items()},
                    "train_loss": loss, "worker_losses": worker_losses,
                    "eval_loss": eval_loss, "worker_step_ms": tk.get("step_ms"),
                    "eval_forward_ms": ek.get("ms"),
                    "train_launches": tk, "eval_launches": ek,
                    "launches_wanted": {"train": want, "eval": MODEL["n_layers"]},
                    "lineage": uses, "registry_edges": edges,
                    "register_s": register_s[:1], "shape": [TRAIN_BATCH, TRAIN_SEQ],
                    "steps": PIPE_STEPS, "dtype": "bf16", "param_dtype": "f32",
                    "card": state["card"]}
            if not good:
                line["logs"] = {t: o["log"][-3000:] for t, o in steps_out.items()}
            emit(line)
            ok &= good
            if not good:
                return False

            # (b) the registered model, fetched and served
            t0 = time.perf_counter()
            local = storage.download(f"registry://{PIPE_MODEL}@v1",
                                     os.path.join(root, "mnt"))
            fetch_s = time.perf_counter() - t0
            fetched_sha = content_hash(local)[0]
            cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
            models = {name: LMEngineModel(
                name, path, config=cfg, device="cuda", max_new_tokens=MAX_NEW,
                paged_attn_impl="kernel", **ENGINE,
            ) for name, path in (("lm-registry", local),
                                 ("lm-artifact", model_art.path))}
            server = ModelServer(list(models.values()), http_port=0).start()
            base = f"http://127.0.0.1:{server.port}"
            reqs = prompts()
            try:
                for lm in models.values():  # warm-up: cuBLAS handles, allocator
                    _post(base, lm.name, reqs[0][:8])
                torch.cuda.synchronize()
                _zero_paged(pa)
                outs, run = _served_burst(base, models["lm-registry"], reqs)
                paged_launches, by_s, by_body = _paged_counts(pa)
                direct_outs, _ = _served_burst(base, models["lm-artifact"], reqs)
            finally:
                server.stop()
            state["pipeline_paged_launches_by_body"] = by_body
            bodies = (set(by_s) == {1, 32} and by_body["decode"] == by_s[1] > 0
                      and by_body["mma"] == by_s[32] > 0)
            good = (fetched_sha == v1.sha256 and outs == direct_outs and bodies
                    and all(1 <= len(o) <= MAX_NEW for o in outs))
            emit({"phase": "pipeline", "part": "b_registry_serve", "ok": good,
                  "version": v1.version, "sha256": v1.sha256,
                  "fetched_sha256": fetched_sha, "fetch_s": fetch_s,
                  "tokens_equal_artifact": outs == direct_outs,
                  "rows_differing": [i for i, (a, b) in
                                     enumerate(zip(outs, direct_outs)) if a != b],
                  "tokens": run["tokens"], "tokens_per_s": run["tokens_per_s"],
                  "ttft_ms_p50": run["ttft_ms_p50"], "wall_s": run["wall_s"],
                  "paged_launches": paged_launches, "paged_launches_by_s": by_s,
                  "paged_launches_by_body": by_body, "card": state["card"]})
            ok &= good

            # (c) the cached rerun
            n_jobs = len(cluster.jobs.list())
            t0 = time.perf_counter()
            res2 = runner.run(ir, params)
            wall2 = time.perf_counter() - t0
            v2 = store.resolve(PIPE_MODEL, "v2") if res2.state == "SUCCEEDED" else None
            edges2 = store.lineage_of(PIPE_MODEL, 2) if v2 else []
            new_jobs = len(cluster.jobs.list()) - n_jobs
            good = (res2.state == "SUCCEEDED"
                    and all(t.cache_hit for t in res2.tasks.values())
                    and new_jobs == 0 and v2 is not None
                    and v2.metadata.get("cache_hit") is True
                    and v2.sha256 == v1.sha256
                    and [e.metadata["cache_hit"] for e in edges2] == [True])
            emit({"phase": "pipeline", "part": "c_cached_rerun", "ok": good,
                  "state": res2.state, "wall_s": wall2,
                  "cache_hits": {n: t.cache_hit for n, t in res2.tasks.items()},
                  "jobs_submitted": new_jobs, "version": v2.version if v2 else None,
                  "sha256_equal_v1": bool(v2 and v2.sha256 == v1.sha256),
                  "register_s": register_s[1:], "card": state["card"]})
            ok &= good
        lineage.close()
        store.close()
    finally:
        set_default_store(None)
        shutil.rmtree(root, ignore_errors=True)
    return ok


# --------------------------------------------------------------------------- #
# phase 20: the KServe InferenceService control plane
# --------------------------------------------------------------------------- #

#: ``kubeflow_tpu_torch/examples/manifests/bert_isvc.yaml`` as a literal
#: (the card's host has no PyYAML; a CPU test holds the two equal)
BERT_ISVC_MANIFEST = {
    "apiVersion": "serving.kubeflow.org/v1beta1",
    "kind": "InferenceService",
    "metadata": {"name": "bert", "namespace": "default"},
    "spec": {"predictor": {
        "minReplicas": 1, "maxReplicas": 2, "scaleTarget": 4,
        "canaryTrafficPercent": 100,
        "model": {"modelFormat": {"name": "huggingface"},
                  "storageUri": "file:///mnt/models/bert-base-uncased"}}},
}


def isvc_manifest(storage_uri: str) -> dict:
    """The kserve-bert manifest with its ``storageUri`` rewritten."""
    doc = json.loads(json.dumps(BERT_ISVC_MANIFEST))
    doc["spec"]["predictor"]["model"]["storageUri"] = storage_uri
    return doc


ISVC_CANARY_PCT = 30
ISVC_IDS = 400
#: what the phase's transformer keeps of each answer row
ISVC_TRIM = 16


def _isvc_window(fa, pa):
    _bert_window(fa, pa)
    _zero_paged(pa)


def _isvc_count(fa, pa, into):
    """Add the flash and paged launches since :func:`_isvc_window` to
    ``into`` (by body), and return this window's."""
    got = {"flash": dict(fa.LAUNCHES_BY_BODY), "paged": dict(pa.LAUNCHES_BY_BODY)}
    for kind, by_body in got.items():
        for body, n in by_body.items():
            into[kind][body] = into[kind].get(body, 0) + n
    got["flash_total"], got["paged_total"] = fa.LAUNCHES, pa.LAUNCHES
    return got


def _allocated(torch):
    """``memory_allocated`` once garbage from earlier work is collected, so
    a difference of two readings is the step between them alone."""
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _isvc_transformer_runtime():
    """A host-side transformer for the phase: texts → texts (lower case,
    a ``[MASK]`` appended) before the predictor, each answer row trimmed
    to its first ``ISVC_TRIM`` ids after it."""
    from kubeflow_tpu_torch.serve.model import Model
    from kubeflow_tpu_torch.serve.spec import ServingRuntime

    class TextTrim(Model):
        def __init__(self, name):
            super().__init__(name)
            self.ready = True

        def preprocess(self, payload, headers=None):
            return {"instances": [f"{t.lower()} [MASK]" for t in payload["instances"]]}

        def postprocess(self, outputs, headers=None):
            return {"predictions": [row[:ISVC_TRIM] for row in outputs["predictions"]]}

    return ServingRuntime(name="isvc-text-trim", supported_formats=("text-trim",),
                          factory=lambda name, path, **kw: TextTrim(name))


def _isvc_revision(name, inner):
    """``inner`` (a controller's revision) served under another name, so
    one server hosts both revisions of a canary."""
    from kubeflow_tpu_torch.serve.model import Model

    class Revision(Model):
        def __init__(self):
            self.name = name

        ready = property(lambda self: inner.ready, lambda self, v: None)

        def load(self):
            return inner.load()

        def unload(self):
            pass  # the controller owns the revision

        def preprocess(self, payload, headers=None):
            return inner.preprocess(payload, headers)

        def predict(self, inputs, headers=None):
            return inner.predict(inputs, headers)

        def postprocess(self, outputs, headers=None):
            return inner.postprocess(outputs, headers)

    return Revision()


def phase_isvc(torch, state):
    """The KServe InferenceService control plane on the card, a line a
    part. (a) kserve-bert from its manifest (``BERT_ISVC_MANIFEST``, its
    ``storageUri`` a directory of seeded f32 bert-base weights, phase
    bert's seed 0) through ``InferenceServiceSpec.from_manifest`` and
    ``InferenceServiceController(default_registry())``, served by a
    ``ModelServer``: cold start (download, load, warmup), every answer of
    the bert phase's texts equal to a direct ``BertRuntimeModel`` of the
    same weights, 12 flash launches a forward on ``fma``, no paged launch.
    (b) a canary of the seed-1 weights at 30%: both revisions resident,
    400 request ids split 0.2–0.4 and each pick ``canary_slot``'s, a
    request on each revision equal to its direct answer; then the
    promotion frees at least 0.9 of the retired revision's weight bytes
    (``memory_allocated``). (c) a ``minReplicas: 0`` service under a
    controller with ``idle_scale_to_zero_s=0``: one request, a tick to 0
    replicas freeing the weights, a cold start on the next route with the
    answer from before, and 5 in flight at ``scale_target`` 1 ticking to
    ``maxReplicas``. (d) a transformer component around the predictor
    (answer = transformer ∘ direct), ``:explain`` without an explainer
    501, an InferenceGraph Ensemble over (b)'s two revisions (each branch
    its revision's direct answer), and a ``RequestLogger`` pairing a
    request and a response event an inference. (e) ``InferenceGateway(
    controller=)`` in front: host ``bert.default`` answers as the direct
    model; a ``causal-lm-engine`` service of the serving phase's bf16
    model and ``ENGINE`` settings from a checkpoint directory, prefix
    affinity in the fed table, the burst through the gateway judged by
    near ties against a directly built ``LMEngine``, paged launches by
    body."""
    import shutil
    import tempfile

    from kubeflow_tpu_torch.gateway.router import canary_slot
    from kubeflow_tpu_torch.gateway.server import GatewayConfig, InferenceGateway
    from kubeflow_tpu_torch.models.bert import BertForMaskedLM, bert_base, init_bert_weights
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serve.controller import InferenceServiceController
    from kubeflow_tpu_torch.serve.graph import GraphSpec
    from kubeflow_tpu_torch.serve.logger import RequestLogger
    from kubeflow_tpu_torch.serve.modelmesh import _device_bytes
    from kubeflow_tpu_torch.serve.runtimes import BertRuntimeModel, default_registry
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.spec import InferenceServiceSpec

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    L = bert_base().num_layers
    launches = {"flash": {}, "paged": {}}
    texts = [BERT_TEXT] + bert_texts()
    root = tempfile.mkdtemp(prefix="kft-isvc-")
    model_dir = os.path.join(root, "models")
    servers, gateways, ok, ctl = [], [], True, None

    def direct(m, text):
        return m.postprocess(m.predict(m.preprocess({"instances": [text]})))[
            "predictions"][0]

    def served(base, name, text):
        return _bert_post(base, f"/v1/models/{name}:predict",
                          {"instances": [text]})["predictions"][0]

    def start(models, **kw):
        srv = ModelServer(models, http_port=0, **kw).start()
        servers.append(srv)
        return srv, f"http://127.0.0.1:{srv.port}"

    try:
        # the weights: bert-base f32 from seeds 0 and 1, as port checkpoints
        t0 = time.perf_counter()
        revs, sds = [], []
        for seed in (0, 1):
            m = BertForMaskedLM(bert_base(), device="cuda")
            init_bert_weights(m, seed)
            sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
            del m
            d = os.path.join(root, f"bert-seed{seed}")
            os.makedirs(d)
            torch.save(sd, os.path.join(d, "state.pt"))
            revs.append(d)
            sds.append(sd)
        write_s = time.perf_counter() - t0
        d0 = BertRuntimeModel("direct-0", None, device="cuda")  # phase bert's
        d1 = BertRuntimeModel("direct-1", None, device="cuda", state_dict=sds[1])
        d0.load()
        d1.load()
        want0 = [direct(d0, t) for t in texts]

        # (a) kserve-bert from its manifest
        reg = default_registry()
        reg.register(_isvc_transformer_runtime())
        ctl = InferenceServiceController(reg, model_dir=model_dir)
        spec = InferenceServiceSpec.from_manifest(isvc_manifest(f"file://{revs[0]}"))
        t0 = time.perf_counter()
        st = ctl.apply(spec)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        m0 = ctl.route("bert")
        m0.warmup()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        param_bytes = _device_bytes(m0)  # the weights ModelMesh would count
        srv_a, base_a = start([m0])
        req0 = m0.stats["requests"]
        _isvc_window(fa, pa)
        got0 = [served(base_a, "bert", t) for t in texts]
        torch.cuda.synchronize()
        fwd = m0.stats["requests"] - req0
        win = _isvc_count(fa, pa, launches)
        good = (st.ready and st.conditions == ["PredictorReady", "Ready"]
                and (st.replicas.ready_replicas, st.replicas.desired_replicas) == (1, 1)
                and got0 == want0 and fwd == len(texts)
                and win["flash_total"] == L * fwd == win["flash"].get("fma", 0)
                and win["paged_total"] == 0)
        emit({"phase": "isvc", "part": "a_manifest", "ok": good,
              "spec": {"name": spec.name, "format": spec.predictor.model_format,
                       "replicas": [spec.predictor.min_replicas,
                                    spec.predictor.max_replicas],
                       "scale_target": spec.predictor.scale_target},
              "conditions": st.conditions, "write_weights_s": write_s,
              "apply_s": apply_s, "cold_start_s": cold_s,
              "downloaded_to": os.path.relpath(m0._storage_path, root),
              "requests": len(texts), "equal_direct": sum(
                  g == w for g, w in zip(got0, want0)),
              "forwards": fwd, "launches": win, "param_bytes": param_bytes,
              "card": state["card"]})
        ok &= good

        # (b) a canary of the seed-1 revision, then its promotion
        doc = isvc_manifest(f"file://{revs[1]}")
        doc["spec"]["predictor"]["canaryTrafficPercent"] = ISVC_CANARY_PCT
        mem0 = _allocated(torch)
        t0 = time.perf_counter()
        st = ctl.apply(InferenceServiceSpec.from_manifest(doc))
        torch.cuda.synchronize()
        canary_s = time.perf_counter() - t0
        grew = _allocated(torch) - mem0
        m1 = st.canary_model
        ids = [f"req-{i}" for i in range(ISVC_IDS)]
        picks = [ctl.route("bert", request_id=i) for i in ids]
        want_pick = [canary_slot(i, ctl.canary_salt) < ISVC_CANARY_PCT for i in ids]
        share = sum(p is m1 for p in picks) / len(picks)
        both = st.default_model is m0 and m0.ready and m1 is not None and m1.ready
        # one server hosts both revisions, with a logger; (d)'s graph runs
        # on it too
        log = RequestLogger()
        srv_b, base_b = start([_isvc_revision("bert-default", m0),
                               _isvc_revision("bert-canary", m1)], logger=log)
        srv_b.register_graph(GraphSpec.from_manifest({
            "kind": "InferenceGraph", "metadata": {"name": "revisions"},
            "spec": {"nodes": {"root": {"routerType": "Ensemble", "steps": [
                {"serviceName": "bert-default", "name": "default"},
                {"serviceName": "bert-canary", "name": "canary"}]}}}}))
        want1 = [direct(d1, t) for t in texts[:4]]
        _isvc_window(fa, pa)
        rev_ok = all(served(base_b, "bert-default", t) == w
                     for t, w in zip(texts[:4], want0))
        rev_ok &= all(served(base_b, "bert-canary", t) == w
                      for t, w in zip(texts[:4], want1))
        graph = [_bert_post(base_b, "/v1/graphs/revisions:infer",
                            {"instances": [t]}) for t in texts[:4]]
        torch.cuda.synchronize()
        win_b = _isvc_count(fa, pa, launches)
        graph_ok = all(
            g == {"default": {"predictions": [w0]}, "canary": {"predictions": [w1]}}
            for g, w0, w1 in zip(graph, want0, want1))
        events = list(log.entries)
        pairs = {}
        for e in events:
            pairs.setdefault(e["requestid"], []).append(e["type"].rsplit(".", 1)[1])
        log_ok = (len(events) == 2 * (8 + 8)
                  and all(v == ["request", "response"] for v in pairs.values()))
        srv_b.kill()  # its proxies must not pin the retired revision
        before = _allocated(torch)
        ctl.promote_canary("bert")
        freed = before - _allocated(torch)
        st = ctl.get("bert")
        good = (both and 0.2 <= share <= 0.4
                and [p is m1 for p in picks] == want_pick and rev_ok
                and st.default_model is m1 and st.canary_model is None
                and not m0.ready and m0.module is None
                and freed >= 0.9 * param_bytes)
        emit({"phase": "isvc", "part": "b_canary", "ok": good,
              "canary_apply_s": canary_s, "memory_grew_bytes": grew,
              "both_resident": both, "ids": ISVC_IDS, "canary_share": share,
              "picks_equal_canary_slot": [p is m1 for p in picks] == want_pick,
              "revisions_equal_direct": rev_ok, "launches": win_b,
              "promotion_freed_bytes": freed, "retired_param_bytes": param_bytes,
              "freed_over_param_bytes": freed / param_bytes, "card": state["card"]})
        ok &= good

        # (c) scale to zero and the cold start
        ctl_z = InferenceServiceController(reg, model_dir=model_dir,
                                           idle_scale_to_zero_s=0.0)
        doc = isvc_manifest(f"file://{revs[0]}")
        doc["spec"]["predictor"]["minReplicas"] = 0
        stz = ctl_z.apply(InferenceServiceSpec.from_manifest(doc))
        mz = ctl_z.route("bert")
        srv_z, base_z = start([mz])
        _isvc_window(fa, pa)
        before_answer = served(base_z, "bert", texts[1])
        _isvc_count(fa, pa, launches)
        before = _allocated(torch)
        to_zero = ctl_z.autoscale_tick("bert")
        freed_z = before - _allocated(torch)
        unready = _http(base_z, "POST", "/v1/models/bert:predict",
                        {"instances": [texts[1]]})[0]
        t0 = time.perf_counter()
        mz2 = ctl_z.route("bert")
        torch.cuda.synchronize()
        cold2_s = time.perf_counter() - t0
        _isvc_window(fa, pa)
        after_answer = served(base_z, "bert", texts[1])
        _isvc_count(fa, pa, launches)
        stz.spec.predictor.scale_target = 1
        stz.replicas.in_flight = 5
        scaled = ctl_z.autoscale_tick("bert")
        stz.replicas.in_flight = 0
        good = (to_zero == 0 and freed_z >= 0.9 * param_bytes and unready == 503
                and mz2 is mz and mz.ready and stz.replicas.cold_starts == 1
                and after_answer == before_answer == want0[1]
                and scaled == stz.spec.predictor.max_replicas == 2)
        emit({"phase": "isvc", "part": "c_scale_to_zero", "ok": good,
              "tick_to": to_zero, "freed_bytes": freed_z,
              "freed_over_param_bytes": freed_z / param_bytes,
              "scaled_to_zero_status": unready, "cold_starts": stz.replicas.cold_starts,
              "cold_start_s": cold2_s, "answer_equal_before": after_answer == before_answer,
              "tick_at_5_in_flight": scaled, "card": state["card"]})
        ok &= good
        srv_z.kill()
        ctl_z.delete("bert")

        # (d) a transformer component, :explain, and (b)'s graph and logger
        doc = isvc_manifest(f"file://{revs[0]}")
        doc["metadata"]["name"] = "bert-t"
        doc["spec"]["transformer"] = {"model": {"modelFormat": {"name": "text-trim"}}}
        stt = ctl.apply(InferenceServiceSpec.from_manifest(doc))
        mt = ctl.route("bert-t")
        srv_t, base_t = start([mt])
        _isvc_window(fa, pa)
        comp = [served(base_t, "bert-t", t) for t in texts[:4]]
        torch.cuda.synchronize()
        win_d = _isvc_count(fa, pa, launches)
        want_t = [direct(d0, f"{t.lower()} [MASK]")[:ISVC_TRIM] for t in texts[:4]]
        explain = _http(base_t, "POST", "/v1/models/bert-t:explain",
                        {"instances": [texts[0]]})[0]
        good = (stt.ready and type(mt).__name__ == "ComposedService"
                and comp == want_t and explain == 501 and graph_ok and log_ok)
        emit({"phase": "isvc", "part": "d_composition", "ok": good,
              "transformer_equal_direct": comp == want_t, "explain_status": explain,
              "graph_branches_equal_direct": graph_ok, "graph_requests": len(graph),
              "logger_events": len(events), "logger_paired": log_ok,
              "launches": win_d, "card": state["card"]})
        ok &= good
        srv_t.kill()
        ctl.delete("bert-t")

        # (e) the gateway fed by the controller, and an LM-engine service
        lm_dir = os.path.join(root, "lm")
        os.makedirs(lm_dir)
        sd_lm = sharpened_state(torch, torch.bfloat16)
        torch.save({k: v.cpu() for k, v in sd_lm.items()},
                   os.path.join(lm_dir, "state.pt"))
        cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
        extra = dict(ENGINE, prefill_buckets=list(ENGINE["prefill_buckets"]),
                     config=cfg, paged_attn_impl="kernel", max_new_tokens=MAX_NEW)
        t0 = time.perf_counter()
        stl = ctl.apply(InferenceServiceSpec.from_manifest({
            "kind": "InferenceService", "metadata": {"name": "lm"},
            "spec": {"predictor": {"model": {
                "modelFormat": {"name": "causal-lm-engine"},
                "storageUri": f"file://{lm_dir}", "extra": extra}}}}))
        lm_apply_s = time.perf_counter() - t0
        mlm = ctl.route("lm")
        srv_bert, base_bert = start([ctl.route("bert")])
        srv_lm, base_lm = start([mlm])
        gw = InferenceGateway(GatewayConfig(backends=[
            ("bert", base_bert, "default"), ("lm", base_lm, "default")]),
            controller=ctl).start()
        gateways.append(gw)
        gbase = f"http://127.0.0.1:{gw.http_port}"
        routes = {r.name: r.view() for r in gw.table.routes()}
        reqs = prompts()
        want_gw = direct(d1, texts[2])
        _isvc_window(fa, pa)
        status, _, text = _http(gbase, "POST", "/v1/models/bert:predict",
                                {"instances": [texts[2]]}, {"Host": "bert.default"})
        bert_gw = status == 200 and json.loads(text)["predictions"][0] == want_gw

        def gen(ids):
            st_, _, body = _http(gbase, "POST", "/v2/models/lm/generate",
                                 {"input_ids": ids, "max_new_tokens": MAX_NEW},
                                 {"Host": "lm.default"})
            if st_ != 200:
                raise RuntimeError(f"generate through the gateway: {st_} {body[:200]}")
            return json.loads(body)["token_ids"]

        t0 = time.perf_counter()
        got_lm = _concurrent(gen, reqs)
        lm_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        win_e = _isvc_count(fa, pa, launches)
        ref = _model(torch, torch.bfloat16, "flash", state_dict=sd_lm)
        want_lm = _engine_streams(torch, ref, "kernel", reqs)
        judged, bad = _judged(torch, ref, reqs, want_lm, got_lm)
        del ref
        n_tok = sum(len(o) for o in got_lm)
        good = (stl.ready and routes.get("bert", {}).get("hosts") == ["bert.default"]
                and routes.get("lm", {}).get("affinity") == "prefix"
                and routes["bert"]["affinity"] == "none" and bert_gw and judged
                and win_e["paged"].get("decode", 0) > 0
                and win_e["paged"].get("mma", 0) > 0)
        emit({"phase": "isvc", "part": "e_gateway", "ok": good,
              "routes": routes, "bert_equal_direct": bert_gw,
              "lm_apply_s": lm_apply_s, "lm_wall_s": lm_wall,
              "lm_tokens": n_tok, "lm_tokens_per_s": n_tok / lm_wall,
              "lm_identical": want_lm == got_lm, "lm_near_ties": bad,
              "launches": win_e, "card": state["card"]})
        ok &= good
    finally:
        for gw in gateways:
            gw.stop()
        for srv in servers:
            if srv._httpd is not None:
                srv.kill()
        if ctl is not None:  # retire what is left: engines stop, weights go
            for name in ("lm", "bert", "bert-t"):
                ctl.delete(name)
        shutil.rmtree(root, ignore_errors=True)
    state["isvc_flash_by_body"] = launches["flash"]
    state["isvc_paged_by_body"] = launches["paged"]
    emit({"phase": "isvc", "part": "total", "ok": ok, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "card": state["card"]})
    return ok


def _device_summary(prof):
    """(kernels, busy ms, kernels by device time) of a profile: busy is
    the union of kernel intervals on the card. Ranges that user
    annotations (``Optimizer.step#...``) mark on the device timeline are
    not kernels and are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0][:60]
            n, ms = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return len(spans), busy_us / 1e3, top


def phase_profile(torch, state):
    """Where the time goes (not in the default run: ``--phases profile``).

    Serving: the bf16 engine on the paged kernel, pipelined (depth 1) and
    then synchronous (depth 0), serves the 8 requests once plainly, for
    the wall time, and once under ``torch.profiler``, for the device time
    by kernel and the time in which some kernel ran (the profiler slows
    the host, so the busy share is given against both walls). Training: the trainer's step (``Trainer._step``, what ``fit``
    runs each step) in bf16 at full width, 2 warm-up steps, 3 plain steps
    for the wall and 3 under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve.engine import LMEngine

    model = _model(torch, torch.bfloat16, "flash",
                   state_dict=sharpened_state(torch, torch.bfloat16))
    reqs = prompts()
    serve_ok = True
    for depth in (1, 0):
        eng = LMEngine(model, paged_attn_impl="kernel", pipeline_depth=depth,
                       **ENGINE).start()
        try:
            eng.submit(reqs[0][:8], max_new_tokens=MAX_NEW)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _concurrent(lambda p: eng.submit(p, max_new_tokens=MAX_NEW), reqs)
            torch.cuda.synchronize()
            plain_wall_ms = (time.perf_counter() - t0) * 1e3
            before = dict(eng.stats)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                outs = _concurrent(lambda p: eng.submit(p, max_new_tokens=MAX_NEW), reqs)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            stats = {k: eng.stats[k] - before[k] for k in ("chunks", "prefill_pieces")}
        finally:
            eng.stop()
        n_kernels, busy_ms, top = _device_summary(prof)
        tokens = sum(len(o) for o in outs)
        serve_ok &= n_kernels > 0 and tokens > 0
        # the paged kernel's two bodies: decode steps and prefill pieces
        paged = {k.split(" ")[-1]: {"count": n, "ms": ms} for k, (n, ms) in top
                 if "paged_attn_" in k}
        emit({"phase": "profile", "path": "serving", "pipeline_depth": depth,
              "dtype": "bf16", "requests": N_REQ, "tokens": tokens,
              "wall_ms": plain_wall_ms, "profiled_wall_ms": wall_ms,
              "chunks": stats["chunks"], "prefill_pieces": stats["prefill_pieces"],
              "kernels": n_kernels, "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / plain_wall_ms,
              "device_busy_share_profiled": busy_ms / wall_ms,
              "top_kernels": [{"name": k, "count": n, "ms": ms}
                              for k, (n, ms) in top[:10]],
              "paged_kernels": paged,
              "paged_share_of_busy": sum(v["ms"] for v in paged.values()) / busy_ms,
              "card": state["card"], "ok": n_kernels > 0 and tokens > 0})
        del eng
    del model
    torch.cuda.empty_cache()

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, make_init_fn, make_loss_fn,
    )
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, adamw
    from kubeflow_tpu_torch.train.prefetch import device_placer

    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **MODEL)
    trainer = Trainer(init_params=make_init_fn(cfg), loss_fn=make_loss_fn(),
                      optimizer=adamw(1e-3),
                      config=TrainConfig(mesh=None, global_batch=TRAIN_BATCH,
                                         steps=8))
    tstate = trainer.init_state()
    place = device_placer(torch.device("cuda"))
    batches = [place(b).claim() for b, _ in zip(_train_data(), range(8))]
    for b in batches[:2]:
        trainer._step(tstate, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:5]:
        trainer._step(tstate, b)
    torch.cuda.synchronize()
    train_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[5:8]:
            trainer._step(tstate, b)
        torch.cuda.synchronize()
        train_prof_ms = (time.perf_counter() - t0) * 1e3
    n_kernels, busy_ms, top = _device_summary(prof)
    device_ms = sum(ms for _, (_, ms) in top)
    names = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkv_wgmma_kernel", "flash_fwd_fma_kernel", "flash_bwd_dq_fma_kernel",
             "flash_bwd_dkv_fma_kernel")
    attn = {k: ms for k, (_, ms) in top if k.split(" ")[-1] in names}
    # bf16 training runs the tensor-core forward, dq and dk/dv
    train_ok = n_kernels > 0 and sorted(k.split(" ")[-1] for k in attn) == sorted(names[:3])
    emit({"phase": "profile", "path": "train", "dtype": "bf16",
          "param_dtype": "f32", "shape": [TRAIN_BATCH, TRAIN_SEQ], "steps": 3,
          "wall_ms": train_wall_ms, "profiled_wall_ms": train_prof_ms,
          "kernels": n_kernels, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / train_wall_ms,
          "device_busy_share_profiled": busy_ms / train_prof_ms,
          "attention_kernels_ms": attn,
          "attention_share_of_device_time": sum(attn.values()) / device_ms,
          "top_kernels": [{"name": k, "count": n, "ms": ms} for k, (n, ms) in top[:12]],
          "card": state["card"], "ok": train_ok})
    return serve_ok and train_ok


# --------------------------------------------------------------------------- #

def ptxas_report(log):
    """``{kernel instantiation: "N registers, S bytes spill"}`` from the
    ``-Xptxas -v`` log nvcc leaves beside each library, with ptxas's
    reason where it makes a kernel wait for each wgmma in turn; names
    demangled by ``c++filt`` where the toolchain has it."""
    import re

    raw, name, spill, serial = {}, None, 0, {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            raw[name] = f"{m.group(1)} registers, {spill} bytes spill"
        m = re.search(r"wgmma.* serialized due to (.*) in the function '(\w+)'", ln)
        if m:
            serial[m.group(2)] = m.group(1)
    for fn, why in serial.items():
        if fn in raw:
            raw[fn] += f", wgmma serialized: {why}"
    names = list(raw)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        out = names
    if len(out) != len(names):
        out = names
    short = [n.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
             for n in out]
    return {s: raw[n] for s, n in zip(short, names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + ("profile",)))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kubeflow_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: kubeflow_tpu_torch not importable: {e}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    state = {"card": card}
    t0 = time.perf_counter()
    build_s = _build.build()
    ptxas = {n: ptxas_report(_build._target(n).with_suffix(".log").read_text())
             for n in _build.sources()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    state["ptxas"] = ptxas
    runners = {"kernels": phase_kernels, "forward": phase_forward,
               "serving": phase_serving, "parity": phase_parity,
               "engine": phase_engine, "contract": phase_contract,
               "disagg": phase_disagg, "fleet": phase_fleet,
               "dense": phase_dense,
               "bert": phase_bert, "train": phase_train, "mlm": phase_mlm,
               "mesh": phase_mesh, "load": phase_load,
               "tp": phase_tp, "job": phase_job, "tabular": phase_tabular,
               "tune": phase_tune, "pipeline": phase_pipeline,
               "isvc": phase_isvc, "profile": phase_profile}
    ok = True
    seconds = {"build": build_s}
    for p in phases:
        tp = time.perf_counter()
        try:
            good = runners[p](torch, state)
        except Exception:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit({"phase": p, "ok": False, "error": traceback.format_exc(limit=3)})
            good = False
        ok &= bool(good)
        torch.cuda.empty_cache()
        seconds[p] = time.perf_counter() - tp
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "by_phase": seconds})
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if all(k in state for k in ("paged_main", "paged_mma", "flash_main", "bwd_main")):
        kernels = []
        train = state.get("train_launches", {})
        served = state.get("paged_launches_by_body", {})
        fleet = state.get("fleet_paged_launches_by_body", {})
        load = state.get("load_paged_launches_by_body", {})
        tune = state.get("tune_paged_launches_by_body", {})
        tune_flash = state.get("tune_flash_launches", {})
        job_flash = state.get("job_flash_launches", {})
        pipe = state.get("pipeline_paged_launches_by_body", {})
        pipe_flash = state.get("pipeline_flash_launches", {})
        isvc = state.get("isvc_paged_by_body", {})
        isvc_flash = state.get("isvc_flash_by_body", {})
        # paged decode on the served burst, the fleet's bursts, the load
        # runs, the tuned model's burst and the pipeline's registered
        # model's (the decode body's launches); the flash forward, timed
        # at the training shape, on the training run, the tune phase's
        # trials, the job phase's trial jobs and the pipeline's train and
        # eval jobs (it also ran the no-cache forward phase's 12 launches)
        # and the isvc phase's (the LM service's decodes; the BERT
        # services' forwards, all on fma)
        for key, launches, src, rep in (
            ("paged_main",
             served.get("decode", 0) + fleet.get("decode", 0) + load.get("decode", 0)
             + tune.get("decode", 0) + pipe.get("decode", 0)
             + isvc.get("decode", 0),
             "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
             "kubeflow_tpu/ops/paged_attention.py:185"),
            ("flash_main",
             train.get("flash_forward", 0) + tune_flash.get("flash_forward", 0)
             + job_flash.get("flash_forward", 0) + pipe_flash.get("flash_forward", 0)
             + sum(isvc_flash.values()),
             "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
             "kubeflow_tpu/ops/flash_attention.py:120"),
        ):
            r = state[key]
            kernels.append({
                "name": r["kernel"], "route": "cuda", "source": src,
                "replaces": rep, "body": r["body"], "launches": launches,
                **({"launches_all_bodies": state.get("paged_launches"),
                    "launches_by_body": served,
                    "launches_by_s": state.get("paged_launches_by_s"),
                    "verify_launches_engine_phase": state.get("verify_launches"),
                    "verify_launches_engine_phase_bf16_by_body":
                        state.get("verify_launches_bf16_by_body"),
                    "launches_contract_phase": state.get("contract_paged_launches"),
                    "launches_contract_phase_by_body":
                        state.get("contract_paged_launches_by_body"),
                    "launches_disagg_phase_by_s": state.get("disagg_paged_launches_by_s"),
                    "launches_disagg_phase_by_body":
                        state.get("disagg_paged_launches_by_body"),
                    # the replicas behind the gateway, in launches too
                    "launches_fleet_phase_by_s": state.get("fleet_paged_launches_by_s"),
                    "launches_fleet_phase_by_body": fleet,
                    # the load harness's replicas, over its three runs
                    "launches_load_phase_by_body": load,
                    # the dense runs of the dense phase: none, by design
                    "launches_dense_phase": state.get("dense_paged_launches"),
                    "launches_bert_phase": state.get("bert_paged_launches"),
                    # the tuned model served from the registry
                    "launches_tune_phase_by_body": tune,
                    # the pipeline's registered model, served
                    "launches_pipeline_phase_by_body": pipe,
                    # the LM-engine InferenceService behind the gateway
                    "launches_isvc_phase_by_body": isvc}
                   if key == "paged_main" else {
                    "launches_tune_phase": tune_flash.get("flash_forward"),
                    # the job phase's trial workers, one process each
                    "launches_job_phase": job_flash.get("flash_forward"),
                    # the pipeline's train and eval step jobs
                    "launches_pipeline_phase": pipe_flash.get("flash_forward"),
                    # the controller's BERT services, by body
                    "launches_isvc_phase": isvc_flash,
                    # the BERT predictor: 12 a forward, by body and dtype,
                    # and the kernel at its serving shapes
                    "launches_bert_phase": state.get("bert_flash_launches"),
                    "launches_bert_phase_by_body": state.get("bert_flash_by_body"),
                    "bert_cases": {
                        n: {k: c[k] for k in ("dtype", "body", "max_abs_err", "ms",
                                              "plain_ms", "library_ms", "bound_ms",
                                              "bound_by")}
                        for n, c in state.get("flash_bert", {}).items()}}),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
        # the paged kernel's tensor-core body on its own: timed at the
        # served prefill piece (B=8, S=32), launched by the served burst's
        # pieces
        r = state["paged_mma"]
        kernels.append({
            "name": "paged_attention_mma", "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "kubeflow_tpu/ops/paged_attention.py:185",
            "body": r["body"], "case": r["case"],
            "launches": (served.get("mma", 0) + fleet.get("mma", 0) + load.get("mma", 0)
                         + tune.get("mma", 0) + pipe.get("mma", 0)
                         + isvc.get("mma", 0)),
            "launches_by_body": served, "launches_fleet_phase_by_body": fleet,
            "launches_load_phase_by_body": load, "launches_tune_phase_by_body": tune,
            "launches_pipeline_phase_by_body": pipe,
            "launches_isvc_phase_by_body": isvc,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        # the forward's f32 body on its own: timed at the BERT serving
        # shape, launched by the bert phase's f32 forwards and the isvc
        # phase's
        r = state.get("flash_bert", {}).get("bert_s128_f32")
        if r is not None:
            kernels.append({
                "name": "flash_attention_fma", "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "kubeflow_tpu/ops/flash_attention.py:120",
                "body": r["body"], "case": "bert_s128_f32",
                "launches": (state.get("bert_flash_by_body", {}).get("f32", {})
                             .get("fma", 0) + isvc_flash.get("fma", 0)),
                "launches_isvc_phase": isvc_flash.get("fma", 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
        # the backward pair on the training path; plain_ms (the twin) and
        # library_ms (the backward of scaled_dot_product_attention with
        # the boolean mask; library_is_causal_ms with is_causal) are each
        # one call computing dq, dk and dv, given for both kernels
        r = state["bwd_main"]
        for name, part, launch_key, rep in (
            ("flash_attention_bwd_dq", "dq", "flash_bwd_dq",
             "kubeflow_tpu/ops/flash_attention.py:453"),
            ("flash_attention_bwd_dkv", "dkv", "flash_bwd_dkv",
             "kubeflow_tpu/ops/flash_attention.py:484"),
        ):
            err = r["max_abs_err"]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": rep, "body": r["body"][part],
                "launches": (train.get(launch_key, 0) + tune_flash.get(launch_key, 0)
                             + job_flash.get(launch_key, 0)
                             + pipe_flash.get(launch_key, 0)),
                "launches_tune_phase": tune_flash.get(launch_key),
                "launches_job_phase": job_flash.get(launch_key),
                "launches_pipeline_phase": pipe_flash.get(launch_key),
                "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                "ms": r["ms"][part], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"][part], "bound_by": r["bound_by"][part],
                "library_ms": r["library_ms"],
                "library_is_causal_ms": r["library_is_causal_ms"],
            })
        # the backward's f32 bodies on their own: timed at the f32 causal
        # case, launched by the train phase's f32 parity steps
        r = state["bwd_f32"]
        parity = state.get("train_parity_launches", {})
        for name, part, launch_key, rep in (
            ("flash_attention_bwd_dq_fma", "dq", "flash_bwd_dq",
             "kubeflow_tpu/ops/flash_attention.py:453"),
            ("flash_attention_bwd_dkv_fma", "dkv", "flash_bwd_dkv",
             "kubeflow_tpu/ops/flash_attention.py:484"),
        ):
            err = r["max_abs_err"]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": rep, "body": r["body"][part], "case": "causal_s128_f32",
                "launches": parity.get(launch_key, {}).get("fma", 0),
                "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                "ms": r["ms"][part], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"][part], "bound_by": r["bound_by"][part],
                "library_ms": r["library_ms"],
            })
        # bert-base MLM training: the three flash kernels, timed at the bf16
        # fit's shape and launched by it (``wgmma``), with the f32 parity
        # steps' ``fma`` launches beside them
        r, bwd = state.get("flash_mlm"), state.get("bwd_mlm", {}).get("mlm_s128_bf16")
        mlm = state.get("mlm_launches", {})
        parity = state.get("mlm_parity_launches", {})
        if r is not None and bwd is not None:
            kernels.append({
                "name": "flash_attention_mlm", "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "kubeflow_tpu/ops/flash_attention.py:120",
                "body": r["body"], "case": "mlm_s128_bf16",
                "launches": mlm.get("flash_forward", {}).get("wgmma", 0),
                "launches_f32_parity_fma": parity.get("flash_forward", {}).get("fma", 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
            for name, part, launch_key, rep in (
                ("flash_attention_bwd_dq_mlm", "dq", "flash_bwd_dq",
                 "kubeflow_tpu/ops/flash_attention.py:453"),
                ("flash_attention_bwd_dkv_mlm", "dkv", "flash_bwd_dkv",
                 "kubeflow_tpu/ops/flash_attention.py:484"),
            ):
                err = bwd["max_abs_err"]
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                    "replaces": rep, "body": bwd["body"][part], "case": "mlm_s128_bf16",
                    "launches": mlm.get(launch_key, {}).get("wgmma", 0),
                    "launches_f32_parity_fma": parity.get(launch_key, {}).get("fma", 0),
                    "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                    "ms": bwd["ms"][part], "plain_ms": bwd["plain_ms"],
                    "bound_ms": bwd["bound_ms"][part], "bound_by": bwd["bound_by"][part],
                    "library_ms": bwd["library_ms"],
                })
        # the mesh phase's LM fits (b and c, every rank): each kernel once
        # a shape they launch it at, timed at that shape: (b)'s ring hops
        # (B=8, 8 heads, 256 against 256 keys: a full block of an earlier
        # rank and the causal diagonal) and (c)'s attention over its
        # fsdp=2 rows (B=4, 16 heads, S=512, causal)
        by_shape = state.get("mesh_launches_by_shape", {})
        for suffix, case in (("ring_hop", "ring_hop_full_s256_h8_bf16"),
                             ("ring_diag", "ring_hop_s256_h8_bf16"),
                             ("mesh_fsdp", "mesh_fsdp_b4_s512_bf16")):
            r = state.get("flash_mesh", {}).get(case)
            bwd = state.get("bwd_mesh", {}).get(case)
            if r is None or bwd is None:
                continue
            kernels.append({
                "name": f"flash_attention_{suffix}", "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "kubeflow_tpu/ops/flash_attention.py:120",
                "body": r["body"], "case": case, "shape": r["shape"],
                "launches": by_shape.get("flash_forward", {}).get(r["shape"], 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
            for part, launch_key, rep in (
                ("dq", "flash_bwd_dq", "kubeflow_tpu/ops/flash_attention.py:453"),
                ("dkv", "flash_bwd_dkv", "kubeflow_tpu/ops/flash_attention.py:484"),
            ):
                err = bwd["max_abs_err"]
                kernels.append({
                    "name": f"flash_attention_bwd_{part}_{suffix}", "route": "cuda",
                    "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                    "replaces": rep, "body": bwd["body"][part], "case": case,
                    "shape": bwd["shape"],
                    "launches": by_shape.get(launch_key, {}).get(bwd["shape"], 0),
                    "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                    "ms": bwd["ms"][part], "plain_ms": bwd["plain_ms"],
                    "bound_ms": bwd["bound_ms"][part], "bound_by": bwd["bound_by"][part],
                    "library_ms": bwd["library_ms"],
                })
        # the tp phase's paged launches at the ranks' share of the heads:
        # each TP case of the kernels phase, timed at its shape and
        # launched there by both ranks
        tp = state.get("tp_launches_by_shape", {})
        for case, r in state.get("paged_tp", {}).items():
            kernels.append({
                "name": f"paged_attention_{case}", "route": "cuda",
                "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
                "replaces": "kubeflow_tpu/ops/paged_attention.py:185",
                "body": r["body"], "case": case, "shape": r["launch_shape"],
                "launches": tp.get(r["launch_shape"], 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
        emit({"kernels": kernels})
    print(card, flush=True)
    # the cards this run used: one
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
