#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``kubeflow_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``kubeflow_tpu_torch/ops/csrc/`` (nvcc,
sm_90a, into the git-ignored ``build/``) and runs nine phases:

1. kernels — each kernel against its plain PyTorch twin on the card at
   the serving and training shapes, with device times (``time_ms``: the
   median of 20 calls, with the minimum, the spread and the samples
   dropped because the enqueue outran the timer's sleep) for kernel,
   plain version and (for flash, forward and backward)
   ``F.scaled_dot_product_attention`` as a yardstick only, and the body
   that ran (flash forward, dq and dk/dv: ``"mma"``, tensor cores, for
   bf16/f16, ``"scalar"`` for f32; paged attention: ``"split"``, pages
   split across warps), the paged cases including the speculative verify
   (S = K+1 = 5, a different ``pos0`` per row) and a prefill piece at an
   offset;
2. forward — the full-width bf16 ``TransformerLM`` no-cache forward with
   ``attn_impl="flash"`` against the same weights with ``"reference"``;
3. serving — ``ModelServer`` + ``LMEngineModel`` at full width in bf16 on
   the paged-attention kernel, answering 8 concurrent
   ``/v2/models/lm/generate`` requests with the pipelined loop
   (``pipeline_depth=1``, the default) and, from a second model in the
   same server, with the synchronous one (``pipeline_depth=0``), in
   turns 1, 0, 1, 0, 1, 0: each depth's median and spread;
4. f32 parity — the same engine in f32: the ``kernel`` and ``gather``
   read paths must give token-identical greedy streams;
5. engine — the f32 engine on the kernel read path: (a) depth 1 gives
   depth 0's streams; (b) speculative decoding (K=4) gives K=0's greedy
   streams on repeating prompts, accepting drafts through verify
   launches at S=5; (c) chunked prefill with the prefix cache gives the
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
   a dropped ship and a dead peer falling back to a local prefill;
8. dense — the dense KV cache at the same width, bf16: the ``causal-lm``
   runtime (``LMRuntimeModel``) behind ``ModelServer`` with the JAX
   ``bench_generate`` traffic (8 prompts of 128 tokens, 64 and 16 new
   tokens in turns: whole-generation ms, decode step ms, streams against
   the paged engine, text rows against their tokenizer ids), the dense
   ``LMEngine`` with ``bench_engine``'s traffic at depths 1 and 0 against
   the paged kernel engine (tokens/s, TTFT, decode gap), no paged kernel
   launched by a dense run; then in f32 the dense engine's K=4, chunked
   prefill with a prefix cache, seeded resume, a window and a paged
   prefill engine feeding it spans, each identical to the paged engine;
9. train — the full-width LM trained through the flash forward and
   backward kernels: 5 f32 steps against plain attention (gradients and
   losses), then ``Trainer.fit`` in bf16 over f32 weights, 3 + 20 steps,
   whose forward, dq and dk/dv launches must all run the tensor-core
   bodies.

Each phase prints one JSON line. The line before the last lists every
kernel with its launches on its path, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase, or a host
without CUDA or without the package, exits non-zero and prints no
result. ``--phases`` runs a subset (for debugging); ``--phases profile``
adds a ``torch.profiler`` breakdown of one served batch and of 3
training steps.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
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
          "disagg", "dense", "train")

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
    page 0). The page-split kernel gives a row's pages to 4, 2 or 1 warps
    as G * S is at most 4, at most 8, or more: decode, the 8-head GQA
    decode and the prefill pieces take one each. Then long contexts of 64
    pages (16 a warp), GQA with 4 kv heads, and a decode that sees only
    its last page, so three of a block's four warps merge an empty
    partial."""
    base = dict(B=8, H=16, Hkv=16, D=64, P=32, T=1152, W=4)
    long = dict(base, Hkv=4, W=64, T=(8 * 64 + 1) * 32)
    return [
        ("decode_bf16", dict(base, S=1, dtype=torch.bfloat16)),
        ("decode_f32", dict(base, S=1, dtype=torch.float32)),
        ("prefill_bf16", dict(base, S=32, dtype=torch.bfloat16)),
        ("prefill_f32", dict(base, S=32, dtype=torch.float32)),
        ("gqa_prefill_bf16", dict(base, S=32, Hkv=4, dtype=torch.bfloat16)),
        ("gqa8_decode_bf16", dict(base, S=1, Hkv=2, dtype=torch.bfloat16)),
        ("window_prefill_bf16", dict(base, S=32, window=48, dtype=torch.bfloat16)),
        ("int8_decode_bf16", dict(base, S=1, quant=True, dtype=torch.bfloat16)),
        ("int8_prefill_f32", dict(base, S=32, quant=True, dtype=torch.float32)),
        ("pos0_zero_decode_bf16", dict(base, S=1, pos0_zero=True, dtype=torch.bfloat16)),
        ("long_decode_gqa_bf16", dict(long, S=1, pos0_end=True, dtype=torch.bfloat16)),
        ("long_prefill_gqa_bf16", dict(long, S=32, pos0_end=True, dtype=torch.bfloat16)),
        ("long_int8_decode_gqa_bf16", dict(long, S=1, pos0_end=True, quant=True,
                                           dtype=torch.bfloat16)),
        ("long_window700_decode_gqa_bf16", dict(long, S=1, window=700,
                                                dtype=torch.bfloat16)),
        ("long_window700_prefill_gqa_f32", dict(long, S=32, window=700,
                                                dtype=torch.float32)),
        ("last_page_decode_bf16", dict(base, S=1, W=16, T=(8 * 16 + 1) * 32, window=32,
                                       pos0_end=True, dtype=torch.bfloat16)),
        # the engine's new spans: a K=4 speculative verify (G * S = 5, the
        # 2-warp page split) with each row's span at its own position, and
        # a 16-token prefill piece after a 64-token implanted prefix
        ("verify_bf16", dict(base, S=5, pos0_spread=(20, 120), dtype=torch.bfloat16)),
        ("verify_int8_bf16", dict(base, S=5, pos0_spread=(20, 120), quant=True,
                                  dtype=torch.bfloat16)),
        ("suffix_offset_bf16", dict(base, B=1, S=16, pos0_fixed=64, live_rows=True,
                                    dtype=torch.bfloat16)),
    ]


def run_paged_case(torch, name, c, flush):
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
    window = c.get("window")
    kw = dict(page_size=P, window=window, k_scale=ks, v_scale=vs)
    out = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    ref = pa.paged_attention_reference(q, kp, vp, table, pos0, **kw)
    torch.cuda.synchronize()
    err, tol, close = compare(out, ref, dt)
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
        "dtype": _dtname(torch, dt), "body": pa.body(),
        "kv": "int8" if ks is not None else _dtname(torch, dt),
        "window": window, "max_abs_err": err, "tol": tol, "ok": close,
        **_times(ms, plain), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def flash_cases(torch):
    """The training shape first (B=8, H=16, S=512, D=64, causal bf16). The
    bf16 cases run the tensor-core body, the f32 case the scalar one."""
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
    ]


def run_flash_case(torch, name, c, flush):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    B, H, S, D, dt = c["B"], c["H"], c["S"], c["D"], c["dtype"]
    causal = c.get("causal", True)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda").to(dt)
               for _ in range(3))
    seg = kseg = None
    if c.get("seg"):
        # packed rows: 1..4 segments per row at random boundaries
        cuts = torch.rand(B, S, generator=g, device="cuda") < 3.0 / S
        cuts[:, 0] = False
        seg = kseg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    if c.get("dead"):
        kseg = torch.randint(0, 2, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        seg = torch.randint(0, 3, (B, S), generator=g, device="cuda",
                            dtype=torch.int32)
    window = c.get("window")
    kw = dict(causal=causal, window=window, q_segment_ids=seg,
              kv_segment_ids=kseg)
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
    if c.get("dead"):  # rows that see no key: lse at the sentinel in both
        rows = ref_lse <= fa.NEG_INF / 2
        dead = {"rows": int(rows.sum().item()),
                "lse_sentinel": bool((lse[rows] <= fa.NEG_INF / 2).all())}
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), flush=flush)
    plain = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, **kw),
                    flush=flush)
    mask = fa._full_mask(q.shape, k.shape, seg, kseg, causal, window, q.device)
    if window is None and seg is None:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
    library = time_ms(torch, lib, flush=flush)
    visible = B * S * S if mask is None else int(mask.expand(B, 1, S, S).sum().item())
    nbytes = 4 * q.numel() * q.element_size() + B * H * S * 4 + (
        2 * seg.numel() * 4 if seg is not None else 0)
    flops = 4 * D * H * visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtname(torch, dt)] * 1e3
    return {
        "kernel": "flash_attention", "case": name, "shape": [B, H, S, D],
        "dtype": _dtname(torch, dt), "body": fa.body(dt, D), "causal": causal,
        "window": window, "segments": seg is not None, "dead_rows": dead,
        "max_abs_err": err, "tol": tol, "lse_err": lse_err, "lse_tol": lse_tol,
        "ok": close and lse_err <= lse_tol and (
            dead is None or (dead["rows"] > 0 and dead["lse_sentinel"])),
        **_times(ms, plain, library), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def bwd_cases(torch):
    """The training shape first (B=8, H=16, S=512, D=64, causal bf16). The
    dq and dk/dv kernels run their tensor-core bodies on the bf16 and f16
    cases and their scalar bodies on the f32 ones."""
    base = dict(B=8, H=16, D=64, causal=True)
    return [
        ("causal_s512_bf16", dict(base, S=512, dtype=torch.bfloat16)),
        ("causal_s128_f32", dict(base, S=128, dtype=torch.float32)),
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
    ]


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


def run_bwd_case(torch, name, c, flush):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb

    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    B, H, S, D, dt, causal = (c[k] for k in ("B", "H", "S", "D", "dtype", "causal"))
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device="cuda").to(dt)
                     for _ in range(4))
    qseg = kseg = None
    if c.get("seg"):
        cuts = torch.rand(B, S, generator=g, device="cuda") < 3.0 / S
        cuts[:, 0] = False
        qseg = kseg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    if c.get("dead"):
        kseg = torch.randint(0, 2, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        qseg = torch.randint(0, 3, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
    window = c.get("window")
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, window=window,
              q_segment_ids=qseg, kv_segment_ids=kseg)
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
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
    dead = None
    if c.get("dead"):  # dead rows: dq exactly 0
        rows = (lse <= fa.NEG_INF / 2)[..., None].expand_as(got[0])
        dead = {"rows": int((lse <= fa.NEG_INF / 2).sum().item()),
                "dq_zero": bool((got[0][rows] == 0).all())}
        oks.append(dead["rows"] > 0 and dead["dq_zero"])
    ms_dq = time_ms(torch, lambda: fb.launch_dq(q, k, v, dout, lse, delta, **kw),
                    flush=flush)
    ms_dkv = time_ms(torch, lambda: fb.launch_dkv(q, k, v, dout, lse, delta, **kw),
                     flush=flush)
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, **kw), flush=flush)
    mask = fa._full_mask(q.shape, k.shape, qseg, kseg, causal, window, q.device)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if mask is None:
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    else:
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    library = time_ms(torch, lambda: torch.autograd.grad(
        o, leaves, dout, retain_graph=True), flush=flush)
    if mask is None:
        visible = B * S * S
    else:
        visible = int(mask.expand(B, 1, S, S).sum().item())
    # dead rows see nothing: their pairs are masked, so not counted
    el = q.element_size()
    n_in = 4 * q.numel() * el + 2 * B * H * S * 4 + (
        2 * B * S * 4 if qseg is not None else 0)
    grad_bytes = q.numel() * 4
    peak = PEAK_FLOPS[_dtname(torch, dt)]
    bounds = {}
    for kern, nbytes, flops in (("dq", n_in + grad_bytes, 6 * D * H * visible),
                                ("dkv", n_in + 2 * grad_bytes, 8 * D * H * visible)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bounds[kern] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return {
        "kernel": "flash_attention_bwd", "case": name, "shape": [B, H, S, D],
        "dtype": _dtname(torch, dt),
        "body": {"dq": fb.dq_body(dt, D), "dkv": fb.dkv_body(dt, D)},
        "causal": causal, "window": window,
        "segments": qseg is not None, "dead_rows": dead,
        "max_abs_err": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
        "tol_max": {"dq": float(torch.as_tensor(tols[0]).max()),
                    "dk": float(torch.as_tensor(tols[1]).max()),
                    "dv": float(torch.as_tensor(tols[2]).max())},
        "ok": all(oks),
        "ms": {"dq": ms_dq["ms"], "dkv": ms_dkv["ms"]}, "plain_ms": plain["ms"],
        "bound_ms": {"dq": bounds["dq"][0], "dkv": bounds["dkv"][0]},
        "bound_by": {"dq": bounds["dq"][1], "dkv": bounds["dkv"][1]},
        "library_ms": library["ms"],
        "dropped": {"dq": ms_dq["dropped"], "dkv": ms_dkv["dropped"],
                    "plain_ms": plain["dropped"], "library_ms": library["dropped"]},
        "timing": {"dq": ms_dq, "dkv": ms_dkv, "plain_ms": plain,
                   "library_ms": library},
    }


def phase_kernels(torch, state):
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    # the timer's floor: one launch that does next to nothing, after the flush
    one = torch.empty(1, device="cuda")
    emit({"phase": "timer_floor", "op": "fill_ of one float",
          **time_ms(torch, lambda: one.fill_(1.0), flush=flush)})
    ok = True
    for name, c in bwd_cases(torch):
        r = run_bwd_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "causal_s512_bf16":
            state["bwd_main"] = r
    for name, c in paged_cases(torch):
        r = run_paged_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "decode_bf16":
            state["paged_main"] = r
        elif name in ("verify_bf16", "suffix_offset_bf16"):
            state[f"paged_{name}"] = r
    for name, c in flash_cases(torch):
        r = run_flash_case(torch, name, c, flush)
        emit(r)
        ok &= r["ok"]
        if name == "causal_s512_bf16":
            state["flash_main"] = r
    return ok


# --------------------------------------------------------------------------- #
# phase 2: full-width no-cache forward, flash kernel vs plain attention
# --------------------------------------------------------------------------- #

def _model(torch, dtype, attn_impl, seed=0, state_dict=None):
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_weights,
    )

    cfg = TransformerConfig(dtype=dtype, attn_impl=attn_impl, **MODEL)
    m = TransformerLM(cfg, device="cuda")
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

def sharpened_state(torch, dtype):
    """Random weights from a seed with the unembed tied to the embedding
    and the residual branches tempered (bench.py's paged-attention model):
    a fully random head has near-tied logits, so any rounding would flip
    a greedy argmax; this keeps margins a trained LM would have."""
    m = _model(torch, dtype, "flash", seed=0)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    del m
    sd["unembed.weight"] = sd["embed.embedding"].clone()
    for k in sd:
        if "o_proj" in k:
            sd[k] *= 0.5
        elif "down_proj" in k:
            sd[k] *= 0.1
    return sd


def prompts():
    import numpy as np

    rng = np.random.default_rng(0)
    return [
        [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=int(n))]
        for n in rng.integers(8, 28, size=N_REQ)
    ]


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
        pa.LAUNCHES = fa.LAUNCHES = 0
        pa.LAUNCHES_BY_S.clear()
        outs, main = _served_burst(base, models[1], reqs)
        paged_launches, flash_launches = pa.LAUNCHES, fa.LAUNCHES
        by_s = dict(pa.LAUNCHES_BY_S)
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
    ok = (ready and well_formed and paged_launches > 0
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
        logits = model(torch.tensor([ids + want[:i]], device="cuda"))[0, -1]
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

    def run(kw, reqs, warm=(), overlap=None):
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
    motif_reqs = []
    for i in range(N_REQ):
        motif = [int(t) for t in rng.integers(2, MODEL["vocab_size"], size=8)]
        motif_reqs.append((motif * 4)[: 16 + i])
    pa.LAUNCHES = 0
    pa.LAUNCHES_BY_S.clear()
    k4, sk = run(dict(base, spec_draft_tokens=4, spec_ngram=3), motif_reqs)
    by_s = dict(pa.LAUNCHES_BY_S)
    k0, s0 = run(base, motif_reqs)
    same_b, bad_b = _compare_greedy(torch, model, motif_reqs, k0, k4)
    out["b_spec_k4_vs_k0"] = {
        "identical": same_b, "diverged": bad_b, "tokens": sum(map(len, k4)),
        "spec_proposed": sk["spec_proposed"], "spec_accepted": sk["spec_accepted"],
        "chunks_k4": sk["chunks"], "chunks_k0": s0["chunks"],
        "paged_launches_by_s": by_s}

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
        "c": same_c and sc["prefix_hits"] > 0 and sc["prefill_pieces"] > len(pre_reqs),
        "c8": qerr is not None and math.isfinite(qerr) and 0 < qerr < 0.05,
        "d": (len(first) >= 4 and again == first and rest == first[cut:]
              and other != first),
    }
    state["verify_launches"] = by_s.get(5, 0)
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
        pa.LAUNCHES = 0
        pa.LAUNCHES_BY_S.clear()
        bursts = []
        for _ in range(3):
            res = _concurrent(lambda ids: _sse_tokens(server.port, "lm", ids), reqs)
            served["lm"] += len(reqs)
            bursts.append(res)
        launches, by_s = pa.LAUNCHES, dict(pa.LAUNCHES_BY_S)
        state["contract_paged_launches"] = launches
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
            "paged_launches_by_s": by_s,
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
    bytes predicted and measured, ship times, and paged launches by span
    S (the prefill replica runs S=32 only, the decode replica S=1)."""
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
        pa.LAUNCHES = 0
        pa.LAUNCHES_BY_S.clear()
        got = _concurrent(lambda ids: _gen(port["dec"], ids, peer), reqs)
        launches, by_s = pa.LAUNCHES, dict(pa.LAUNCHES_BY_S)
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
            "paged_launches_by_s": by_s,
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
                       and ready["pre"]["role"] == "prefill"
                       and ready["dec"]["role"] == "decode")
        state["disagg_paged_launches_by_s"] = by_s

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
    out["ok"] = all(checks.values()) and len(checks) == 7
    emit(out)
    return out["ok"]


# --------------------------------------------------------------------------- #
# phase 8: the dense KV cache — the causal-lm runtime and the dense engine
# --------------------------------------------------------------------------- #

#: bench_engine's dense engine (``bench.py:990-993``)
DENSE_ENGINE = dict(max_batch=8, max_seq=192, chunk_steps=8,
                    prefill_buckets=(128,), eos_id=1)
#: the paged twin of DENSE_ENGINE: every row's whole context fits at once
DENSE_PAGED = dict(DENSE_ENGINE, kv_pool_tokens=8 * 192 + 32, page_size=32,
                   paged_attn_impl="kernel")
GEN_BATCH, GEN_PROMPT, GEN_LONG, GEN_SHORT = 8, 128, 64, 16
DENSE_NEW = 48
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
    turns (three each): the whole generation's ms at each length, the
    decode step from their difference / 48; the greedy streams against
    the paged engine's on the same weights; text rows over v1 against
    their tokenizer ids. (b) bench_engine's traffic (16 prompts, 48 new
    tokens) on the dense engine at depths 1 and 0 and on the paged kernel
    engine, three bursts each in turns: tokens/s, TTFT p50, decode gap;
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
        for _ in range(3):
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
        for _ in range(3):
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
# phase 9: training through Trainer.fit at full width
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


def phase_train(torch, state):
    """(a) f32 parity with TF32 off: the same initial weights and batches
    through flash attention (forward and backward kernels) and through
    plain attention under autograd, 5 steps of adamw(1e-3): step-1
    gradients of every parameter and the per-step losses must agree. (b)
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
        losses, grads = [], None
        for i, batch in enumerate(batches):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch)
            loss.backward()
            if i == 0:
                grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt.step()
            losses.append(loss.item())
        runs[impl] = (losses, grads)
        del model, opt
        torch.cuda.empty_cache()
    (fl, fg), (rl, rg) = runs["flash"], runs["reference"]
    grad_tol, loss_rtol = 1e-3, 1e-4
    grad_rel = {n: ((fg[n] - rg[n]).abs().max() / rg[n].abs().max()).item()
                for n in rg}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(fl, rl)]
    worst = max(grad_rel, key=grad_rel.get)
    parity_ok = (max(grad_rel.values()) <= grad_tol
                 and max(loss_rel) <= loss_rtol)
    emit({"phase": "train_parity", "dtype": "f32", "tf32": False,
          "shape": [TRAIN_BATCH, TRAIN_SEQ], "steps": PARITY_STEPS,
          "losses_flash": fl, "losses_reference": rl,
          "loss_rel_err_max": max(loss_rel), "loss_rtol": loss_rtol,
          "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst_param": worst,
          "grad_tol": grad_tol, "ok": parity_ok})
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
    fa.LAUNCHES = fb.DQ_LAUNCHES = fb.DKV_LAUNCHES = 0
    for counts in (fa.LAUNCHES_BY_BODY, fb.DQ_LAUNCHES_BY_BODY, fb.DKV_LAUNCHES_BY_BODY):
        counts.update(mma=0, scalar=0)
    _, history = trainer.fit(_train_data, hooks=[stamp])
    torch.cuda.synchronize()
    launches = {"flash_forward": fa.LAUNCHES, "flash_bwd_dq": fb.DQ_LAUNCHES,
                "flash_bwd_dkv": fb.DKV_LAUNCHES}
    # the bf16 step's forward, dq and dk/dv launches all ran the tensor cores
    by_body = {"flash_forward": dict(fa.LAUNCHES_BY_BODY),
               "flash_bwd_dq": dict(fb.DQ_LAUNCHES_BY_BODY),
               "flash_bwd_dkv": dict(fb.DKV_LAUNCHES_BY_BODY)}
    state["train_launches"] = launches
    losses = [h["loss"] for h in history]
    timed_s = ready[steps] - ready[TRAIN_WARM]
    step_ms = timed_s / TRAIN_TIMED * 1e3
    flops = train_flops_per_step()
    want = MODEL["n_layers"] * steps
    finite = all(map(math.isfinite, losses))
    ok = (parity_ok and finite and len(losses) == steps and losses[-1] < losses[0]
          and all(n == want for n in launches.values())
          and all(b == {"mma": want, "scalar": 0} for b in by_body.values())
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
        emit({"phase": "profile", "path": "serving", "pipeline_depth": depth,
              "dtype": "bf16", "requests": N_REQ, "tokens": tokens,
              "wall_ms": plain_wall_ms, "profiled_wall_ms": wall_ms,
              "chunks": stats["chunks"], "prefill_pieces": stats["prefill_pieces"],
              "kernels": n_kernels, "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / plain_wall_ms,
              "device_busy_share_profiled": busy_ms / wall_ms,
              "top_kernels": [{"name": k, "count": n, "ms": ms}
                              for k, (n, ms) in top[:10]],
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
    names = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
             "flash_bwd_dkv_mma_kernel", "flash_fwd_kernel", "flash_bwd_dq_kernel",
             "flash_bwd_dkv_kernel")
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
    ``-Xptxas -v`` log nvcc leaves beside each library; names demangled
    by ``c++filt`` where the toolchain has it."""
    import re

    raw, name, spill = {}, None, 0
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
    runners = {"kernels": phase_kernels, "forward": phase_forward,
               "serving": phase_serving, "parity": phase_parity,
               "engine": phase_engine, "contract": phase_contract,
               "disagg": phase_disagg, "dense": phase_dense,
               "train": phase_train,
               "profile": phase_profile}
    ok = True
    for p in phases:
        try:
            good = runners[p](torch, state)
        except Exception:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit({"phase": p, "ok": False, "error": traceback.format_exc(limit=3)})
            good = False
        ok &= bool(good)
        torch.cuda.empty_cache()
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if all(k in state for k in ("paged_main", "flash_main", "bwd_main")):
        kernels = []
        train = state.get("train_launches", {})
        # paged decode on the served burst; the flash forward, timed at the
        # training shape, on the training run (it also ran the no-cache
        # forward phase's 12 launches)
        for key, launches, src, rep in (
            ("paged_main", state.get("paged_launches", 0),
             "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
             "kubeflow_tpu/ops/paged_attention.py:185"),
            ("flash_main", train.get("flash_forward", 0),
             "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
             "kubeflow_tpu/ops/flash_attention.py:120"),
        ):
            r = state[key]
            kernels.append({
                "name": r["kernel"], "route": "cuda", "source": src,
                "replaces": rep, "body": r["body"], "launches": launches,
                **({"launches_by_s": state.get("paged_launches_by_s"),
                    "verify_launches_engine_phase": state.get("verify_launches"),
                    "launches_contract_phase": state.get("contract_paged_launches"),
                    "launches_disagg_phase_by_s": state.get("disagg_paged_launches_by_s"),
                    # the dense runs of the dense phase: none, by design
                    "launches_dense_phase": state.get("dense_paged_launches")}
                   if key == "paged_main" else {}),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
        # the backward pair on the training path; plain_ms (the twin) and
        # library_ms (the backward of scaled_dot_product_attention) are
        # each one call computing dq, dk and dv, given for both kernels
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
                "launches": train.get(launch_key, 0),
                "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                "ms": r["ms"][part], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"][part], "bound_by": r["bound_by"][part],
                "library_ms": r["library_ms"],
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
