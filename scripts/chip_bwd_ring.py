#!/usr/bin/env python3
"""The bf16/f16 flash backward's ring and schedule: the shipped kernels
against patched variants, on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_bwd_ring.py [--out FILE]

``flash_bwd_dq_wgmma_kernel`` and ``flash_bwd_dkv_wgmma_kernel``
(``kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu``) stream tiles
through a ring of ``wg_stages`` stages beside ``wg_bufs`` buffers of a
work item's own tiles, with a producer warpgroup of
``WG_PRODUCER_REGS`` registers. This builds the source as it is
(``shipped``) and copies patched to the ``VARIANTS`` below (nvcc, the
package's flags, in parallel, into the git-ignored ``build/``), prints
each build's ptxas report of the two kernels, checks each build's dq,
dk and dv against the plain twin (``chip_smoke.bwd_tolerance``) and a
second launch bitwise, and times both kernels at ``CASES`` in turns
(every variant, then every variant again in reverse) with
``chip_smoke.time_ms`` (device time, median of 20, L2 flushed). It
prints one JSON line a (variant, case), a summary with every turn's
medians, then the card's name and power limit; ``--out`` also writes
the JSON lines to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CASES = ("causal_s512_bf16", "segment_s512_bf16", "causal_s512_d128_bf16", "bert_s128_bf16")

_STAGES = "__host__ __device__ constexpr int wg_stages(int DP) { return DP == 64 ? 4 : 2; }"
_BUFS = "__host__ __device__ constexpr int wg_bufs(int DP) { return DP == 64 ? 2 : 1; }"

#: dq's loop as shipped (a tile's dQ issued once its dS is packed, the
#: next tile's S and dP queued behind it) and in dk/dv's order (the next
#: tile's S and dP issued first, the previous tile's dQ behind them, the
#: elementwise work between the two waits)
DQ_SHIPPED = """          pass(ik, prev, mask);
          pack();
          pin();
          wg::fence();
          issue_dq(prev);
          // tile ik's S and dP queue behind the previous tile's dQ, whose
          // stage is released as soon as it retires
          while ((ik = take(ik, mask)) >= 0) {
            const int sk = st;
            advance();
            wg::fence();
            issue_s(sk);
            wg::wait<1>();  // the previous tile is in dQ, and its stage is read
            wg::fence_operands(dq);
            wg::mbar_arrive(empty(prev));
            wg::wait<0>();
            wg::fence_operands(s);
            wg::fence_operands(dp);
            pass(ik, sk, mask);
            pack();
            pin();
            wg::fence();
            issue_dq(sk);
            prev = sk;
          }
          wg::wait<0>();"""
DQ_OVERLAP = """          pass(ik, prev, mask);
          pack();
          while ((ik = take(ik, mask)) >= 0) {
            const int sk = st;
            advance();
            pin();
            wg::fence();
            issue_s(sk);
            issue_dq(prev);
            wg::wait<1>();
            wg::fence_operands(s);
            wg::fence_operands(dp);
            pass(ik, sk, mask);
            wg::wait<0>();
            wg::fence_operands(dq);
            wg::mbar_arrive(empty(prev));
            pack();
            prev = sk;
          }
          pin();
          wg::fence();
          issue_dq(prev);
          wg::wait<0>();"""

#: (shipped text, replacement) pairs on flash_attention_bwd.cu
VARIANTS = {
    # a ring of 3 stages at D <= 64
    "stages3": [(_STAGES, _STAGES.replace("? 4 : 2", "? 3 : 2"))],
    # one buffer of a work item's own tiles and 5 stages at D <= 64
    "one_buffer": [(_STAGES, _STAGES.replace("? 4 : 2", "? 5 : 2")),
                   (_BUFS, _BUFS.replace("DP == 64 ? 2 : 1", "1"))],
    # dq in dk/dv's issue order
    "dq_overlap": [(DQ_SHIPPED, DQ_OVERLAP)],
    # work items head by head instead of tile index by tile index
    "head_major": [("""    bh = item % (B * H);
    k_start = item / (B * H) * BK;""", """    bh = item / nk;
    k_start = item % nk * BK;"""), ("""    bh = item % (B * H);
    q_start = (nq - 1 - item / (B * H)) * BQ;""", """    bh = item / nq;
    q_start = (nq - 1 - item % nq) * BQ;""")],
    # 32 producer registers (the consumers get 224)
    "producer32": [("constexpr int WG_PRODUCER_REGS = 40;", "constexpr int WG_PRODUCER_REGS = 32;")],
}


def start_build(name: str, subs: list[tuple[str, str]]):
    """Start nvcc on the backward source with ``subs`` applied; returns
    ``(name, library path, process)``."""
    from kubeflow_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "bwd_ring" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for p in _build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, out_dir / p.name)
    cu = out_dir / "flash_attention_bwd.cu"
    src = cu.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: {old[:60]!r} not in the backward source")
        src = src.replace(old, new)
    cu.write_text(src)
    lib = out_dir / "flash_attention_bwd.so"
    return name, lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(name: str, lib: Path, proc) -> ctypes.CDLL:
    """Wait for one build, print its ptxas report and load it."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}:\n{log}")
    report = chip_smoke.ptxas_report(log)
    print(json.dumps({"variant": name, "ptxas": {
        k: v for k, v in report.items() if "_wgmma_kernel" in k}}), flush=True)
    return ctypes.CDLL(str(lib))


def run(torch, lib, name, c, flush):
    """(within tolerance and bitwise repeatable, time_ms of dq, of dk/dv)
    of one case on library ``lib``, on ``chip_smoke``'s inputs."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb

    _build._libs["flash_attention_bwd"] = lib
    q, k, v, dout, lse, out, kw = chip_smoke.bwd_case_inputs(torch, name, c)
    delta = (dout.float() * out.float()).sum(-1)
    launch = lambda: (fb.launch_dq(q, k, v, dout, lse, delta, **kw),  # noqa: E731
                      *fb.launch_dkv(q, k, v, dout, lse, delta, **kw))
    got, again = launch(), launch()
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    tols = chip_smoke.bwd_tolerance(torch, fa, q, k, v, out, lse, dout, kw, refs)
    ok = all(bool(((x - r).abs() <= t).all()) and torch.equal(x, y)
             for x, y, r, t in zip(got, again, refs, tols))
    ms_dq = chip_smoke.time_ms(torch, lambda: fb.launch_dq(q, k, v, dout, lse, delta, **kw),
                               flush=flush)
    ms_dkv = chip_smoke.time_ms(torch, lambda: fb.launch_dkv(q, k, v, dout, lse, delta, **kw),
                                flush=flush)
    return ok, ms_dq, ms_dkv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_bwd_ring: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cases = dict(chip_smoke.bwd_cases(torch))
    variants = {"shipped": [], **VARIANTS}
    started = [start_build(name, subs) for name, subs in variants.items()]
    libs = {b[0]: finish_build(*b) for b in started}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    order = list(libs) + list(libs)[::-1]
    times = {(n, c): [] for n in libs for c in CASES}
    ok = True
    lines = []
    for name in order:
        for case in CASES:
            good, ms_dq, ms_dkv = run(torch, libs[name], case, cases[case], flush)
            ok &= good
            times[name, case].append((ms_dq["ms"], ms_dkv["ms"]))
            line = {"variant": name, "case": case, "ok": good, "dq": ms_dq, "dkv": ms_dkv}
            lines.append(line)
            print(json.dumps(line), flush=True)
    lines.append({"ms_by_turn": {f"{case} {name}": times[name, case]
                                 for name in libs for case in CASES},
                  "card": card, "ok": ok})
    print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(line) + "\n" for line in lines))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
