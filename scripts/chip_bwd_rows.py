#!/usr/bin/env python3
"""Rows a warp in the f32 dq kernel: 8 against 16, on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_bwd_rows.py [--out FILE]

``flash_bwd_dq_fma_kernel`` gives each warp ``DQ_RPW`` query rows
(``kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu``; 4 warps a
block). This builds the source as it is and a copy with ``DQ_RPW = 16``
(nvcc, the package's flags, into the git-ignored ``build/``), checks each
build's dq against the plain twin, and times both at the f32 backward
cases of ``chip_smoke.py`` in turns 8, 16, 16, 8 with ``chip_smoke.time_ms``
(device time, median of 20, L2 flushed). It prints one JSON line a
(variant, case), a summary with the medians of both turns, then the
card's name and power limit; ``--out`` also writes the JSON lines to a
file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CASES = ("causal_s128_f32", "causal_s512_f32", "bert_s128_f32")
RPW = "constexpr int DQ_RPW = 8;"


def build(rows: int) -> ctypes.CDLL:
    """The backward library with ``DQ_RPW = rows``."""
    from kubeflow_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    if RPW not in src:
        raise RuntimeError(f"{RPW!r} not in the dq source")
    out_dir = _build.BUILD_DIR / "bwd_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"flash_attention_bwd_rpw{rows}.cu"
    cu.write_text(src.replace(RPW, f"constexpr int DQ_RPW = {rows};"))
    lib = out_dir / f"flash_attention_bwd_rpw{rows}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    report = chip_smoke.ptxas_report(proc.stdout + proc.stderr)
    print(json.dumps({"rows": rows, "ptxas": {k: v for k, v in report.items()
                                              if "dq_fma" in k}}), flush=True)
    return ctypes.CDLL(str(lib))


def run(torch, lib, name, c, flush):
    """(max |dq - twin|, within tolerance, time_ms of dq) for one case."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import flash_attention_bwd as fb

    _build._libs["flash_attention_bwd"] = lib
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, S, D = c["B"], c["H"], c["S"], c["D"]
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device="cuda") for _ in range(4))
    seg = None
    if c.get("pad"):
        lens = torch.tensor(c["pad"], device="cuda")
        seg = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    kw = dict(causal=c["causal"], scale=1.0 / math.sqrt(D), window=None,
              q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    delta = (dout * out).sum(-1)
    dq = fb.launch_dq(q, k, v, dout, lse, delta, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)[0]
    torch.cuda.synchronize()
    err = (dq - ref).abs().max().item()
    ok = err <= 2e-5 * max(1.0, ref.abs().max().item())
    t = chip_smoke.time_ms(torch, lambda: fb.launch_dq(q, k, v, dout, lse, delta, **kw),
                           flush=flush)
    return err, ok, t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_bwd_rows: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cases = dict(chip_smoke.bwd_cases(torch))
    libs = {rows: build(rows) for rows in (8, 16)}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    times = {(rows, n): [] for rows in libs for n in CASES}
    ok = True
    lines = []
    for rows in (8, 16, 16, 8):
        for name in CASES:
            err, good, t = run(torch, libs[rows], name, cases[name], flush)
            ok &= good
            times[rows, name].append(t)
            line = {"rows": rows, "case": name, "max_abs_err": err, "ok": good, **t}
            lines.append(line)
            print(json.dumps(line), flush=True)
    lines.append({"dq_ms_by_turn": {f"{name} rows {rows}": [t["ms"] for t in times[rows, name]]
                                    for rows in libs for name in CASES},
                  "card": card, "ok": ok})
    print(json.dumps(lines[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(line) + "\n" for line in lines))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
