#!/usr/bin/env python3
"""Consumer warpgroups a block in the bf16 flash forward: 1 against 2, on
one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_fwd_tiles.py [--out FILE] [--parent DIR]

``flash_fwd_wgmma_kernel`` gives each block one consumer warpgroup of
64 query rows beside its producer warpgroup
(``kubeflow_tpu_torch/ops/csrc/flash_attention.cu``). This builds the
source as it is (``nwg1``) and a copy patched to two consumer warpgroups
(``nwg2``, the ``NWG2`` pairs below) with nvcc and the package's flags
into the git-ignored ``build/``, checks each build's output and lse
against the plain twin (``chip_smoke``'s tolerances, and a second launch
bitwise equal), and times both at ``causal_s512_bf16``,
``bert_s128_bf16``, ``bert_s128_b1_bf16`` and ``causal_s512_d128_bf16``
in turns 1, 2, 2, 1 with ``chip_smoke.time_ms`` (device time, median of
20, L2 flushed). ``--parent DIR`` adds the forward of another checkout at
DIR (its ``kubeflow_tpu_torch/ops/csrc``), timed first and last. The
builds run in parallel. It prints one JSON line a (variant, case), a
summary with every turn's median, then the card's name and power limit;
``--out`` also writes the JSON lines to a file.
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

CASES = ("causal_s512_bf16", "bert_s128_bf16", "bert_s128_b1_bf16", "causal_s512_d128_bf16")

#: ``flash_fwd_wgmma_kernel`` at two consumer warpgroups a block (128 query
#: rows sharing one K/V stream, 2 blocks an SM at D <= 64), as (shipped
#: text, its replacement) pairs on ``flash_attention.cu``. Each warpgroup
#: walks only the kv tiles its own 64 rows reach, [wlo, whi] within the
#: block's [lo, hi], and hands the others back to the producer unread.
NWG2 = [
    ("""constexpr int WG_BQ = 64;        // query rows a block: its consumer warpgroup's
constexpr int WG_THREADS = 256;  // the consumer warpgroup, then the producer warpgroup""",
     """constexpr int WG_ROWS = 64;      // query rows a consumer warpgroup
constexpr int WG_BQ = 128;       // query rows a block: two consumer warpgroups
constexpr int WG_THREADS = 384;  // the consumer warpgroups, then the producer warpgroup"""),
    ("return 1024 + (2 + 2 * wg_stages(DP))", "return 1024 + (4 + 2 * wg_stages(DP))"),
    ("constexpr int wg_blocks(int DP) { return DP == 64 ? 3 : 2; }",
     "constexpr int wg_blocks(int DP) { return DP == 64 ? 2 : 1; }"),
    ("constexpr int WG_PRODUCER_REGS = 32;", "constexpr int WG_PRODUCER_REGS = 24;"),
    ("- 128 * WG_PRODUCER_REGS) / 128 > 240", "- 128 * WG_PRODUCER_REGS) / 256 > 240"),
    ("- 128 * WG_PRODUCER_REGS) / 128) &", "- 128 * WG_PRODUCER_REGS) / 256) &"),
    ("const uint32_t k_s = q_s + 2 * TILE;", "const uint32_t k_s = q_s + 4 * TILE;"),
    ("wg::mbar_init(q_empty(qb), 128);", "wg::mbar_init(q_empty(qb), 256);"),
    ("wg::mbar_init(empty(st), 128);", "wg::mbar_init(empty(st), 256);"),
    ("  if (wgi == 1) {", "  if (wgi == 2) {"),
    ("""        wg::mbar_arrive_expect_tx(q_full(qb), TILE);
        for (int c = 0; c < NB; ++c) {
          wg::tma_load_3d(q_s + qb * TILE + c * wg::BOX_BYTES, &q_map, q_full(qb), c * wg::BOX,
                          q_start, bh);
        }""",
     """        const int nqw = Sq - q_start > WG_ROWS ? 2 : 1;  // warpgroups with rows
        wg::mbar_arrive_expect_tx(q_full(qb), nqw * TILE);
        for (int w = 0; w < nqw; ++w) {
          for (int c = 0; c < NB; ++c) {
            wg::tma_load_3d(q_s + (2 * qb + w) * TILE + c * wg::BOX_BYTES, &q_map, q_full(qb),
                            c * wg::BOX, q_start + w * WG_ROWS, bh);
          }
        }"""),
    ("""      const int b = bh / H;
      const int R = min(WG_BQ, Sq - q_start);  // valid rows of the tile""",
     """      const int b = bh / H;
      q_start += wgi * WG_ROWS;                  // this warpgroup's rows
      const int R = min(WG_ROWS, Sq - q_start);  // none when <= 0"""),
    ("""      const uint32_t qt = q_s + qb * TILE;""",
     """      const uint32_t qt = q_s + (2 * qb + wgi) * TILE;
      // the kv tiles these rows reach, [wlo, whi] within [lo, hi]
      int wlo = lo, whi = lo - 1;
      for (int ik = lo; ik <= hi && R > 0; ++ik) {
        if (tile::tile_runs(q_start, R, ik * BK, off, causal, window)) {
          if (whi < wlo) wlo = ik;
          whi = ik;
        }
      }
      if (causal && q_start + off < 0) {  // a row before the first key: every tile
        wlo = lo;
        whi = hi;
      }"""),
    ("""      wg::mbar_wait(q_full(qb), (n >> 1) & 1);
      if (lo <= hi) {""",
     """      wg::mbar_wait(q_full(qb), (n >> 1) & 1);
      for (int ik = lo; ik < wlo; ++ik) {  // a tile none of these rows reaches: hand it back
        wg::mbar_wait(full(st), ph);
        wg::mbar_arrive(empty(st));
        advance();
      }
      if (wlo <= whi) {"""),
    ("softmax(lo, st, a0, a1);", "softmax(wlo, st, a0, a1);"),
    ("for (int ik = lo + 1; ik <= hi; ++ik) {", "for (int ik = wlo + 1; ik <= whi; ++ik) {"),
    ("""        wg::mbar_arrive(empty(prev));
      }
""",
     """        wg::mbar_arrive(empty(prev));
      }
      for (int ik = max(whi + 1, wlo); ik <= hi; ++ik) {
        wg::mbar_wait(full(st), ph);
        wg::mbar_arrive(empty(st));
        advance();
      }
"""),
    ('asm volatile("bar.sync 1, 128;\\n" ::: "memory");',
     'asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wgi) : "memory");'),
    ("""      if (tid == 0) {
        for (int c = 0; c < NB; ++c) {""",
     """      if ((tid & 127) == 0 && R > 0) {
        for (int c = 0; c < NB; ++c) {"""),
    ("if (tid == 0) wg::bulk_wait();", "if ((tid & 127) == 0) wg::bulk_wait();"),
    ("128 * (WG_PRODUCER_REGS + wg_consumer_regs(DP))",
     "128 * (WG_PRODUCER_REGS + 2 * wg_consumer_regs(DP))"),
]


def start_build(name: str, csrc: Path, subs: list[tuple[str, str]]):
    """Start nvcc on the forward source of ``csrc`` with ``subs`` applied;
    returns ``(name, library path, process)``."""
    from kubeflow_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "fwd_tiles" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for p in csrc.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, out_dir / p.name)
    cu = out_dir / "flash_attention.cu"
    src = cu.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{old!r} not in the forward source")
        src = src.replace(old, new)
    cu.write_text(src)
    lib = out_dir / "flash_attention.so"
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
        k: v for k, v in report.items() if "fwd" in k and "fma" not in k}}), flush=True)
    return ctypes.CDLL(str(lib))


def run(torch, lib, name, c, flush):
    """(max |out - twin|, ok, time_ms) of one case on library ``lib``."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    _build._libs["flash_attention"] = lib
    q, k, v, kw = chip_smoke.flash_case_inputs(torch, name, c)
    out, lse = fa.flash_attention(q, k, v, return_residuals=True, **kw)
    again = fa.flash_attention(q, k, v, return_residuals=True, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err, _, close = chip_smoke.compare(out, ref, q.dtype,
                                       atol=2.0 ** -8 * v.float().abs().max().item())
    ok = (close and (lse - ref_lse).abs().max().item() <= 2e-4
          and torch.equal(out, again[0]) and torch.equal(lse, again[1]))
    t = chip_smoke.time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), flush=flush)
    return err, ok, t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--parent", type=Path, help="a checkout whose forward is timed too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_fwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cases = dict(chip_smoke.flash_cases(torch))
    variants = {"nwg1": (_build.CSRC, []), "nwg2": (_build.CSRC, NWG2)}
    order = list(variants)
    order = order + order[::-1]
    if args.parent is not None:
        variants["parent"] = (args.parent / "kubeflow_tpu_torch" / "ops" / "csrc", [])
        order = ["parent", *order, "parent"]
    started = [start_build(name, src, subs) for name, (src, subs) in variants.items()]
    libs = {b[0]: finish_build(*b) for b in started}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    times = {(n, c): [] for n in libs for c in CASES}
    ok = True
    lines = []
    for name in order:
        for case in CASES:
            err, good, t = run(torch, libs[name], case, cases[case], flush)
            ok &= good
            times[name, case].append(t["ms"])
            line = {"variant": name, "case": case, "max_abs_err": err, "ok": good, **t}
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
