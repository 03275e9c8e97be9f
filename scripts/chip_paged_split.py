#!/usr/bin/env python3
"""Paged attention's cluster size, body threshold and ring depth: the
shipped kernel against patched variants, on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_paged_split.py [--parent DIR] [--cases all]
        [--variants none] [--out FILE]

``csrc/paged_attention.cu`` splits a row's page groups over a cluster of
``cluster_size(...)`` blocks, sends bf16/f16 spans of more than
``MMA_MIN_GS`` rows a kv head to the tensor-core body, and streams each
warp's chunks through a ring of at most ``NSTAGE`` stages. This builds
the source as it is (``shipped``) and copies patched to the ``VARIANTS``
below (nvcc, the package's flags, in parallel, into the git-ignored
``build/``), and with ``--parent DIR`` the paged kernel of another
checkout unpacked at DIR (``git archive`` into a git-ignored directory),
as ``parent``. It prints each build's ptxas report of the paged kernels,
checks each build's output at every case against the plain twin
(``chip_smoke.compare``) and a second launch bitwise, and times the
kernel at ``CASES`` in turns (every variant, then every variant again in
reverse) with ``chip_smoke.time_ms`` (device time, median of 20, L2
flushed); ``--cases all --variants none`` times every paged case of
``chip_smoke.py`` on the shipped kernel and the parent's. It prints one
JSON line a (variant, case), a summary with every turn's medians, then
the card's name and power limit; ``--out`` also writes the JSON lines to
a file.
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

CASES = ("decode_bf16", "verify_bf16", "suffix_offset_bf16", "long_decode_gqa_bf16",
         "gqa8_decode_bf16", "long_prefill_gqa_bf16")

_CLUSTER = "int cluster_size(long blocks, int groups, int sms) {\n"
_GS = "constexpr int MMA_MIN_GS = 4;"
_STAGES = "constexpr int NSTAGE = 2;"

#: (shipped text, replacement) pairs on paged_attention.cu
VARIANTS = {
    **{f"cluster{c}": [(_CLUSTER, _CLUSTER + f"  return {c};\n")] for c in (1, 2, 4, 8)},
    # the tensor-core body from G * S > 2 (the same spans as shipped here)
    # and from G * S > 8 (the verify and the 8-head GQA decode on decode)
    "mma_above2": [(_GS, _GS.replace("4", "2"))],
    "mma_above8": [(_GS, _GS.replace("4", "8"))],
    "stages3": [(_STAGES, _STAGES.replace("2", "3"))],
    "stages4": [(_STAGES, _STAGES.replace("2", "4"))],
}


def start_build(name: str, subs: list[tuple[str, str]], csrc: Path):
    """Start nvcc on ``csrc``'s paged source with ``subs`` applied;
    returns ``(name, library path, process)``."""
    from kubeflow_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "paged_split" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for p in csrc.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, out_dir / p.name)
    cu = out_dir / "paged_attention.cu"
    src = cu.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: {old[:60]!r} not in the paged source")
        src = src.replace(old, new)
    cu.write_text(src)
    lib = out_dir / "paged_attention.so"
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
        k: v for k, v in report.items() if k.startswith("paged_attn_")}}), flush=True)
    return ctypes.CDLL(str(lib))


def run(torch, lib, name, c, flush):
    """(within tolerance and bitwise repeatable, time_ms) of one case on
    library ``lib``, on ``chip_smoke``'s inputs."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import paged_attention as pa

    _build._libs["paged_attention"] = lib
    q, kp, vp, table, pos0, kw = chip_smoke.paged_inputs(torch, name, c)
    got = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    again = pa.paged_attention(q, kp, vp, table, pos0, **kw)
    ref = pa.paged_attention_reference(q, kp, vp, table, pos0, **kw)
    torch.cuda.synchronize()
    ok = chip_smoke.compare(got, ref, c["dtype"])[2] and torch.equal(got, again)
    ms = chip_smoke.time_ms(torch, lambda: pa.paged_attention(q, kp, vp, table, pos0, **kw),
                            flush=flush)
    return ok, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="another checkout's root, its paged kernel timed as 'parent'")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated chip_smoke paged cases, or 'all'")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated VARIANTS to build beside the shipped "
                    "kernel, or 'none'")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    from kubeflow_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_paged_split: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cases = dict(chip_smoke.paged_cases(torch))
    names = list(cases) if args.cases == "all" else args.cases.split(",")
    chosen = [] if args.variants == "none" else args.variants.split(",")
    builds = [start_build(name, subs, _build.CSRC)
              for name, subs in {"shipped": [], **{v: VARIANTS[v] for v in chosen}}.items()]
    if args.parent is not None:
        builds.append(start_build("parent", [], args.parent / "kubeflow_tpu_torch/ops/csrc"))
    libs = {b[0]: finish_build(*b) for b in builds}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    order = list(libs) + list(libs)[::-1]
    times = {(n, c): [] for n in libs for c in names}
    ok = True
    lines = []
    for turn, name in enumerate(order):
        for case in names:
            good, ms = run(torch, libs[name], case, cases[case], flush)
            times[(name, case)].append(ms["ms"])
            ok &= good
            line = {"variant": name, "case": case, "turn": turn, "ok": good, **ms}
            lines.append(line)
            print(json.dumps(line), flush=True)
    summary = {"summary": {n: {c: times[(n, c)] for c in names} for n in libs},
               "ok": ok}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    _build._libs.pop("paged_attention", None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
