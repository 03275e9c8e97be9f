#!/usr/bin/env python3
"""The served burst with request tracing on and off, and another
checkout's, in turns, on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_serving_ab.py [--parent DIR] [--turns 10]
        [--out FILE]

Every server span (``dataplane``) parents the engine's (``engine``,
``queue.wait``, ``prefill``, one ``decode.chunk`` a row a chunk), so the
served path pays the tracer's cost on every request. This runs
``chip_smoke.py --phases serving`` (the 8-prompt burst at pipeline depth
1 and 0, three bursts each) as separate processes, in turns: this
checkout with ``KFT_TRACE=1`` (``traced``) and with ``KFT_TRACE=0``
(``untraced``), and with ``--parent DIR`` the ``chip_smoke.py`` of
another checkout unpacked at DIR (``git archive`` into a git-ignored
directory) as ``parent``. Each process builds or reuses its checkout's
kernels. It prints one JSON line a run (its variant, turn and serving
line), then one summary line: every variant's median, least and most
over all its bursts (``summary``), and each variant against the first
(``parent`` when given, else ``traced``) turn by turn (``paired``: the
ratio of the two processes' medians in each turn, with its median, least
and most over the turns and how many turns were above 1); then the
card's name and power limit. ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(checkout: Path, trace: str) -> dict:
    """The serving phase's JSON line from one ``chip_smoke.py`` process."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "serving"], cwd=checkout,
        env={**os.environ, "KFT_TRACE": trace}, capture_output=True, text=True,
        timeout=900,
    )
    for line in proc.stdout.splitlines():
        if line.startswith('{"phase": "serving"'):
            return json.loads(line)
    raise RuntimeError(f"{checkout}: no serving line (rc {proc.returncode})\n"
                       + proc.stderr[-2000:])


def _spread(values: list[float]) -> dict:
    """Median, least and most of ``values``."""
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


def _ratios(values: list[float]) -> dict:
    """``_spread`` of ratios, and how many of them exceed 1."""
    return {**_spread(values), "n_above_1": sum(v > 1 for v in values)}


def _turn(lines: list[dict], variant: str, turn: int) -> dict:
    (line,) = [ln for ln in lines if ln["variant"] == variant and ln["turn"] == turn]
    return line["by_depth"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    variants = [("traced", ROOT, "1"), ("untraced", ROOT, "0")]
    if args.parent is not None:
        variants.insert(0, ("parent", args.parent.resolve(), "1"))
    lines = []
    for turn in range(args.turns):
        order = variants if turn % 2 == 0 else variants[::-1]
        for name, checkout, trace in order:
            line = {"variant": name, "turn": turn, **serve(checkout, trace)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    keys = ("tokens_per_s", "ttft_ms_p50", "decode_gap_ms")
    summary = {"summary": {}, "paired": {}}
    for name, _, _ in variants:
        runs = [ln["by_depth"] for ln in lines if ln["variant"] == name]
        summary["summary"][name] = {
            depth: {key: _spread([v for r in runs for v in r[depth][key]["values"]])
                    for key in keys}
            for depth in ("1", "0")}
    # each turn runs every variant once: a variant's per-process median
    # over the baseline's in the same turn, as ratios across the turns
    base = variants[0][0]
    for name, _, _ in variants[1:]:
        summary["paired"][f"{name}/{base}"] = {
            depth: {key: _ratios([
                _turn(lines, name, t)[depth][key]["median"]
                / _turn(lines, base, t)[depth][key]["median"]
                for t in range(args.turns)]) for key in keys}
            for depth in ("1", "0")}
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
