"""Metric writers: stdout (tuner-scrapable) and JSONL.

A copy of the JAX package's ``train/metrics.py`` ``MetricWriter``,
``NonFiniteMetricError`` and ``parse_stdout_metrics``, with the same
stdout format (``step=3 loss=1.23 accuracy=0.9``) and the same
``metrics.jsonl``. The Prometheus overlap gauges need ``obs/prom``, which
the port has not copied yet (ROADMAP queue 1 item 7); TensorBoard events
are not ported either.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Any, IO, Mapping


class NonFiniteMetricError(RuntimeError):
    """A training metric went NaN/inf: fail fast instead of training
    into noise."""


class MetricWriter:
    """Rank-0-gated metric writer: one stdout line per write and, with a
    ``logdir``, one JSON line in ``logdir/metrics.jsonl``."""

    def __init__(
        self,
        logdir: str | Path | None = None,
        *,
        is_writer: bool = True,
        stdout: IO[str] | None = None,
        nan_alarm: bool = True,
    ):
        self.is_writer = is_writer
        #: raise NonFiniteMetricError on NaN/inf metrics, on every rank
        self.nan_alarm = nan_alarm
        self.logdir = Path(logdir) if logdir else None
        self._stdout = stdout or sys.stdout
        self._jsonl: IO[str] | None = None
        if self.is_writer and self.logdir:
            self.logdir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.logdir / "metrics.jsonl", "a")

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        scalars = {k: _to_scalar(v) for k, v in metrics.items()}
        if self.nan_alarm:
            bad = {k: v for k, v in scalars.items() if not math.isfinite(v)}
            if bad:
                raise NonFiniteMetricError(
                    f"non-finite metrics at step {step}: {bad} — a batch or "
                    "the optimizer state is poisoned"
                )
        if not self.is_writer:
            return
        line = " ".join(
            [f"step={step}"] + [f"{k}={v:.6g}" for k, v in scalars.items()]
        )
        print(line, file=self._stdout, flush=True)
        if self._jsonl:
            self._jsonl.write(
                json.dumps({"step": step, "time": time.time(), **scalars}) + "\n"
            )
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _to_scalar(v: Any) -> float:
    """Tensors and numbers → python floats (a CUDA tensor syncs: call it
    off the loop thread)."""
    if hasattr(v, "detach"):
        return float(v.detach().float().mean())
    return float(v)


def parse_stdout_metrics(text: str) -> list[dict[str, float]]:
    """Inverse of ``write``: scrape ``key=value`` lines. Non-numeric
    tokens are skipped."""
    out = []
    for line in text.splitlines():
        found = {}
        for k, v in re.findall(r"(\w+)=([^\s]+)", line):
            try:
                found[k] = float(v)
            except ValueError:
                continue
        if "step" in found and len(found) > 1:
            out.append(found)
    return out
