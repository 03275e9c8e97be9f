"""Metric writers: stdout (tuner-scrapable) and JSONL, and the training
overlap gauges.

A copy of the JAX package's ``train/metrics.py`` ``MetricWriter``,
``NonFiniteMetricError``, ``parse_stdout_metrics`` and
``set_overlap_gauges``, with the same stdout format (``step=3 loss=1.23
accuracy=0.9``), the same ``metrics.jsonl`` and the same
``kubeflow_tpu_train_*`` gauges on the port's registry
(``obs/prom.py``). TensorBoard events are not ported.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Any, IO, Mapping

from kubeflow_tpu_torch.obs import names, prom

#: The hot-loop overlap split (``train/prefetch.py``) as process gauges on
#: the registry, mirrored from every logged line:
#: - data_stall_ms:  mean per-batch wait for the prefetcher this window
#: - h2d_ms:         mean per-batch host assembly + H2D copy
#: - device_step_ms: mean device step time (ready-to-ready on the drain)
#: - compile_ms:     the first step's build and warm-up, reported once
#: - steps_per_sec:  steady-state training steps per second
_OVERLAP_GAUGES = {
    key: prom.REGISTRY.gauge(metric, help_)
    for key, metric, help_ in (
        ("data_stall_ms", names.TRAIN_DATA_STALL_MS,
         "mean ms/batch the loop waited on input data"),
        ("h2d_ms", names.TRAIN_H2D_MS,
         "mean ms/batch of host batch assembly + H2D copy"),
        ("device_step_ms", names.TRAIN_DEVICE_STEP_MS,
         "mean device step ms (drain ready-to-ready)"),
        ("compile_ms", names.TRAIN_COMPILE_MS, "first-step warm-up ms (kernel build included)"),
        ("steps_per_sec", names.TRAIN_STEPS_PER_SEC,
         "steady-state training steps per second"),
    )
}


def set_overlap_gauges(scalars: Mapping[str, Any]) -> None:
    """Mirror the overlap keys present in ``scalars`` onto the gauges."""
    for k, g in _OVERLAP_GAUGES.items():
        v = scalars.get(k)
        if v is not None:
            g.set(float(v))


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
