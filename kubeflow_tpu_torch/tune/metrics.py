"""Metrics collectors: parse training output without any SDK in user code.

A copy of ``kubeflow_tpu/tune/metrics.py`` (pure Python); the TFEvents
reader imports tensorboard only when it is called, as the JAX one does.

Reference analog: Katib's metrics-collector sidecar ([katib]
pkg/metricscollector/v1beta1/{file-metricscollector,tfevent-metricscollector}
— UNVERIFIED, mount empty, SURVEY.md §0), injected by webhook, which tails
trial stdout with configurable regex formats or reads TFEvents files and
reports observations over gRPC. SURVEY.md §5.5 calls this "the clever bit":
user code needs zero SDK — it just prints ``metric=value``.

Our trainer's metric writer (train/metrics.py) emits exactly this format,
so trials of our own jobs scrape identically to arbitrary user scripts.
"""

from __future__ import annotations

import os
import re
from typing import Iterable

# Katib's default file-metrics format: "<name>=<float>" tokens anywhere in a
# line, e.g. "epoch 3: loss=0.42 accuracy=0.91". Also accepts "name: value".
_METRIC_RE = re.compile(
    r"([\w.|-]+)\s*[=:]\s*([+-]?\d+(?:\.\d+)?(?:[Ee][+-]?\d+)?)"
)
_STEP_KEYS = ("step", "epoch", "iteration")


def parse_lines(
    lines: Iterable[str], metric_names: set[str] | None = None
) -> list[tuple[int, str, float]]:
    """Extract (step, metric, value) observations from output lines.

    A step counter found on the same line tags the observation; otherwise
    steps are the running count of lines that produced observations.
    """
    out: list[tuple[int, str, float]] = []
    auto_step = 0
    for line in lines:
        pairs = _METRIC_RE.findall(line)
        if not pairs:
            continue
        found = {k.lower(): float(v) for k, v in pairs}
        step = None
        for sk in _STEP_KEYS:
            if sk in found:
                step = int(found[sk])
                break
        if step is None:
            step = auto_step
        got_any = False
        for name, value in found.items():
            if name in _STEP_KEYS:
                continue
            if metric_names is not None and name not in metric_names:
                continue
            out.append((step, name, value))
            got_any = True
        if got_any:
            auto_step += 1
    return out


def collect_from_text(
    text: str, objective_metric: str, additional: Iterable[str] = ()
) -> dict[str, list[tuple[int, float]]]:
    """Scrape a log blob into per-metric observation series."""
    names = {objective_metric.lower(), *[a.lower() for a in additional]}
    series: dict[str, list[tuple[int, float]]] = {n: [] for n in names}
    for step, name, value in parse_lines(text.splitlines(), names):
        series[name].append((step, value))
    return series


def collect_from_tfevents(
    logdir: str, objective_metric: str, additional: Iterable[str] = ()
) -> dict[str, list[tuple[int, float]]]:
    """TFEvents collector: read scalar series from TensorBoard event files."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    names = {objective_metric, *additional}
    series: dict[str, list[tuple[int, float]]] = {n: [] for n in names}
    for root, _, files in os.walk(logdir):
        if not any(f.startswith("events.out.tfevents") for f in files):
            continue
        acc = EventAccumulator(root)
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            if tag in names:
                for ev in acc.Scalars(tag):
                    series[tag].append((ev.step, ev.value))
    for k in series:
        series[k].sort()
    return series


def latest(series: list[tuple[int, float]]) -> float | None:
    return series[-1][1] if series else None


def best(series: list[tuple[int, float]], minimize: bool) -> float | None:
    if not series:
        return None
    vals = [v for _, v in series]
    return min(vals) if minimize else max(vals)
