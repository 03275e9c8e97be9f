"""Early stopping: median-stop rule.

A copy of ``kubeflow_tpu/tune/earlystop.py`` (pure Python).

Reference analog: [katib] pkg/earlystopping/v1beta1/medianstop/ (UNVERIFIED,
mount empty, SURVEY.md §0): a running trial is stopped when its best
objective so far is worse than the median of completed trials' objectives at
the same step.
"""

from __future__ import annotations

import statistics

from kubeflow_tpu_torch.tune.spec import (
    EarlyStoppingSpec,
    Objective,
    ObjectiveType,
    Trial,
    TrialState,
)


class MedianStop:
    def __init__(self, spec: EarlyStoppingSpec, objective: Objective):
        self.spec = spec
        self.objective = objective

    def should_stop(self, trial: Trial, completed: list[Trial]) -> bool:
        done = [t for t in completed if t.state is TrialState.SUCCEEDED]
        if len(done) < self.spec.min_trials_required or not trial.observations:
            return False
        step = trial.observations[-1][0]
        if step < self.spec.start_step:
            return False
        minimize = self.objective.type is ObjectiveType.MINIMIZE

        def best_up_to(t: Trial) -> float | None:
            vals = [v for s, v in t.observations if s <= step]
            if not vals:
                return None
            return min(vals) if minimize else max(vals)

        peers = [v for v in (best_up_to(t) for t in done) if v is not None]
        if len(peers) < self.spec.min_trials_required:
            return False
        med = statistics.median(peers)
        mine = best_up_to(trial)
        return mine is not None and self.objective.better(med, mine)


def make_early_stopper(spec: EarlyStoppingSpec | None, objective: Objective):
    if spec is None or spec.name == "none":
        return None
    if spec.name == "medianstop":
        return MedianStop(spec, objective)
    raise ValueError(f"unknown early-stopping rule '{spec.name}'")
