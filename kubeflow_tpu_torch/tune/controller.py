"""Experiment controller: drive suggestions → parallel trials → optimum.

A copy of ``kubeflow_tpu/tune/controller.py``. ``JobTrialRunner`` waits
for the orchestrator (ROADMAP queue 1 item 15) and raises; everything
else, the registry handoff of the best trial included, is the JAX
controller's.

Reference analog: [katib] pkg/controller.v1beta1/{experiment,trial}/
(UNVERIFIED, mount empty, SURVEY.md §0, call stack §3.4): the experiment
controller asks the Suggestion service for N parameter sets, creates Trials
(each a Job/PyTorchJob from the trial template), watches metrics, tracks the
optimal trial, and completes on goal or maxTrialCount.

Two trial runners:

- ``CallableTrialRunner`` — trial = in-process function(parameters) →
  objective (the unit-test path, and the "tune a train step on this
  card" fast path: trials of a model share one GPU).
- ``JobTrialRunner``      — trial = JAXJob through the orchestrator
  (``LocalCluster``): template → ``JobSpec`` with ``${trialParameters.x}``
  substituted, metrics scraped from worker rank-0 logs with the §5.5 regex
  scraper — the gang-scheduled path of §3.4.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
from typing import Any, Callable, Mapping

from kubeflow_tpu_torch.tune.db import TrialDB
from kubeflow_tpu_torch.tune.earlystop import make_early_stopper
from kubeflow_tpu_torch.tune.spec import (
    ExperimentSpec,
    ObjectiveType,
    Trial,
    TrialAssignment,
    TrialState,
)
from kubeflow_tpu_torch.tune.suggest import Suggester, make_suggester


class TrialRunner:
    """Runs one trial to completion, filling observations/metrics/state."""

    def run(self, trial: Trial, experiment: ExperimentSpec) -> None:
        raise NotImplementedError

    def stop(self, trial: Trial) -> None:  # early-stop hook
        pass


class CallableTrialRunner(TrialRunner):
    def __init__(
        self,
        fn: Callable[[dict], float | dict[str, float] | list[tuple[int, float]]],
    ):
        self.fn = fn

    def run(self, trial: Trial, experiment: ExperimentSpec) -> None:
        obj = experiment.objective
        try:
            result = self.fn(dict(trial.assignment.parameters))
        except Exception as e:
            trial.state = TrialState.FAILED
            trial.message = repr(e)
            return
        if isinstance(result, list):  # [(step, value), ...] curve
            trial.observations = list(result)
            trial.metrics[obj.metric] = result[-1][1]
        elif isinstance(result, Mapping):
            trial.metrics.update(result)
        else:
            trial.metrics[obj.metric] = float(result)
        if obj.metric in trial.metrics:
            trial.metrics["__objective__"] = trial.metrics[obj.metric]
        elif trial.observations:
            trial.metrics["__objective__"] = trial.observations[-1][1]
        trial.state = TrialState.SUCCEEDED


class JobTrialRunner(TrialRunner):
    """Trial = a JobSpec submitted to the orchestrator's LocalCluster.

    The port has no orchestrator yet (ROADMAP queue 1 item 15), so this
    runner cannot be built; trials run through
    :class:`CallableTrialRunner`."""

    def __init__(self, cluster, *, poll_s: float = 0.2, timeout_s: float = 300.0):
        raise NotImplementedError(
            "JobTrialRunner submits trials to the orchestrator, which is "
            "not ported yet (ROADMAP queue 1 item 15): run trials through "
            "CallableTrialRunner"
        )


@dataclasses.dataclass
class ExperimentStatus:
    trials: list[Trial]
    optimal: Trial | None
    succeeded: int
    failed: int
    early_stopped: int
    complete: bool
    reason: str


class ExperimentController:
    def __init__(
        self,
        spec: ExperimentSpec,
        runner: TrialRunner,
        *,
        suggester: Suggester | None = None,
        seed: int = 0,
        db: "TrialDB | None" = None,
        model_registry: Any | None = None,     # registry.store.ModelStore
        register_best_as: str | None = None,
        best_model_path: Callable[[Trial], "str | None"] | None = None,
    ):
        spec.validate()
        if register_best_as is not None and (
            model_registry is None or best_model_path is None
        ):
            raise ValueError(
                "register_best_as needs model_registry and best_model_path"
                " (a Trial → checkpoint-path mapping)"
            )
        self.spec = spec
        self.runner = runner
        self.model_registry = model_registry
        self.register_best_as = register_best_as
        self.best_model_path = best_model_path
        self.registered_best: Any | None = None   # ModelVersion once saved
        self.suggester = suggester or make_suggester(spec, seed)
        self.trials: list[Trial] = []
        self._lock = threading.Lock()
        self._stopper = make_early_stopper(spec.early_stopping, spec.objective)
        self.db = db
        if db is not None:
            # Resume (Katib ResumePolicy + db-manager semantics): terminal
            # trials re-enter history/lineage with their recorded metrics;
            # trials that were mid-flight when the previous controller died
            # are marked KILLED — their jobs are gone, and the budget lets
            # the suggester replace them.
            for t in db.load_trials(spec.name):
                if t.state in (TrialState.CREATED, TrialState.RUNNING):
                    t.state = TrialState.KILLED
                    t.message = "controller restarted mid-trial"
                    db.record_trial(spec.name, t)
                self.trials.append(t)

    def _persist(self, trial: Trial) -> None:
        if self.db is not None:
            self.db.record_trial(self.spec.name, trial)
            obj = self.spec.objective
            if trial.observations:
                # Append only when the stored log is an exact PREFIX of the
                # in-memory log (normalizing tuple-vs-list rows); anything
                # else — divergent values, a longer stored log from a prior
                # controller — is rewritten atomically. A blind tail-append
                # on divergence recorded wrong observations (ADVICE r2).
                want = [(int(s), float(v)) for s, v in trial.observations]
                have = self.db.observations(
                    self.spec.name, trial.assignment.trial_id, obj.metric
                )
                if have == want:
                    pass
                elif len(have) < len(want) and have == want[: len(have)]:
                    self.db.report_observations(
                        self.spec.name,
                        trial.assignment.trial_id,
                        obj.metric,
                        want[len(have):],
                    )
                else:
                    self.db.replace_observations(
                        self.spec.name,
                        trial.assignment.trial_id,
                        obj.metric,
                        want,
                    )

    # -- main loop ----------------------------------------------------------

    def run(self) -> ExperimentStatus:
        spec = self.spec
        obj = spec.objective
        reason = "max_trial_count reached"
        with cf.ThreadPoolExecutor(max_workers=spec.parallel_trial_count) as pool:
            pending: set[cf.Future] = set()
            while True:
                done_count = len(self._terminal())
                if self._failed_count() > spec.max_failed_trial_count:
                    reason = "max_failed_trial_count exceeded"
                    break
                if self._goal_reached():
                    reason = "objective goal reached"
                    break
                if done_count >= spec.max_trial_count:
                    break
                budget = spec.max_trial_count - len(self.trials)
                want = min(spec.parallel_trial_count - len(pending), budget)
                if want > 0:
                    # lineage-aware algorithms (PBT) need trial identities,
                    # not just (params, value) pairs
                    if hasattr(self.suggester, "suggest_trials"):
                        with self._lock:
                            snapshot = list(self.trials)
                        suggestions = self.suggester.suggest_trials(
                            want, snapshot
                        )
                    else:
                        suggestions = self.suggester.suggest(want, self._history())
                    if not suggestions and not pending:
                        reason = "search space exhausted"
                        break
                    for a in suggestions:
                        t = Trial(assignment=a)
                        with self._lock:
                            self.trials.append(t)
                        self._persist(t)
                        pending.add(pool.submit(self._run_one, t))
                if not pending:
                    continue
                finished, pending = cf.wait(
                    pending, return_when=cf.FIRST_COMPLETED
                )
                for f in finished:
                    f.result()  # surface runner crashes
            for f in pending:  # drain in-flight trials before reporting
                f.result()
        self._register_best()
        return self.status(complete=True, reason=reason)

    def _register_best(self) -> None:
        """Katib → model-registry handoff: the winning trial's model
        enters the registry as a new version with a ``tune_trial``
        lineage edge carrying the full assignment and objective, so
        "which hyperparameters produced the production model" stays
        answerable after the experiment object is gone."""
        if self.register_best_as is None:
            return
        best = self.optimal_trial()
        if best is None:
            return
        path = self.best_model_path(best)
        if not path:
            return
        self.registered_best = self.model_registry.register_version(
            self.register_best_as,
            path,
            source_uri="file://" + str(path),
            metadata={
                "experiment": self.spec.name,
                "trial_id": best.assignment.trial_id,
                "parameters": dict(best.assignment.parameters),
                "objective": best.metrics.get("__objective__"),
            },
            lineage=[(
                "tune_trial",
                f"{self.spec.name}/{best.assignment.trial_id}",
                {
                    "parameters": dict(best.assignment.parameters),
                    "objective": best.metrics.get("__objective__"),
                },
            )],
        )

    def _run_one(self, trial: Trial) -> None:
        trial.state = TrialState.RUNNING
        self._persist(trial)
        self.runner.run(trial, self.spec)
        if self._stopper is not None and trial.state is TrialState.SUCCEEDED:
            # retroactive medianstop: mark hopeless completed trials so the
            # suggester's history de-weights them (in-process trials finish
            # too fast to interrupt mid-flight; Job trials get stop()ed).
            with self._lock:
                others = [t for t in self.trials if t is not trial]
                if self._stopper.should_stop(trial, others):
                    trial.state = TrialState.EARLY_STOPPED
                    self.runner.stop(trial)
        self._persist(trial)

    # -- bookkeeping ---------------------------------------------------------

    def _terminal(self) -> list[Trial]:
        with self._lock:
            return [
                t
                for t in self.trials
                if t.state
                in (
                    TrialState.SUCCEEDED,
                    TrialState.FAILED,
                    TrialState.EARLY_STOPPED,
                    TrialState.KILLED,
                )
            ]

    def _failed_count(self) -> int:
        with self._lock:
            return sum(t.state is TrialState.FAILED for t in self.trials)

    def _history(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [
                (dict(t.assignment.parameters), t.metrics["__objective__"])
                for t in self.trials
                if t.state is TrialState.SUCCEEDED and "__objective__" in t.metrics
            ]

    def _goal_reached(self) -> bool:
        obj = self.spec.objective
        return any(obj.reached(v) for _, v in self._history())

    def optimal_trial(self) -> Trial | None:
        obj = self.spec.objective
        best: Trial | None = None
        for t in self.trials:
            v = t.metrics.get("__objective__")
            if v is None:
                continue
            if best is None or obj.better(v, best.metrics["__objective__"]):
                best = t
        return best

    def status(self, *, complete: bool = False, reason: str = "") -> ExperimentStatus:
        with self._lock:
            trials = list(self.trials)
        return ExperimentStatus(
            trials=trials,
            optimal=self.optimal_trial(),
            succeeded=sum(t.state is TrialState.SUCCEEDED for t in trials),
            failed=sum(t.state is TrialState.FAILED for t in trials),
            early_stopped=sum(t.state is TrialState.EARLY_STOPPED for t in trials),
            complete=complete,
            reason=reason,
        )


def tune(
    fn: Callable[[dict], float],
    spec: ExperimentSpec,
    *,
    seed: int = 0,
) -> ExperimentStatus:
    """KatibClient.tune() analog: one-call hyperparameter search."""
    return ExperimentController(spec, CallableTrialRunner(fn), seed=seed).run()
