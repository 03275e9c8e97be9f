"""Experiment / Trial API types with Katib v1beta1 semantics.

A copy of ``kubeflow_tpu/tune/spec.py`` (pure Python).

Reference analog: [katib] pkg/apis/controller/{experiments,suggestions,
trials}/v1beta1/*_types.go (UNVERIFIED, mount empty, SURVEY.md §0):
search space (feasible ranges), objective (metric, goal, type), algorithm,
``parallelTrialCount``/``maxTrialCount``/``maxFailedTrialCount``, trial
template with ``${trialParameters.x}`` substitution, resume policy.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import uuid
from typing import Any, Mapping, Sequence


class ParameterType(str, enum.Enum):
    DOUBLE = "double"
    INT = "int"
    CATEGORICAL = "categorical"
    DISCRETE = "discrete"


@dataclasses.dataclass(frozen=True)
class ParameterSpec:
    """One search-space dimension (Katib FeasibleSpace)."""

    name: str
    type: ParameterType
    min: float | None = None
    max: float | None = None
    values: tuple[Any, ...] = ()  # categorical/discrete
    log_scale: bool = False  # sample in log10 space (lr-style params)
    step: float | None = None  # grid step for double/int

    def __post_init__(self):
        if self.type in (ParameterType.DOUBLE, ParameterType.INT):
            if self.min is None or self.max is None or self.min > self.max:
                raise ValueError(f"{self.name}: numeric params need min<=max")
            if self.log_scale and self.min <= 0:
                raise ValueError(f"{self.name}: log scale needs min>0")
        elif not self.values:
            raise ValueError(f"{self.name}: {self.type.value} params need values")

    # -- numeric <-> unit-interval mapping (optimizers work in [0,1]^d) -----

    def to_unit(self, v: Any) -> float:
        if self.type is ParameterType.CATEGORICAL or self.type is ParameterType.DISCRETE:
            return self.values.index(v) / max(1, len(self.values) - 1)
        lo, hi = float(self.min), float(self.max)
        if self.log_scale:
            lo, hi, v = math.log10(lo), math.log10(hi), math.log10(float(v))
        return 0.0 if hi == lo else (float(v) - lo) / (hi - lo)

    def from_unit(self, u: float) -> Any:
        u = min(1.0, max(0.0, u))
        if self.type in (ParameterType.CATEGORICAL, ParameterType.DISCRETE):
            return self.values[min(len(self.values) - 1, int(u * len(self.values)))]
        lo, hi = float(self.min), float(self.max)
        if self.log_scale:
            v = 10 ** (math.log10(lo) + u * (math.log10(hi) - math.log10(lo)))
        else:
            v = lo + u * (hi - lo)
        return int(round(v)) if self.type is ParameterType.INT else v

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "type": self.type.value,
            "min": self.min,
            "max": self.max,
            "values": list(self.values),
            "log_scale": self.log_scale,
            "step": self.step,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ParameterSpec":
        return cls(
            name=d["name"],
            type=ParameterType(d["type"]),
            min=d.get("min"),
            max=d.get("max"),
            values=tuple(d.get("values", ())),
            log_scale=bool(d.get("log_scale", False)),
            step=d.get("step"),
        )

    def grid(self, n: int = 5) -> list[Any]:
        if self.type in (ParameterType.CATEGORICAL, ParameterType.DISCRETE):
            return list(self.values)
        if self.step is not None:
            k = int(round((float(self.max) - float(self.min)) / self.step)) + 1
            vals = [float(self.min) + i * self.step for i in range(k)]
        else:
            vals = [self.from_unit(i / max(1, n - 1)) for i in range(n)]
        if self.type is ParameterType.INT:
            vals = sorted({int(round(v)) for v in vals})
        return vals


class ObjectiveType(str, enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


@dataclasses.dataclass(frozen=True)
class Objective:
    metric: str
    type: ObjectiveType = ObjectiveType.MINIMIZE
    goal: float | None = None  # reach it ⇒ experiment complete
    additional_metrics: tuple[str, ...] = ()

    def better(self, a: float, b: float) -> bool:
        """True if a is strictly better than b."""
        return a < b if self.type is ObjectiveType.MINIMIZE else a > b

    def reached(self, v: float) -> bool:
        if self.goal is None:
            return False
        return v <= self.goal if self.type is ObjectiveType.MINIMIZE else v >= self.goal


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str = "random"  # random | grid | bayesian | tpe | hyperband | cmaes
    settings: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EarlyStoppingSpec:
    name: str = "medianstop"  # or "none"
    min_trials_required: int = 3
    start_step: int = 4


class TrialState(str, enum.Enum):
    CREATED = "Created"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    EARLY_STOPPED = "EarlyStopped"
    KILLED = "Killed"


@dataclasses.dataclass
class TrialAssignment:
    """One suggested parameter set (Katib's ParameterAssignment list)."""

    parameters: dict[str, Any]
    trial_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex[:8])


@dataclasses.dataclass
class Trial:
    assignment: TrialAssignment
    state: TrialState = TrialState.CREATED
    observations: list[tuple[int, float]] = dataclasses.field(default_factory=list)
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)
    message: str = ""

    @property
    def objective_value(self) -> float | None:
        return self.metrics.get("__objective__")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    name: str
    parameters: tuple[ParameterSpec, ...]
    objective: Objective
    algorithm: AlgorithmSpec = dataclasses.field(default_factory=AlgorithmSpec)
    parallel_trial_count: int = 3
    max_trial_count: int = 12
    max_failed_trial_count: int = 3
    early_stopping: EarlyStoppingSpec | None = None
    # Template: JobSpec-shaped dict; "${trialParameters.x}" placeholders are
    # substituted per-trial (Katib trial-template semantics).
    trial_template: Mapping[str, Any] | None = None

    def validate(self) -> None:
        if not self.parameters:
            raise ValueError("experiment needs at least one parameter")
        if self.parallel_trial_count < 1 or self.max_trial_count < 1:
            raise ValueError("trial counts must be >= 1")
        names = [p.name for p in self.parameters]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "parameters": [p.to_dict() for p in self.parameters],
            "objective": {
                "metric": self.objective.metric,
                "type": self.objective.type.value,
                "goal": self.objective.goal,
                "additional_metrics": list(self.objective.additional_metrics),
            },
            "algorithm": {
                "name": self.algorithm.name,
                "settings": dict(self.algorithm.settings),
            },
            "parallel_trial_count": self.parallel_trial_count,
            "max_trial_count": self.max_trial_count,
            "max_failed_trial_count": self.max_failed_trial_count,
            **(
                {"trial_template": self.trial_template}
                if self.trial_template is not None
                else {}
            ),
            **(
                {
                    "early_stopping": {
                        "name": self.early_stopping.name,
                        "min_trials_required":
                            self.early_stopping.min_trials_required,
                        "start_step": self.early_stopping.start_step,
                    }
                }
                if self.early_stopping is not None
                else {}
            ),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        obj = d.get("objective", {})
        alg = d.get("algorithm", {})
        return cls(
            name=d["name"],
            parameters=tuple(ParameterSpec.from_dict(p) for p in d["parameters"]),
            objective=Objective(
                metric=obj["metric"],
                type=ObjectiveType(obj.get("type", "minimize")),
                goal=obj.get("goal"),
                additional_metrics=tuple(obj.get("additional_metrics", ())),
            ),
            algorithm=AlgorithmSpec(
                name=alg.get("name", "random"), settings=dict(alg.get("settings", {}))
            ),
            parallel_trial_count=int(d.get("parallel_trial_count", 3)),
            max_trial_count=int(d.get("max_trial_count", 12)),
            max_failed_trial_count=int(d.get("max_failed_trial_count", 3)),
            # without these, a manifest-borne Experiment would silently lose
            # its trial command — the one thing that makes it runnable
            trial_template=d.get("trial_template"),
            early_stopping=(
                EarlyStoppingSpec(
                    name=es.get("name", "medianstop"),
                    min_trials_required=int(es.get("min_trials_required", 3)),
                    start_step=int(es.get("start_step", 4)),
                )
                if (es := d.get("early_stopping")) is not None
                else None
            ),
        )


def substitute_template(template: Any, parameters: Mapping[str, Any]) -> Any:
    """Recursively substitute ``${trialParameters.<name>}`` placeholders."""
    mapping = {f"trialParameters.{k}": str(v) for k, v in parameters.items()}
    if isinstance(template, str):
        # string.Template with dotted identifiers needs braces form
        out = template
        for k, v in mapping.items():
            out = out.replace("${" + k + "}", v)
        return out
    if isinstance(template, Mapping):
        return {k: substitute_template(v, parameters) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(substitute_template(v, parameters) for v in template)
    return template
