"""Pipeline IR: the PipelineSpec analog.

A copy of ``kubeflow_tpu/pipelines/ir.py``: the same schema
(``"schemaVersion": "kft/v1"``) and the same canonical JSON, byte for
byte, so an IR compiled by either package's DSL reads and runs in the
other.

Reference analog (SURVEY.md §2.4): KFP compiles the DSL to a
PipelineSpec protobuf ([pipelines] api/v2alpha1/pipeline_spec.proto —
UNVERIFIED, SURVEY.md §0) serialized as YAML; golden-file tests diff
compiled IR (§4 "Compiler golden tests").

This IR is plain dataclasses with a canonical, deterministic
``to_dict()`` (sorted keys, stable task ordering) so golden tests can
diff JSON. Input references use the KFP-style discriminated union:
a constant, a pipeline parameter, or an upstream task output.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class InputRef:
    """Where a task input comes from: exactly one of the fields is set."""

    constant: Any = None
    parameter: str | None = None        # pipeline-level parameter name
    task_output: tuple[str, str] | None = None  # (task_name, output_name)

    def to_dict(self) -> dict:
        if self.task_output is not None:
            return {"taskOutput": {"task": self.task_output[0],
                                   "output": self.task_output[1]}}
        if self.parameter is not None:
            return {"parameter": self.parameter}
        return {"constant": self.constant}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "InputRef":
        if "taskOutput" in d:
            t = d["taskOutput"]
            return cls(task_output=(t["task"], t["output"]))
        if "parameter" in d:
            return cls(parameter=d["parameter"])
        return cls(constant=d.get("constant"))


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    name: str
    kind: str = "parameter"          # "parameter" | artifact TYPE string

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind}


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Accelerator request — the `set_gpu_limit`/node-selector surface
    re-targeted to TPU (SURVEY.md §2.4 row 1)."""

    tpu_chips: int = 0
    topology: str = ""               # e.g. "2x4"
    num_workers: int = 1
    cpu_millis: int = 0
    memory_mb: int = 0

    @property
    def wants_job(self) -> bool:
        return self.tpu_chips > 0 or self.num_workers > 1

    def to_dict(self) -> dict:
        return {
            "tpuChips": self.tpu_chips,
            "topology": self.topology,
            "numWorkers": self.num_workers,
            "cpuMillis": self.cpu_millis,
            "memoryMb": self.memory_mb,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ResourceSpec":
        return cls(
            tpu_chips=d.get("tpuChips", 0),
            topology=d.get("topology", ""),
            num_workers=d.get("numWorkers", 1),
            cpu_millis=d.get("cpuMillis", 0),
            memory_mb=d.get("memoryMb", 0),
        )


@dataclasses.dataclass(frozen=True)
class ComponentIR:
    """Reusable component definition: the executable contract."""

    name: str
    source: str                      # python source of the user function
    fn_name: str
    inputs: tuple[str, ...] = ()
    input_kinds: tuple[tuple[str, str], ...] = ()  # name → "parameter"|artifact TYPE
    outputs: tuple[OutputSpec, ...] = ()
    base_env: tuple[tuple[str, str], ...] = ()

    def fingerprint(self) -> str:
        """Stable digest of the executable contract — the cache key half
        that the KFP cache server computes from the component spec."""
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "fnName": self.fn_name,
            "source": self.source,
            "inputs": list(self.inputs),
            "inputKinds": {k: v for k, v in self.input_kinds},
            "outputs": [o.to_dict() for o in self.outputs],
            "env": {k: v for k, v in self.base_env},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ComponentIR":
        return cls(
            name=d["name"],
            source=d["source"],
            fn_name=d["fnName"],
            inputs=tuple(d.get("inputs", ())),
            input_kinds=tuple(sorted(d.get("inputKinds", {}).items())),
            outputs=tuple(
                OutputSpec(o["name"], o.get("kind", "parameter"))
                for o in d.get("outputs", ())
            ),
            base_env=tuple(sorted(d.get("env", {}).items())),
        )


@dataclasses.dataclass(frozen=True)
class TaskIR:
    """One DAG node: a component invocation with wired inputs."""

    name: str
    component: str                   # ComponentIR name
    inputs: tuple[tuple[str, InputRef], ...] = ()
    after: tuple[str, ...] = ()      # explicit ordering deps (dsl .after())
    resources: ResourceSpec = ResourceSpec()
    cache_enabled: bool = True
    retries: int = 0

    def deps(self) -> set[str]:
        data = {
            ref.task_output[0]
            for _, ref in self.inputs
            if ref.task_output is not None
        }
        return data | set(self.after)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "component": self.component,
            "inputs": {k: ref.to_dict() for k, ref in self.inputs},
            "after": sorted(self.after),
            "resources": self.resources.to_dict(),
            "cacheEnabled": self.cache_enabled,
            "retries": self.retries,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TaskIR":
        return cls(
            name=d["name"],
            component=d["component"],
            inputs=tuple(
                (k, InputRef.from_dict(v))
                for k, v in sorted(d.get("inputs", {}).items())
            ),
            after=tuple(d.get("after", ())),
            resources=ResourceSpec.from_dict(d.get("resources", {})),
            cache_enabled=d.get("cacheEnabled", True),
            retries=d.get("retries", 0),
        )


@dataclasses.dataclass(frozen=True)
class PipelineIR:
    name: str
    components: tuple[ComponentIR, ...]
    tasks: tuple[TaskIR, ...]
    parameters: tuple[tuple[str, Any], ...] = ()   # name → default
    description: str = ""

    def component(self, name: str) -> ComponentIR:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(f"component {name!r} not in pipeline {self.name!r}")

    def task(self, name: str) -> TaskIR:
        for t in self.tasks:
            if t.name == name:
                return t
        raise KeyError(f"task {name!r} not in pipeline {self.name!r}")

    def topological_order(self) -> list[list[str]]:
        """Kahn's algorithm into ready-waves; raises on cycles."""
        deps = {t.name: set(t.deps()) for t in self.tasks}
        known = set(deps)
        for t, ds in deps.items():
            missing = ds - known
            if missing:
                raise ValueError(f"task {t!r} depends on unknown {missing}")
        waves: list[list[str]] = []
        done: set[str] = set()
        while len(done) < len(deps):
            ready = sorted(
                t for t, ds in deps.items() if t not in done and ds <= done
            )
            if not ready:
                rest = sorted(set(deps) - done)
                raise ValueError(f"cycle among tasks {rest}")
            waves.append(ready)
            done.update(ready)
        return waves

    def to_dict(self) -> dict:
        return {
            "schemaVersion": "kft/v1",
            "name": self.name,
            "description": self.description,
            "parameters": {k: v for k, v in self.parameters},
            "components": [
                c.to_dict() for c in sorted(self.components, key=lambda c: c.name)
            ],
            "tasks": [t.to_dict() for t in self.tasks],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PipelineIR":
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            parameters=tuple(sorted(d.get("parameters", {}).items())),
            components=tuple(
                ComponentIR.from_dict(c) for c in d.get("components", ())
            ),
            tasks=tuple(TaskIR.from_dict(t) for t in d.get("tasks", ())),
        )

    @classmethod
    def from_json(cls, s: str) -> "PipelineIR":
        return cls.from_dict(json.loads(s))
