"""Pipeline DSL: `@component`, `@pipeline`, Input/Output artifact markers.

A copy of ``kubeflow_tpu/pipelines/dsl.py``. ``set_tpu_request(chips=)``
keeps its name and its IR key (``tpuChips``): under the orchestrator's
``gpu`` wiring a chip is a CUDA card. A component's serialized source
starts at its ``def`` and is re-executed by the executor, so a component
is a module-level function whose body imports what it uses.

Reference analog (SURVEY.md §2.4 row 1): KFP's `@dsl.component` turns a
python function into a containerized component; `@dsl.pipeline` traces a
function whose body calls components, producing tasks wired by data
edges; `ContainerOp.set_gpu_limit()` / node selectors are the GPU
resource surface ([pipelines] sdk/python/kfp/dsl/ — UNVERIFIED,
SURVEY.md §0). Here `.set_tpu_request()` is that surface re-targeted to
TPU chips + topology, and tracing happens at compile time via
placeholder `TaskOutput` objects instead of container command lines.
"""

from __future__ import annotations

import dataclasses
import inspect
import textwrap
import typing
from typing import Any, Callable, Generic, TypeVar

from kubeflow_tpu_torch.pipelines.artifacts import Artifact
from kubeflow_tpu_torch.pipelines.ir import (
    ComponentIR,
    InputRef,
    OutputSpec,
    ResourceSpec,
)

T = TypeVar("T")


class Input(Generic[T]):
    """Annotation marker: `x: Input[Dataset]` — artifact consumed by value."""


class Output(Generic[T]):
    """Annotation marker: `x: Output[Model]` — artifact the fn writes to."""


def _annotation_kind(ann: Any) -> tuple[str, str]:
    """→ ("parameter"|"input_artifact"|"output_artifact", artifact TYPE)."""
    origin = typing.get_origin(ann)
    if origin in (Input, Output):
        (atype,) = typing.get_args(ann)
        if not (isinstance(atype, type) and issubclass(atype, Artifact)):
            raise TypeError(f"Input/Output arg must be an Artifact type, got {atype}")
        kind = "input_artifact" if origin is Input else "output_artifact"
        return kind, atype.TYPE
    return "parameter", ""


@dataclasses.dataclass(frozen=True)
class TaskOutput:
    """Placeholder for one task output while tracing a pipeline body."""

    task: "Task"
    name: str

    def ref(self) -> InputRef:
        return InputRef(task_output=(self.task.name, self.name))


class Task:
    """A component invocation recorded during pipeline tracing —
    the ContainerOp analog (mutable: resource/caching setters chain)."""

    def __init__(self, component: "Component", name: str,
                 inputs: dict[str, Any]):
        self.component = component
        self.name = name
        self.inputs = inputs           # name → constant | TaskOutput | PipelineParam
        self.resources = ResourceSpec()
        self.cache_enabled = True
        self.retries = 0
        self._after: list[str] = []

    # --- chained setters (ContainerOp surface) ------------------------ #

    def set_tpu_request(self, chips: int, topology: str = "",
                        num_workers: int = 1) -> "Task":
        """`set_gpu_limit` / `add_node_selector_constraint('gke-accelerator')`
        analog: ask for TPU chips (+ optional topology, multi-worker gang)."""
        self.resources = dataclasses.replace(
            self.resources, tpu_chips=chips, topology=topology,
            num_workers=num_workers,
        )
        return self

    def set_cpu_request(self, millis: int) -> "Task":
        self.resources = dataclasses.replace(self.resources, cpu_millis=millis)
        return self

    def set_memory_request(self, mb: int) -> "Task":
        self.resources = dataclasses.replace(self.resources, memory_mb=mb)
        return self

    def set_caching_options(self, enabled: bool) -> "Task":
        self.cache_enabled = enabled
        return self

    def set_retry(self, retries: int) -> "Task":
        self.retries = retries
        return self

    def after(self, *tasks: "Task") -> "Task":
        self._after.extend(t.name for t in tasks)
        return self

    # --- output access ------------------------------------------------ #

    @property
    def output(self) -> TaskOutput:
        outs = self.component.ir.outputs
        if len(outs) != 1:
            raise ValueError(
                f"task {self.name!r} has {len(outs)} outputs; use .outputs[name]"
            )
        return TaskOutput(self, outs[0].name)

    @property
    def outputs(self) -> dict[str, TaskOutput]:
        return {o.name: TaskOutput(self, o.name) for o in self.component.ir.outputs}


@dataclasses.dataclass(frozen=True)
class PipelineParam:
    """Placeholder for a pipeline-level parameter during tracing."""

    name: str

    def ref(self) -> InputRef:
        return InputRef(parameter=self.name)


class _TraceContext:
    current: "_TraceContext | None" = None

    def __init__(self) -> None:
        self.tasks: list[Task] = []
        self.components: dict[str, ComponentIR] = {}
        self._names: dict[str, int] = {}

    def unique(self, base: str) -> str:
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}-{n + 1}"

    def record(self, task: Task) -> None:
        self.tasks.append(task)
        prior = self.components.get(task.component.ir.name)
        if prior is not None and prior != task.component.ir:
            raise ValueError(
                f"two different components both named "
                f"{task.component.ir.name!r} used in one pipeline — "
                "give one an explicit @component(name=...)"
            )
        self.components[task.component.ir.name] = task.component.ir


class Component:
    """A `@component`-decorated function: callable directly (plain python)
    or inside a `@pipeline` body (records a Task)."""

    def __init__(self, fn: Callable, name: str | None = None,
                 env: dict[str, str] | None = None):
        self.fn = fn
        hints = typing.get_type_hints(fn, include_extras=True)
        sig = inspect.signature(fn)
        inputs, input_kinds, outputs = [], [], []
        for pname in sig.parameters:
            ann = hints.get(pname, str)
            kind, atype = _annotation_kind(ann)
            if kind == "output_artifact":
                outputs.append(OutputSpec(pname, kind=atype))
            else:
                inputs.append(pname)
                input_kinds.append((pname, atype or "parameter"))
        ret = hints.get("return")
        if ret is not None and ret is not type(None):  # noqa: E721
            outputs.append(OutputSpec("Output", kind="parameter"))
        try:
            source = textwrap.dedent(inspect.getsource(fn))
        except OSError:  # interactively-defined fn; executor will refuse jobs
            source = ""
        # strip decorator lines (possibly multi-line calls) so the
        # serialized source starts at the def and is re-executable
        lines = source.splitlines()
        while lines and not lines[0].startswith(("def ", "async def ")):
            lines.pop(0)
        self.ir = ComponentIR(
            name=name or fn.__name__.replace("_", "-"),
            source="\n".join(lines),
            fn_name=fn.__name__,
            inputs=tuple(inputs),
            input_kinds=tuple(input_kinds),
            outputs=tuple(outputs),
            base_env=tuple(sorted((env or {}).items())),
        )

    def __call__(self, *args, **kwargs):
        ctx = _TraceContext.current
        if ctx is None:
            return self.fn(*args, **kwargs)   # plain python call
        bound: dict[str, Any] = {}
        names = list(self.ir.inputs)
        if args:
            if len(args) > len(names):
                raise TypeError(f"{self.ir.name}: too many positional args")
            bound.update(zip(names, args))
        for k, v in kwargs.items():
            if k not in names:
                raise TypeError(f"{self.ir.name}: unexpected argument {k!r}")
            if k in bound:
                raise TypeError(f"{self.ir.name}: duplicate argument {k!r}")
            bound[k] = v
        task = Task(self, ctx.unique(self.ir.name), bound)
        ctx.record(task)
        return task


def component(fn: Callable | None = None, *, name: str | None = None,
              env: dict[str, str] | None = None):
    if fn is None:
        return lambda f: Component(f, name=name, env=env)
    return Component(fn, name=name, env=env)


# JSON-safe sentinel for "parameter has no default" — distinct from a
# legitimate default of None
REQUIRED = "__kft_required__"


class Pipeline:
    def __init__(self, fn: Callable, name: str | None = None,
                 description: str = ""):
        self.fn = fn
        self.name = name or fn.__name__.replace("_", "-")
        self.description = description
        sig = inspect.signature(fn)
        self.parameters: list[tuple[str, Any]] = []
        for pname, p in sig.parameters.items():
            default = (REQUIRED if p.default is inspect.Parameter.empty
                       else p.default)
            self.parameters.append((pname, default))


def pipeline(fn: Callable | None = None, *, name: str | None = None,
             description: str = ""):
    if fn is None:
        return lambda f: Pipeline(f, name=name, description=description)
    return Pipeline(fn, name=name, description=description)
