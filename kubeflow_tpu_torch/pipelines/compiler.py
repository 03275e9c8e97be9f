"""DSL → IR compiler.

A copy of ``kubeflow_tpu/pipelines/compiler.py``, with the same errors
and messages.

Reference analog (SURVEY.md §2.4 row 1): `Compiler.compile()` traces the
pipeline function and emits PipelineSpec YAML ([pipelines]
sdk/python/kfp/compiler/compiler.py — UNVERIFIED, SURVEY.md §0). Golden
tests diff the emitted IR (§4).
"""

from __future__ import annotations

from typing import Any

from kubeflow_tpu_torch.pipelines.dsl import (
    Pipeline,
    PipelineParam,
    Task,
    TaskOutput,
    _TraceContext,
)
from kubeflow_tpu_torch.pipelines.ir import InputRef, PipelineIR, TaskIR


def _to_ref(value: Any) -> InputRef:
    if isinstance(value, TaskOutput):
        return value.ref()
    if isinstance(value, PipelineParam):
        return value.ref()
    if isinstance(value, Task):
        raise TypeError(
            f"task {value.name!r} passed as an input — pass `.output` "
            "or `.outputs[name]` instead"
        )
    return InputRef(constant=value)


def compile_pipeline(p: Pipeline) -> PipelineIR:
    if not isinstance(p, Pipeline):
        raise TypeError("compile_pipeline() takes a @pipeline-decorated object")
    ctx = _TraceContext()
    prev, _TraceContext.current = _TraceContext.current, ctx
    try:
        p.fn(*[PipelineParam(name) for name, _ in p.parameters])
    finally:
        _TraceContext.current = prev

    tasks = tuple(
        TaskIR(
            name=t.name,
            component=t.component.ir.name,
            inputs=tuple(sorted(
                (k, _to_ref(v)) for k, v in t.inputs.items()
            )),
            after=tuple(sorted(set(t._after))),
            resources=t.resources,
            cache_enabled=t.cache_enabled,
            retries=t.retries,
        )
        for t in ctx.tasks
    )
    ir = PipelineIR(
        name=p.name,
        description=p.description,
        parameters=tuple(p.parameters),
        components=tuple(ctx.components.values()),
        tasks=tasks,
    )
    ir.topological_order()   # validate: unknown deps / cycles fail at compile
    return ir
