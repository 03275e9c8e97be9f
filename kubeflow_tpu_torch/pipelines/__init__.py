"""Pipelines plane: the KFP equivalent, TPU/local-native.

The port's copy of ``kubeflow_tpu/pipelines/``, with the same file,
class and export names, IR schema (``kft/v1``) and REST routes
(``/apis/v2beta1/...``): the same pipeline compiles to the same IR in
both packages, and either runner can run it. Step jobs run on the port's
``orchestrator/``, ``system.Model`` outputs register in the port's
``registry/``, and the REST API is on the standard library.

Reference analog (SURVEY.md §2.4, [pipelines] repo — UNVERIFIED, mount
empty §0): `@dsl.component` / `@dsl.pipeline` → PipelineSpec IR → Argo
Workflow execution with driver/launcher pods, MLMD lineage, MinIO
artifacts, cache server, ScheduledWorkflow controller.

Here: decorators trace a Python pipeline function into a deterministic
DAG IR; a DAG executor runs components either in-process or as JAXJobs
through the orchestrator (the §3.5 "step creates a JAXJob" mapping);
artifacts live in a local content-addressed store; the step cache and
lineage store replace the cache server and MLMD.
"""

from kubeflow_tpu_torch.pipelines.artifacts import (
    Artifact,
    ArtifactStore,
    Dataset,
    Metrics,
    Model,
)
from kubeflow_tpu_torch.pipelines.api import PipelineAPIServer
from kubeflow_tpu_torch.pipelines.cache import StepCache
from kubeflow_tpu_torch.pipelines.compiler import compile_pipeline
from kubeflow_tpu_torch.pipelines.dsl import Input, Output, component, pipeline
from kubeflow_tpu_torch.pipelines.ir import ComponentIR, PipelineIR, TaskIR
from kubeflow_tpu_torch.pipelines.metadata import LineageStore
from kubeflow_tpu_torch.pipelines.runner import PipelineRunner, RunResult
from kubeflow_tpu_torch.pipelines.scheduler import RecurringRun, RunScheduler

__all__ = [
    "Artifact",
    "ArtifactStore",
    "ComponentIR",
    "Dataset",
    "Input",
    "LineageStore",
    "Metrics",
    "Model",
    "Output",
    "PipelineAPIServer",
    "PipelineIR",
    "PipelineRunner",
    "RecurringRun",
    "RunResult",
    "RunScheduler",
    "StepCache",
    "TaskIR",
    "component",
    "compile_pipeline",
    "pipeline",
]
