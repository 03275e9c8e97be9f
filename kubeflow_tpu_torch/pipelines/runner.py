"""Pipeline DAG runner: the Argo-workflow + driver analog.

A copy of ``kubeflow_tpu/pipelines/runner.py`` on the port's
orchestrator (``orchestrator/spec.py``) and model registry
(``registry/store.py``). A step's ``TPURequest`` names no generation, as
the JAX runner's does, so it asks the fleet's default label (``"v5e"``):
a fleet that runs pipeline steps must carry that label.

Reference analog (SURVEY.md §2.4, §3.5): the API server turns
PipelineSpec into an Argo Workflow; per node a driver pod resolves
inputs/parameters and checks the MLMD cache, then a launcher executes
the component ([pipelines] backend/src/apiserver/, backend/src/v2/driver/
— UNVERIFIED, SURVEY.md §0).

Here one in-process scheduler plays Argo: tasks are submitted to a
thread pool the moment their dependencies complete (no wave barriers).
The driver role (resolve → cache check → lineage) runs inline; the
launcher role is either in-process `executor.execute` or — when a task
requests TPU chips / multiple workers — a JAXJob through the
orchestrator, per the §3.5 "step creates a JAXJob" mapping.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from kubeflow_tpu_torch.pipelines.artifacts import Artifact, ArtifactStore
from kubeflow_tpu_torch.pipelines.cache import StepCache, cache_key
from kubeflow_tpu_torch.pipelines import executor as _executor
from kubeflow_tpu_torch.pipelines.ir import PipelineIR, TaskIR
from kubeflow_tpu_torch.pipelines.metadata import LineageStore

logger = logging.getLogger(__name__)

SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
SKIPPED = "SKIPPED"          # upstream failed
RUNNING = "RUNNING"
PENDING = "PENDING"


@dataclasses.dataclass
class TaskResult:
    state: str = PENDING
    outputs: dict[str, Any] = dataclasses.field(default_factory=dict)
    cache_hit: bool = False
    error: str = ""
    attempts: int = 0


@dataclasses.dataclass
class RunResult:
    run_id: str
    pipeline: str
    state: str
    tasks: dict[str, TaskResult]
    wall_s: float

    def output(self, task: str, name: str | None = None) -> Any:
        tr = self.tasks[task]
        if name is None:
            if len(tr.outputs) != 1:
                raise ValueError(f"task {task!r} has {len(tr.outputs)} outputs")
            name = next(iter(tr.outputs))
        raw = tr.outputs[name]
        if isinstance(raw, dict) and "value" in raw and "uri" not in raw:
            return raw["value"]
        return Artifact.from_dict(raw)


def resolve_parameters(
    ir: PipelineIR, parameters: dict[str, Any] | None
) -> dict[str, Any]:
    """Merge caller parameters over pipeline defaults, failing fast on
    unknown names and on REQUIRED parameters left unset. Shared by the
    in-process runner and the REST API so a bad request is rejected at
    submit time, not inside the run thread."""
    from kubeflow_tpu_torch.pipelines.dsl import REQUIRED

    params = {name: default for name, default in ir.parameters}
    for k, v in (parameters or {}).items():
        if k not in params:
            raise KeyError(f"unknown pipeline parameter {k!r}")
        params[k] = v
    missing = [k for k, v in params.items()
               if isinstance(v, str) and v == REQUIRED]
    if missing:
        raise ValueError(f"pipeline parameters without values: {missing}")
    return params


class PipelineRunner:
    def __init__(
        self,
        *,
        artifact_store: ArtifactStore,
        cache: StepCache | None = None,
        lineage: LineageStore | None = None,
        cluster: Any | None = None,       # orchestrator LocalCluster, for TPU steps
        model_registry: Any | None = None,  # registry.store.ModelStore
        max_parallel: int = 8,
        job_timeout_s: float = 600.0,
    ):
        self.store = artifact_store
        self.cache = cache
        self.lineage = lineage or LineageStore()
        self.cluster = cluster
        self.model_registry = model_registry
        self.max_parallel = max_parallel
        self.job_timeout_s = job_timeout_s

    # ------------------------------------------------------------------ #

    def run(self, ir: PipelineIR, parameters: dict[str, Any] | None = None,
            *, run_id: str | None = None,
            live_tasks: dict[str, TaskResult] | None = None) -> RunResult:
        """``live_tasks`` (optional): filled with the per-task TaskResult
        objects AS THE RUN STARTS and mutated in place while it executes —
        the REST API's GET /runs/{id} reads task states from it mid-run."""
        t0 = time.monotonic()
        run_id = run_id or uuid.uuid4().hex[:12]
        params = resolve_parameters(ir, parameters)

        ir.topological_order()            # validate DAG up front
        results = {t.name: TaskResult() for t in ir.tasks}
        if live_tasks is not None:
            live_tasks.update(results)
        remaining = {t.name: set(t.deps()) for t in ir.tasks}
        dependents: dict[str, list[str]] = {t.name: [] for t in ir.tasks}
        for t in ir.tasks:
            for d in t.deps():
                dependents[d].append(t.name)

        lock = threading.Lock()
        done_cv = threading.Condition(lock)
        scheduled: set[str] = set()

        def finish(name: str, pool: ThreadPoolExecutor) -> None:
            newly_ready: list[str] = []
            with lock:
                res = results[name]
                for dep_name in dependents[name]:
                    if res.state != SUCCEEDED:
                        if results[dep_name].state == PENDING:
                            results[dep_name].state = SKIPPED
                            results[dep_name].error = f"upstream {name!r} {res.state}"
                            newly_ready.append(dep_name)   # propagate skip
                        continue
                    remaining[dep_name].discard(name)
                    if (not remaining[dep_name]
                            and results[dep_name].state == PENDING
                            and dep_name not in scheduled):
                        scheduled.add(dep_name)
                        newly_ready.append(dep_name)
                done_cv.notify_all()
            for dep_name in newly_ready:
                submit(dep_name, pool)

        def submit(name: str, pool: ThreadPoolExecutor) -> None:
            with lock:
                res = results[name]
                if res.state == SKIPPED:
                    # terminal already; recurse only to propagate the skip
                    pass
                elif res.state != PENDING:
                    return
                else:
                    res.state = RUNNING
            if results[name].state == RUNNING:
                pool.submit(self._run_task_safely, ir, ir.task(name), params,
                            results, run_id, lambda: finish(name, pool))
            else:
                finish(name, pool)

        roots = [t.name for t in ir.tasks if not t.deps()]
        with ThreadPoolExecutor(max_workers=self.max_parallel) as pool:
            for r in roots:
                submit(r, pool)
            with lock:
                while any(r.state in (PENDING, RUNNING)
                          for r in results.values()):
                    done_cv.wait(timeout=0.5)

        state = (SUCCEEDED if all(r.state == SUCCEEDED
                                  for r in results.values()) else FAILED)
        return RunResult(run_id=run_id, pipeline=ir.name, state=state,
                         tasks=results, wall_s=time.monotonic() - t0)

    # ------------------------------------------------------------------ #

    def _run_task_safely(self, ir, task, params, results, run_id, done_cb):
        try:
            self._run_task(ir, task, params, results, run_id)
        except Exception as e:       # driver-level failure
            logger.exception("task %s driver error", task.name)
            results[task.name].state = FAILED
            results[task.name].error = f"{type(e).__name__}: {e}"
        finally:
            done_cb()

    def _run_task(self, ir: PipelineIR, task: TaskIR,
                  params: dict[str, Any], results: dict[str, TaskResult],
                  run_id: str) -> None:
        component = ir.component(task.component)
        res = results[task.name]

        # -- driver: resolve inputs ------------------------------------ #
        kinds = dict(component.input_kinds)
        inputs: dict[str, Any] = {}
        for name, ref in task.inputs:
            if ref.task_output is not None:
                up_task, up_out = ref.task_output
                raw = results[up_task].outputs[up_out]
                inputs[name] = (raw["value"]
                                if isinstance(raw, dict) and "value" in raw
                                and "uri" not in raw else raw)
            elif ref.parameter is not None:
                inputs[name] = params[ref.parameter]
            else:
                inputs[name] = ref.constant
        for name in component.inputs:
            if name not in inputs:
                raise ValueError(
                    f"task {task.name!r}: input {name!r} not wired")

        # -- driver: cache check --------------------------------------- #
        key = cache_key(component, inputs)
        exec_id = self.lineage.begin_execution(run_id, task.name, component.name)
        if task.cache_enabled and self.cache is not None:
            cached = self.cache.lookup(key)
            if cached is not None:
                res.outputs = cached
                res.cache_hit = True
                res.state = SUCCEEDED
                self._record_artifacts(exec_id, kinds, inputs, cached)
                self._register_model_outputs(ir, task, run_id, cached,
                                             cache_hit=True)
                self.lineage.finish_execution(exec_id, state=SUCCEEDED,
                                              cache_hit=True)
                return

        # -- launcher -------------------------------------------------- #
        output_uris = {
            o.name: self.store.uri_for(ir.name, run_id, task.name, o.name)
            for o in component.outputs if o.kind != "parameter"
        }
        payload = {
            "component": component.to_dict(),
            "inputs": inputs,
            "output_uris": output_uris,
        }
        last_err = ""
        for attempt in range(task.retries + 1):
            res.attempts = attempt + 1
            try:
                if task.resources.wants_job and self.cluster is not None:
                    outputs = self._execute_as_job(ir, task, payload, run_id,
                                                   attempt)
                else:
                    outputs = _executor.execute(payload)
                res.outputs = outputs
                res.state = SUCCEEDED
                if task.cache_enabled and self.cache is not None:
                    self.cache.record(key, outputs)
                self._record_artifacts(exec_id, kinds, inputs, outputs)
                self._register_model_outputs(ir, task, run_id, outputs,
                                             cache_hit=False)
                self.lineage.finish_execution(exec_id, state=SUCCEEDED)
                return
            except Exception as e:
                last_err = f"{type(e).__name__}: {e}"
                logger.warning("task %s attempt %d failed: %s",
                               task.name, attempt + 1, last_err)
        res.state = FAILED
        res.error = last_err
        self.lineage.finish_execution(exec_id, state=FAILED, error=last_err)

    def _execute_as_job(self, ir: PipelineIR, task: TaskIR, payload: dict,
                        run_id: str, attempt: int) -> dict:
        """§3.5 mapping: a TPU/multi-worker step becomes a JAXJob gang."""
        from kubeflow_tpu_torch.orchestrator.spec import (
            JobSpec, ReplicaSpec, RunPolicy, TPURequest,
        )
        workdir = os.path.join(self.store.root, ir.name, run_id,
                               task.name, f".exec-{attempt}")
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "task.json"), "w") as f:
            json.dump(payload, f, default=str)
        r = task.resources
        # the executor module must be importable from the job's workdir
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pypath = os.environ.get("PYTHONPATH", "")
        env = {"PYTHONPATH": (pkg_root + os.pathsep + pypath).rstrip(os.pathsep)}
        spec = JobSpec(
            name=f"pipe-{run_id}-{task.name}"[:60],
            labels={"pipeline": ir.name, "run": run_id, "task": task.name},
            replicas={
                "worker": ReplicaSpec(
                    replicas=r.num_workers,
                    command=(sys.executable, "-m",
                             "kubeflow_tpu_torch.pipelines.executor",
                             "--workdir", workdir),
                    env=env,
                    tpu=TPURequest(chips=r.tpu_chips,
                                   topology=r.topology or None),
                )
            },
            run_policy=RunPolicy(backoff_limit=0),
        )
        uid = self.cluster.submit(spec)
        status = self.cluster.wait(uid, timeout=self.job_timeout_s)
        if not status.finished or status.phase != "Succeeded":
            err_path = os.path.join(workdir, "error.txt")
            detail = ""
            if os.path.exists(err_path):
                with open(err_path) as f:
                    detail = f.read()[-2000:]
            raise RuntimeError(
                f"step job {spec.name} phase={status.phase}: {detail}")
        with open(os.path.join(workdir, "outputs.json")) as f:
            return json.load(f)

    def _register_model_outputs(self, ir: PipelineIR, task: TaskIR,
                                run_id: str, outputs: dict,
                                *, cache_hit: bool) -> None:
        """Auto-register declared ``system.Model`` outputs into the model
        registry with run lineage (the KFP → model-registry handoff).
        Components pick the registered name with
        ``model.metadata["register_as"]``; the default is
        ``<pipeline>/<output-name>``. Registration is bookkeeping — a
        registry failure logs, it does not fail the run."""
        if self.model_registry is None:
            return
        for name, v in outputs.items():
            if not (isinstance(v, dict) and v.get("type") == "system.Model"
                    and v.get("uri")):
                continue
            uri = v["uri"]
            local = uri[len("file://"):] if uri.startswith("file://") else uri
            if "://" in local or not os.path.exists(local):
                continue  # remote or never-written output — nothing to ingest
            meta = dict(v.get("metadata") or {})
            reg_name = meta.pop("register_as", None) or f"{ir.name}/{name}"
            try:
                self.model_registry.register_version(
                    reg_name,
                    local,
                    source_uri=uri,
                    metadata={**meta, "pipeline": ir.name, "task": task.name,
                              "cache_hit": cache_hit},
                    lineage=[(
                        "pipeline_run",
                        run_id,
                        {"pipeline": ir.name, "task": task.name,
                         "output": name, "cache_hit": cache_hit},
                    )],
                )
            except Exception:
                logger.exception(
                    "registry: failed to register %s output %s of run %s",
                    task.name, name, run_id,
                )

    def _record_artifacts(self, exec_id: int, kinds: dict,
                          inputs: dict, outputs: dict) -> None:
        for name, v in inputs.items():
            if kinds.get(name, "parameter") != "parameter" and isinstance(v, dict):
                self.lineage.record_artifact(
                    exec_id, uri=v.get("uri", ""), type_=v.get("type", ""),
                    name=name, direction="input",
                    metadata=v.get("metadata", {}))
        for name, v in outputs.items():
            if isinstance(v, dict) and "uri" in v:
                self.lineage.record_artifact(
                    exec_id, uri=v["uri"], type_=v.get("type", ""),
                    name=name, direction="output",
                    metadata=v.get("metadata", {}))
