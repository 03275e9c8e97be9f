"""Pipelines REST API: upload pipelines, create/watch runs, recurring CRUD.

The port's ``kubeflow_tpu/pipelines/api.py``: the same routes, bodies
and error contract, served by the standard library's ``http.server``
(``obs/webhost.py``) instead of aiohttp.

Reference analog (SURVEY.md §2.4 "API server / resource manager" row): the
KFP API server's REST surface — UploadPipeline, CreateRun, GetRun,
ListRuns, recurring-run CRUD ([pipelines] backend/src/apiserver/ —
UNVERIFIED, mount empty, SURVEY.md §0). The reference fronts a MySQL
resource manager and compiles to Argo; here the resource manager IS the
in-process ``PipelineRunner`` + ``RunScheduler``, and the wire format is
the canonical ``PipelineIR`` JSON the compiler emits (``kft pipeline
compile``), so upload → create-run → poll → artifact lineage all ride one
spec format end to end.

Route shapes follow the KFP v2beta1 naming so a reference user's muscle
memory transfers: ``/apis/v2beta1/pipelines``, ``/apis/v2beta1/runs``,
``/apis/v2beta1/recurringruns``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from kubeflow_tpu_torch.obs.webhost import ThreadedHTTPServer
from kubeflow_tpu_torch.pipelines.ir import PipelineIR
from kubeflow_tpu_torch.pipelines.runner import (
    FAILED,
    PENDING,
    RUNNING,
    PipelineRunner,
    RunResult,
    TaskResult,
    resolve_parameters,
)
from kubeflow_tpu_torch.pipelines.scheduler import RecurringRun, RunScheduler


@dataclasses.dataclass
class _RunRecord:
    run_id: str
    pipeline: str
    state: str = PENDING
    created_at: float = dataclasses.field(default_factory=time.time)
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: shared with the runner (mutated in place while the run executes)
    tasks: dict[str, TaskResult] = dataclasses.field(default_factory=dict)
    #: the run's DAG structure, captured at submit (inline specs have no
    #: registry entry to consult later): [{name, component, deps}]
    dag: list[dict] = dataclasses.field(default_factory=list)
    result: RunResult | None = None
    error: str = ""

    def to_dict(self, *, detail: bool = True) -> dict:
        d = {
            "run_id": self.run_id,
            "pipeline": self.pipeline,
            "state": self.state,
            "created_at": self.created_at,
            "error": self.error,
        }
        if self.result is not None:
            d["wall_s"] = round(self.result.wall_s, 4)
        if detail:
            d["parameters"] = self.parameters
            d["tasks"] = {
                name: {
                    "state": tr.state,
                    "cache_hit": tr.cache_hit,
                    "attempts": tr.attempts,
                    "error": tr.error,
                }
                for name, tr in self.tasks.items()
            }
        return d


class PipelineAPIServer(ThreadedHTTPServer):
    """The write path for pipelines: everything the dashboard's read-only
    ``/api/pipelines`` view cannot do. Runs execute on a bounded worker
    pool; GET /runs/{id} observes live per-task state via the runner's
    ``live_tasks`` handoff."""

    thread_name = "kft-pipeline-api"

    def __init__(
        self,
        runner: PipelineRunner,
        *,
        scheduler: RunScheduler | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_parallel_runs: int = 4,
    ):
        super().__init__(host=host, port=port)
        self.runner = runner
        self._owns_scheduler = scheduler is None
        self.scheduler = scheduler or RunScheduler(runner).start()
        self._pipelines: dict[str, PipelineIR] = {}
        self._runs: dict[str, _RunRecord] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_parallel_runs, thread_name_prefix="kft-api-run"
        )

    # -- pipeline registry -------------------------------------------------- #

    def upload(self, ir: PipelineIR) -> None:
        ir.topological_order()  # reject cyclic/broken specs at upload
        with self._lock:
            self._pipelines[ir.name] = ir

    def _get_pipeline(self, name: str) -> PipelineIR:
        with self._lock:
            if name not in self._pipelines:
                raise KeyError(f"pipeline {name!r} not uploaded")
            return self._pipelines[name]

    def _resolve_spec(self, body: dict) -> PipelineIR:
        """A run/recurring request names an uploaded pipeline OR inlines a
        spec (the `kft pipeline run -f` one-shot path)."""
        if "spec" in body:
            ir = PipelineIR.from_dict(body["spec"])
            # same fail-fast-at-submit contract as upload: a cyclic inline
            # spec must 400 here, not FAIL asynchronously in the run thread
            ir.topological_order()
            return ir
        if "pipeline" not in body:
            raise ValueError("request needs 'pipeline' (name) or 'spec'")
        return self._get_pipeline(body["pipeline"])

    # -- runs ---------------------------------------------------------------- #

    def create_run(self, ir: PipelineIR, parameters: dict[str, Any]) -> str:
        resolve_parameters(ir, parameters)  # fail fast at submit time
        rid = uuid.uuid4().hex[:12]
        rec = _RunRecord(
            run_id=rid, pipeline=ir.name, parameters=parameters,
            dag=[
                {
                    "name": t.name,
                    "component": t.component,
                    "deps": sorted(t.deps()),
                }
                for t in ir.tasks
            ],
        )
        with self._lock:
            self._runs[rid] = rec

        def work() -> None:
            rec.state = RUNNING
            try:
                res = self.runner.run(
                    ir, parameters, run_id=rid, live_tasks=rec.tasks
                )
                rec.result = res
                rec.state = res.state
            except Exception as e:  # noqa: BLE001 — surfaced via GET /runs
                rec.state = FAILED
                rec.error = f"{type(e).__name__}: {e}"

        self._pool.submit(work)
        return rid

    def get_run(self, run_id: str) -> _RunRecord:
        with self._lock:
            if run_id not in self._runs:
                raise KeyError(f"run {run_id!r} not found")
            return self._runs[run_id]

    def run_dag(self, run_id: str) -> dict:
        """DAG structure + live task states — the dashboard's pipeline
        graph view (SURVEY.md §2.4 frontend row)."""
        rec = self.get_run(run_id)
        return {
            "run_id": rec.run_id,
            "pipeline": rec.pipeline,
            "state": rec.state,
            "tasks": [
                {
                    **node,
                    "state": (
                        rec.tasks[node["name"]].state
                        if node["name"] in rec.tasks else "PENDING"
                    ),
                    "cache_hit": (
                        rec.tasks[node["name"]].cache_hit
                        if node["name"] in rec.tasks else False
                    ),
                }
                for node in rec.dag
            ],
        }

    # -- HTTP surface -------------------------------------------------------- #

    def _routes(self):
        def fail(status: int, msg: str):
            return status, {"error": msg}

        def guard(fn):
            """JSON handler with the API's error contract: KeyError → 404,
            ValueError/TypeError (bad spec/params) → 400."""

            def h(request):
                try:
                    return 200, fn(request)
                except KeyError as e:
                    return fail(404, str(e))
                except (ValueError, TypeError) as e:
                    return fail(400, f"{type(e).__name__}: {e}")

            return h

        def upload_pipeline(request):
            body = request.json()
            spec = body.get("spec", body)  # bare IR JSON accepted too
            ir = PipelineIR.from_dict(spec)
            self.upload(ir)
            return {
                "name": ir.name,
                "parameters": [list(p) for p in ir.parameters],
                "tasks": len(ir.tasks),
            }

        def list_pipelines(_request):
            with self._lock:
                items = list(self._pipelines.values())
            return {
                "pipelines": [
                    {
                        "name": ir.name,
                        "description": ir.description,
                        "parameters": [list(p) for p in ir.parameters],
                        "tasks": len(ir.tasks),
                    }
                    for ir in items
                ]
            }

        def get_pipeline(request):
            ir = self._get_pipeline(request.match_info["name"])
            return {"name": ir.name, "spec": ir.to_dict()}

        def delete_pipeline(request):
            name = request.match_info["name"]
            with self._lock:
                if name not in self._pipelines:
                    raise KeyError(f"pipeline {name!r} not uploaded")
                del self._pipelines[name]
            return {"deleted": name}

        def create_run(request):
            body = request.json()
            ir = self._resolve_spec(body)
            rid = self.create_run(ir, dict(body.get("parameters") or {}))
            return {"run_id": rid, "pipeline": ir.name, "state": PENDING}

        def list_runs(_request):
            with self._lock:
                recs = list(self._runs.values())
            recs.sort(key=lambda r: r.created_at, reverse=True)
            return {"runs": [r.to_dict(detail=False) for r in recs]}

        def get_run(request):
            return self.get_run(request.match_info["run_id"]).to_dict()

        def get_run_dag(request):
            return self.run_dag(request.match_info["run_id"])

        def create_recurring(request):
            body = request.json()
            ir = self._resolve_spec(body)
            params = dict(body.get("parameters") or {})
            resolve_parameters(ir, params)
            if "interval_s" not in body:
                raise ValueError("recurring run needs 'interval_s'")
            rr = RecurringRun(
                pipeline=ir,
                interval_s=float(body["interval_s"]),
                parameters=params,
                max_runs=body.get("max_runs"),
                name=body.get("name", ""),
            )
            uid = self.scheduler.add(rr)
            return {"uid": uid, "name": rr.name}

        def _rr_dict(rr: RecurringRun) -> dict:
            return {
                "uid": rr.uid,
                "name": rr.name,
                "pipeline": rr.pipeline.name,
                "interval_s": rr.interval_s,
                "paused": rr.paused,
                "fired": rr.fired,
                "max_runs": rr.max_runs,
                "history": [
                    {"run_id": h.run_id, "state": h.state,
                     "wall_s": round(h.wall_s, 4)}
                    for h in rr.history
                ],
            }

        def list_recurring(_request):
            return {
                "recurring_runs": [
                    _rr_dict(rr) for rr in self.scheduler.list()
                ]
            }

        def get_recurring(request):
            return _rr_dict(self.scheduler.get(request.match_info["uid"]))

        def pause_recurring(request):
            self.scheduler.pause(request.match_info["uid"])
            return {"paused": True}

        def resume_recurring(request):
            self.scheduler.resume(request.match_info["uid"])
            return {"paused": False}

        def delete_recurring(request):
            uid = request.match_info["uid"]
            self.scheduler.get(uid)  # 404 if unknown
            self.scheduler.remove(uid)
            return {"deleted": uid}

        def healthz(_request):
            return 200, {"ok": True}

        pfx = "/apis/v2beta1"
        return [
            ("GET", "/healthz", healthz),
            ("POST", f"{pfx}/pipelines", guard(upload_pipeline)),
            ("GET", f"{pfx}/pipelines", guard(list_pipelines)),
            ("GET", f"{pfx}/pipelines/{{name}}", guard(get_pipeline)),
            ("DELETE", f"{pfx}/pipelines/{{name}}", guard(delete_pipeline)),
            ("POST", f"{pfx}/runs", guard(create_run)),
            ("GET", f"{pfx}/runs", guard(list_runs)),
            ("GET", f"{pfx}/runs/{{run_id}}", guard(get_run)),
            ("GET", f"{pfx}/runs/{{run_id}}/dag", guard(get_run_dag)),
            ("POST", f"{pfx}/recurringruns", guard(create_recurring)),
            ("GET", f"{pfx}/recurringruns", guard(list_recurring)),
            ("GET", f"{pfx}/recurringruns/{{uid}}", guard(get_recurring)),
            ("POST", f"{pfx}/recurringruns/{{uid}}:pause",
             guard(pause_recurring)),
            ("POST", f"{pfx}/recurringruns/{{uid}}:resume",
             guard(resume_recurring)),
            ("DELETE", f"{pfx}/recurringruns/{{uid}}",
             guard(delete_recurring)),
        ]

    def stop(self) -> None:
        super().stop()
        if self._owns_scheduler:
            self.scheduler.shutdown()
        self._pool.shutdown(wait=False)
