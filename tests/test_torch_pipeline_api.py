"""The port's pipelines REST API against the JAX package's.

The same request sequences go to the JAX ``PipelineAPIServer`` (aiohttp,
on its own loop thread) and to the port's (the standard library's
``http.server``, ``obs/webhost.py``), each in front of its own package's
runner: upload, run and watch end to end; the error contract; recurring
runs over HTTP; an inline spec run. Every answer's status code and JSON
body must be equal, with run ids, recurring-run uids, times and store
paths taken out. A run is read until it is terminal (deadline 60 s), so
only terminal states are compared.

``tests/test_pipeline_api.py``'s three ``kft pipeline`` CLI cases wait
for the port's CLI (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request

import pytest

from test_torch_pipelines import PKGS, WAIT_S, bind
from kubeflow_tpu.pipelines import Dataset, Input, Output

#: fields whose values differ by run and are left out of a comparison
VOLATILE = ("run_id", "uid", "created_at", "wall_s")


def produce(n: int, out: Output[Dataset]) -> None:
    with open(out.path, "w") as f:
        f.write(",".join(str(i) for i in range(n)))


def consume(data: Input[Dataset], scale: int) -> int:
    with open(data.path) as f:
        return scale * sum(int(x) for x in f.read().split(","))


def boom() -> int:
    raise RuntimeError("kaboom")


def _specs(pkg) -> dict:
    """``api-pipeline`` and ``boom-pipeline`` compiled by ``pkg``'s DSL."""
    p, c, b = (pkg.component(bind(f, pkg)) for f in (produce, consume, boom))

    @pkg.pipeline(name="api-pipeline", description="produce → consume")
    def api_pipeline(n: int = 4, scale: int = 1):
        d = p(n=n)
        c(data=d.output, scale=scale)

    @pkg.pipeline(name="boom-pipeline")
    def boom_pipeline():
        b()

    return {ir.name: ir.to_dict() for ir in
            map(pkg.compile_pipeline, (api_pipeline, boom_pipeline))}


def _scrub(x):
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    if isinstance(x, str):  # a run id or a uid in a value or a message
        return re.sub(r"\b(?:[0-9a-f]{8}|[0-9a-f]{12})\b", "<id>", x)
    return x


class Client:
    """Sends requests to one server and keeps every answer, scrubbed."""

    def __init__(self, base: str):
        self.base = base
        self.log: list = []

    def __call__(self, method: str, path: str, body: dict | None = None) -> dict:
        req = urllib.request.Request(
            self.base + path,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, out = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            status, out = e.code, json.loads(e.read())
        self.log.append((method, re.sub(r"/[0-9a-f]{8,12}(?=[/:]|$)", "/<id>", path),
                         status, _scrub(out)))
        return out

    def wait_terminal(self, rid: str) -> dict:
        deadline = time.monotonic() + WAIT_S
        while True:
            req = urllib.request.urlopen(f"{self.base}/apis/v2beta1/runs/{rid}",
                                         timeout=30)
            rec = json.loads(req.read())
            if rec["state"] not in ("PENDING", "RUNNING"):
                return self("GET", f"/apis/v2beta1/runs/{rid}")
            assert time.monotonic() < deadline, rec
            time.sleep(0.05)

    def wait_fired(self, uid: str, n: int) -> dict:
        deadline = time.monotonic() + WAIT_S
        while True:
            req = urllib.request.urlopen(
                f"{self.base}/apis/v2beta1/recurringruns/{uid}", timeout=30)
            got = json.loads(req.read())
            if got["fired"] >= n and len(got["history"]) >= n:
                return self("GET", f"/apis/v2beta1/recurringruns/{uid}")
            assert time.monotonic() < deadline, got
            time.sleep(0.05)


@pytest.fixture()
def servers(tmp_path):
    """A server of each package over its own runner: key → (server,
    lineage store, specs)."""
    out = {}
    for key, pkg in PKGS.items():
        root = tmp_path / key
        lineage = pkg.LineageStore(str(root / "mlmd.db"))
        runner = pkg.PipelineRunner(
            artifact_store=pkg.ArtifactStore(str(root / "artifacts")),
            cache=pkg.StepCache(str(root / "cache")), lineage=lineage)
        out[key] = (pkg.PipelineAPIServer(runner).start(), lineage, _specs(pkg))
    yield out
    for server, _, _ in out.values():
        server.stop()


def upload_run_watch(api: Client, specs, lineage):
    api("GET", "/healthz")
    api("POST", "/apis/v2beta1/pipelines", {"spec": specs["api-pipeline"]})
    api("GET", "/apis/v2beta1/pipelines")
    api("GET", "/apis/v2beta1/pipelines/api-pipeline")
    run = api("POST", "/apis/v2beta1/runs",
              {"pipeline": "api-pipeline", "parameters": {"n": 3, "scale": 10}})
    rec = api.wait_terminal(run["run_id"])
    api("GET", "/apis/v2beta1/runs")
    api("GET", f"/apis/v2beta1/runs/{run['run_id']}/dag")
    rollup = {r["run_id"]: r for r in lineage.runs()}[run["run_id"]]
    api.log.append(("lineage", _scrub({k: v for k, v in rollup.items()
                                        if k not in ("started", "finished")})))
    api("POST", "/apis/v2beta1/pipelines", {"spec": specs["boom-pipeline"]})
    run2 = api("POST", "/apis/v2beta1/runs", {"pipeline": "boom-pipeline"})
    rec2 = api.wait_terminal(run2["run_id"])
    api("DELETE", "/apis/v2beta1/pipelines/api-pipeline")
    api("GET", "/apis/v2beta1/pipelines/api-pipeline")
    return rec, rec2


def error_contract(api: Client, specs, _lineage):
    api("POST", "/apis/v2beta1/runs", {"pipeline": "nope"})
    api("POST", "/apis/v2beta1/pipelines", {"spec": specs["api-pipeline"]})
    api("POST", "/apis/v2beta1/runs",
        {"pipeline": "api-pipeline", "parameters": {"bogus": 1}})
    api("GET", "/apis/v2beta1/runs/deadbeef")
    api("GET", "/apis/v2beta1/runs/deadbeef/dag")
    bad = json.loads(json.dumps(specs["api-pipeline"]))
    bad["tasks"][0]["after"] = [bad["tasks"][1]["name"]]
    bad["tasks"][1]["after"] = [bad["tasks"][0]["name"]]
    api("POST", "/apis/v2beta1/pipelines", {"spec": bad})
    api("POST", "/apis/v2beta1/runs", {"spec": bad})
    api("POST", "/apis/v2beta1/recurringruns", {"spec": bad, "interval_s": 1})
    api("POST", "/apis/v2beta1/runs", {"parameters": {}})
    api("POST", "/apis/v2beta1/recurringruns", {"spec": specs["api-pipeline"]})
    run = api("POST", "/apis/v2beta1/runs", {"pipeline": "api-pipeline",
                                             "parameters": {"n": None}})
    api("DELETE", "/apis/v2beta1/pipelines/nope")
    api("GET", "/apis/v2beta1/recurringruns/nope")
    api("POST", "/apis/v2beta1/recurringruns/nope:pause")
    api("DELETE", "/apis/v2beta1/recurringruns/nope")
    return api.wait_terminal(run["run_id"]), None


def recurring_crud(api: Client, specs, _lineage):
    rr = api("POST", "/apis/v2beta1/recurringruns",
             {"spec": specs["api-pipeline"], "interval_s": 0.1, "max_runs": 2,
              "parameters": {"n": 2}})
    uid = rr["uid"]
    got = api.wait_fired(uid, 2)
    api("POST", f"/apis/v2beta1/recurringruns/{uid}:pause")
    api("GET", f"/apis/v2beta1/recurringruns/{uid}")
    api("POST", f"/apis/v2beta1/recurringruns/{uid}:resume")
    api("GET", f"/apis/v2beta1/recurringruns/{uid}")
    api("GET", "/apis/v2beta1/recurringruns")
    api("DELETE", f"/apis/v2beta1/recurringruns/{uid}")
    api("GET", f"/apis/v2beta1/recurringruns/{uid}")
    return got, None


def inline_spec_run(api: Client, specs, _lineage):
    run = api("POST", "/apis/v2beta1/runs",
              {"spec": specs["api-pipeline"], "parameters": {"n": 2}})
    rec = api.wait_terminal(run["run_id"])
    api("GET", "/apis/v2beta1/pipelines")
    return rec, None


@pytest.mark.parametrize("scenario", [upload_run_watch, error_contract,
                                      recurring_crud, inline_spec_run],
                         ids=lambda f: f.__name__)
def test_same_answers_as_jax_server(scenario, servers):
    logs, results = {}, {}
    for key, (server, lineage, specs) in servers.items():
        api = Client(server.url)
        results[key] = scenario(api, specs, lineage)
        logs[key] = api.log
    assert logs["torch"] == logs["jax"]
    first, second = results["torch"]
    if scenario is upload_run_watch:
        assert first["state"] == "SUCCEEDED" and first["parameters"] == {"n": 3, "scale": 10}
        assert first["tasks"]["consume"]["state"] == "SUCCEEDED"
        assert second["state"] == "FAILED"
        assert "kaboom" in second["tasks"]["boom"]["error"]
    if scenario is error_contract:
        codes = [entry[2] for entry in logs["torch"]]
        assert codes == [404, 200, 404, 404, 404, 400, 400, 400, 400, 400, 200,
                         404, 404, 404, 404, 200]
        assert first["state"] == "FAILED"
    if scenario is recurring_crud:
        assert first["fired"] == 2
        assert [h["state"] for h in first["history"]] == ["SUCCEEDED"] * 2
        assert logs["torch"][-1][2] == 404
    if scenario is inline_spec_run:
        assert first["state"] == "SUCCEEDED"


def test_route_misses_and_bind_errors():
    """The port's own edges of the stdlib host: a path no route matches
    answers 404 and a method no route of a path takes 405, both JSON;
    a port in use fails ``start()`` and a retry on a free port starts."""
    import socket

    from kubeflow_tpu_torch.obs.webhost import ThreadedHTTPServer

    class Echo(ThreadedHTTPServer):
        def _routes(self):
            return [("GET", "/items/{name}",
                     lambda r: (200, {"name": r.match_info["name"]}))]

    with Echo() as server:
        api = Client(server.url)
        assert api("GET", "/items/a%20b") == {"name": "a b"}
        api("GET", "/nothing")
        api("DELETE", "/items/x")
        assert [e[2] for e in api.log] == [200, 404, 405]
        taken = Echo(port=server.port)
        with pytest.raises(RuntimeError, match="failed to start"):
            taken.start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    taken.port = free
    with taken:
        assert Client(taken.url)("GET", "/items/y") == {"name": "y"}
