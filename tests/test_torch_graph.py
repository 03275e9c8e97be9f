"""The port's InferenceGraph (``serve/graph.py``) and request logger
(``serve/logger.py``) against the JAX package's.

Conditions and graph manifests are parsed by both packages and must agree
on every outcome and error. A graph runs its steps on a JAX ``DataPlane``
and on the port's ``ModelServer`` (its ``has``/``infer`` surface) over the
same models, Splitter draws from the same seeded ``random.Random``; then
the same request sequence goes to a JAX aiohttp server and to the port's
stdlib one, and statuses and bodies must be equal. The logger cases are
the logger half of ``test_serve.py``'s server case and of
``test_trace.py``'s log-correlation case.
"""

from __future__ import annotations

import asyncio
import json
import threading

import pytest

from kubeflow_tpu.obs import trace as jtrace
from kubeflow_tpu.serve import graph as jgraph
from kubeflow_tpu.serve.logger import RequestLogger as JLogger
from kubeflow_tpu.serve.model import Model as JModel
from kubeflow_tpu.serve.server import DataPlane
from kubeflow_tpu_torch.obs import trace as ttrace
from kubeflow_tpu_torch.serve import graph as tgraph
from kubeflow_tpu_torch.serve.logger import RequestLogger
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer
from test_torch_bert_serve import _call, _JaxReplica

# ------------------------------------------------------------- conditions

#: (expression, payload): each parsed and applied by both packages
CONDITIONS = [
    ("instances.0.0 > 5", {"instances": [[9]]}),
    ("instances.0.0 > 5", {"instances": [[1]]}),
    ('label == "cat"', {"label": "cat"}),
    ("tags contains 3", {"tags": [1, 3]}),
    ("meta.flag", {"meta": {"flag": True}}),
    ("meta.flag", {}),
    ("a.b > 1", {"a": {"b": "str"}}),
    ('label != "a==b"', {"label": "x"}),
    ('label != "a==b"', {"label": "a==b"}),
    ('tag contains "a<b"', {"tag": ["a<b"]}),
    ("x >= 2", {"x": 2}),
    ("x <= 2", {"x": 3}),
    ("x < 2", {"x": None}),
    ("name == bare", {"name": "bare"}),
    ("list.5 == 1", {"list": [1]}),
    ("instances.0.0 = 5", {}),
    ("tags contains3", {}),
    ("", {}),
    ("a b == 1", {}),
    ("== 1", {}),
]


def _outcome(parse, expr, payload):
    try:
        cond = parse(expr)
    except ValueError as e:
        return ("error", str(e))
    return ("value", cond(payload))


@pytest.mark.parametrize("expr,payload", CONDITIONS,
                         ids=[f"c{i}" for i in range(len(CONDITIONS))])
def test_parse_condition_matches_jax(expr, payload):
    got = _outcome(tgraph.parse_condition, expr, payload)
    assert got == _outcome(jgraph.parse_condition, expr, payload)


# ------------------------------------------------------------- manifests

GRAPH_DOC = {
    "apiVersion": "serving.kserve.io/v1alpha1",
    "kind": "InferenceGraph",
    "metadata": {"name": "router"},
    "spec": {"nodes": {
        "root": {"routerType": "Switch", "steps": [
            {"serviceName": "big", "condition": "instances.0.0 > 5"},
            {"nodeName": "fanout", "name": "rest"}]},
        "fanout": {"routerType": "Ensemble", "steps": [
            {"serviceName": "a"}, {"serviceName": "b", "weight": "2"}]},
    }},
}


def _nodes(**nodes):
    return {**GRAPH_DOC, "spec": {"nodes": nodes}}


GRAPH_DOCS = {
    "ok": GRAPH_DOC,
    "no_root": _nodes(other=GRAPH_DOC["spec"]["nodes"]["fanout"]),
    "cycle": _nodes(root={"routerType": "Sequence", "steps": [{"nodeName": "root"}]}),
    "cycle_two": _nodes(
        root={"routerType": "Sequence", "steps": [{"nodeName": "b"}]},
        b={"routerType": "Sequence", "steps": [{"nodeName": "root"}]}),
    "both_targets": _nodes(root={"routerType": "Sequence", "steps": [
        {"serviceName": "x", "nodeName": "root"}]}),
    "no_target": _nodes(root={"routerType": "Sequence", "steps": [{"name": "s"}]}),
    "duplicate_names": _nodes(root={"routerType": "Ensemble", "steps": [
        {"serviceName": "a", "name": "out"}, {"serviceName": "b", "name": "out"}]}),
    "bad_kind": _nodes(root={"routerType": "Broadcast", "steps": [{"serviceName": "a"}]}),
    "no_steps": _nodes(root={"routerType": "Sequence", "steps": []}),
    "unknown_node": _nodes(root={"routerType": "Sequence", "steps": [{"nodeName": "zz"}]}),
    "zero_weight": _nodes(root={"routerType": "Splitter", "steps": [
        {"serviceName": "a", "weight": 0}]}),
    "bad_condition": _nodes(root={"routerType": "Switch", "steps": [
        {"serviceName": "a", "condition": "x = 1"}]}),
    "no_name": {"spec": GRAPH_DOC["spec"], "metadata": {"name": ""}},
    "default_kind": _nodes(root={"steps": [{"serviceName": "a"}]}),
}


def _graph_view(g):
    return {"name": g.name, "namespace": g.namespace, "root": g.root,
            "services": sorted(g.services()),
            "nodes": {n: (v.kind, [(s.name, s.service, s.node, s.weight, s.condition)
                                   for s in v.steps]) for n, v in g.nodes.items()}}


@pytest.mark.parametrize("name", sorted(GRAPH_DOCS))
def test_graph_spec_from_manifest_matches_jax(name):
    """Mirrors ``test_serve.py``'s graph-manifest case: the same views,
    and the same admission errors word for word."""
    doc = GRAPH_DOCS[name]

    def parse(mod):
        try:
            return ("spec", _graph_view(mod.GraphSpec.from_manifest(doc)))
        except ValueError as e:
            return ("error", str(e))

    got = parse(tgraph)
    assert got == parse(jgraph)
    assert (got[0] == "spec") == (name in ("ok", "default_kind"))


# ------------------------------------------------------------ the routing


class _JAdd(JModel):
    def __init__(self, name, k):
        super().__init__(name)
        self.k = k
        self.ready = True

    def load(self):
        self.ready = True
        return True

    async def __call__(self, payload, headers=None):
        return {"instances": [[v + self.k for v in row] for row in payload["instances"]]}


class _Add(Model):
    def __init__(self, name, k):
        super().__init__(name)
        self.k = k
        self.ready = True

    def __call__(self, payload, headers=None):
        return {"instances": [[v + self.k for v in row] for row in payload["instances"]]}


def _both_planes():
    dp = DataPlane()
    for name, k in (("a1", 1), ("a10", 10), ("a100", 100)):
        dp.register(_JAdd(name, k))
    server = ModelServer([_Add(n, k) for n, k in (("a1", 1), ("a10", 10), ("a100", 100))],
                         http_port=0)
    return dp, server


def _graphs(mod, plane):
    N, S = mod.Node, mod.Step
    return {
        "fanout": mod.InferenceGraph({
            "root": N("Sequence", [S("s1", model="a1"), S("s2", node="fanout")]),
            "fanout": N("Ensemble", [S("e1", model="a1"), S("e10", model="a10")]),
        }, plane),
        "switch": mod.InferenceGraph({"root": N("Switch", [
            S("big", model="a10", condition=lambda p: p["instances"][0][0] > 5),
            S("small", model="a1")])}, plane),
        "gated": mod.InferenceGraph({"root": N("Sequence", [
            S("s1", model="a1"),
            S("s2", model="a100", condition=mod.parse_condition("instances.0.0 > 3")),
            S("s3", model="a10")])}, plane),
        "splitter": mod.InferenceGraph({"root": N("Splitter", [
            S("w1", model="a1", weight=1), S("w9", model="a10", weight=9)])}, plane),
    }


def test_inference_graph_nodes_match_jax():
    """Mirrors ``test_serve.py``'s graph-node case: Sequence, Ensemble,
    Switch, a gated Sequence and a seeded Splitter give the JAX graph's
    outputs, draw for draw."""
    dp, server = _both_planes()
    jg, tg = _graphs(jgraph, dp), _graphs(tgraph, server)
    inputs = {"fanout": [[[0]], [[5]]], "switch": [[[9]], [[1]]],
              "gated": [[[0]], [[3]], [[7]]], "splitter": [[[0]]] * 200}

    async def jax_run():
        return {n: [await jg[n].infer({"instances": x}) for x in xs]
                for n, xs in inputs.items()}

    want = asyncio.run(jax_run())
    got = {n: [tg[n].infer({"instances": x}) for x in xs] for n, xs in inputs.items()}
    assert got == want
    assert got["fanout"][0] == {"e1": {"instances": [[2]]}, "e10": {"instances": [[11]]}}
    assert [o["instances"] for o in got["switch"]] == [[[19]], [[2]]]
    frac10 = sum(o["instances"][0][0] == 10 for o in got["splitter"]) / 200
    assert frac10 > 0.75
    with pytest.raises(ValueError, match="no branch matched"):
        tgraph.InferenceGraph({"root": tgraph.Node("Switch", [tgraph.Step(
            "x", model="a1", condition=lambda p: False)])}, server).infer(
                {"instances": [[0]]})
    with pytest.raises(ValueError, match="needs a 'root' node"):
        tgraph.InferenceGraph({}, server)


def test_ensemble_runs_its_branches_at_once():
    """An Ensemble's branches run concurrently (``asyncio.gather`` in the
    reference): each branch waits at one barrier that only both together
    pass, so a branch-after-branch run would break it."""
    barrier = threading.Barrier(2, timeout=30)

    class Meet(Model):
        def __init__(self, name):
            super().__init__(name)
            self.ready = True

        def __call__(self, payload, headers=None):
            barrier.wait()
            return {"from": self.name, "threads": threading.current_thread().name}

    server = ModelServer([Meet("l"), Meet("r")], http_port=0)
    g = tgraph.InferenceGraph({"root": tgraph.Node("Ensemble", [
        tgraph.Step("left", model="l"), tgraph.Step("right", model="r")])}, server)
    out = g.infer({"instances": [[0]]})
    assert [out["left"]["from"], out["right"]["from"]] == ["l", "r"]
    assert out["left"]["threads"] != out["right"]["threads"]
    assert server.metrics["requests_total"] == {"l": 1, "r": 1}


SERVED_DOC = {
    "kind": "InferenceGraph",
    "metadata": {"name": "router"},
    "spec": {"nodes": {
        "root": {"routerType": "Switch", "steps": [
            {"serviceName": "a100", "condition": "instances.0.0 >= 50"},
            {"nodeName": "fanout", "name": "small"},
            {"serviceName": "a1", "condition": "instances.0.0 < 0"}]},
        "fanout": {"routerType": "Ensemble", "steps": [
            {"serviceName": "a1", "name": "one"},
            {"serviceName": "a10", "name": "ten"}]},
    }},
}
STRICT_DOC = {"kind": "InferenceGraph", "metadata": {"name": "strict"},
              "spec": {"nodes": {"root": {"routerType": "Switch", "steps": [
                  {"serviceName": "a1", "condition": "instances.0.0 > 0"}]}}}}

#: (method, path, body): the same requests to the JAX and the port's server
GRAPH_REQUESTS = [
    ("GET", "/v1/graphs", None),
    ("POST", "/v1/graphs/router:infer", {"instances": [[60]]}),
    ("POST", "/v1/graphs/router:infer", {"instances": [[2]]}),
    ("POST", "/v1/graphs/strict:infer", {"instances": [[5]]}),
    ("POST", "/v1/graphs/strict:infer", {"instances": [[-5]]}),     # 400
    ("POST", "/v1/graphs/nope:infer", {}),                          # 404
    ("POST", "/v1/graphs/router:infer", b"{not json"),              # 400
]


def _served(port):
    out = []
    for method, path, body in GRAPH_REQUESTS:
        status, _, data = _call(port, method, path, body)
        doc = json.loads(data) if status == 200 else None
        out.append((status, doc))
    return out


def test_graph_served_over_rest_matches_jax():
    """Mirrors ``test_serve.py``'s REST graph case: a Switch + Ensemble
    manifest registered on both servers, the same requests, the same
    statuses and bodies; a graph naming a model the server lacks is
    refused at registration by both."""
    jspec_, tspec_ = (jgraph.GraphSpec.from_manifest(SERVED_DOC),
                      tgraph.GraphSpec.from_manifest(SERVED_DOC))
    jrep = _JaxReplica([_JAdd("a1", 1), _JAdd("a10", 10), _JAdd("a100", 100)])
    jrep.server.register_graph(jspec_)
    jrep.server.register_graph(jgraph.GraphSpec.from_manifest(STRICT_DOC))
    tsrv = ModelServer([_Add("a1", 1), _Add("a10", 10), _Add("a100", 100)],
                       http_port=0)
    tsrv.register_graph(tspec_)
    tsrv.register_graph(tgraph.GraphSpec.from_manifest(STRICT_DOC))
    tsrv.start()
    try:
        want, got = _served(jrep.port), _served(tsrv.port)
    finally:
        jrep.close()
        tsrv.stop()
    assert got == want
    assert [s for s, _ in got] == [200, 200, 200, 200, 400, 404, 400]
    assert got[0][1] == {"graphs": ["router", "strict"]}
    assert got[1][1]["instances"] == [[160]]
    assert got[2][1] == {"one": {"instances": [[3]]}, "ten": {"instances": [[12]]}}

    with pytest.raises(ValueError, match="not on") as te:
        ModelServer([_Add("a1", 1)], http_port=0).register_graph(tspec_)
    with pytest.raises(ValueError, match="not on") as je:
        from kubeflow_tpu.serve.server import ModelServer as JServer

        JServer([_JAdd("a1", 1)]).register_graph(jspec_)
    assert str(te.value) == str(je.value)


def test_graph_step_failure_statuses():
    """A model failing inside a graph: its ``ValueError`` is a 400, an
    unready model a 503, anything else a 500; the server keeps serving."""

    class Broken(Model):
        def __init__(self, name, exc):
            super().__init__(name)
            self.exc = exc
            self.ready = True

        def __call__(self, payload, headers=None):
            raise self.exc

    models = [Broken("bad", ValueError("no")), Broken("boom", RuntimeError("x")),
              _Add("a1", 1)]
    server = ModelServer(models, http_port=0)
    for name in ("bad", "boom", "a1"):
        server.register_graph(tgraph.GraphSpec.from_manifest(
            {"metadata": {"name": name}, "spec": {"nodes": {"root": {
                "steps": [{"serviceName": name}]}}}}))
    server.start()
    try:
        models[2].ready = False
        got = [_call(server.port, "POST", f"/v1/graphs/{n}:infer",
                     {"instances": [[1]]})[0] for n in ("bad", "boom", "a1")]
        models[2].ready = True
        ok = _call(server.port, "POST", "/v1/graphs/a1:infer", {"instances": [[1]]})
    finally:
        server.stop()
    assert got == [400, 500, 503]
    assert ok[0] == 200 and json.loads(ok[2]) == {"instances": [[2]]}


# ------------------------------------------------------------------ logger


class _JDoubler(JModel):
    def predict(self, inputs, headers=None):
        return {"predictions": [[2 * v for v in row] for row in inputs["instances"]]}


class _Doubler(Model):
    def predict(self, inputs, headers=None):
        return {"predictions": [[2 * v for v in row] for row in inputs["instances"]]}


LOGGED_REQUESTS = [
    ("POST", "/v1/models/dbl:predict", {"instances": [[1, 2], [3, 4]]},
     {"x-request-id": "req-1"}),
    ("POST", "/v2/models/dbl/infer", {"inputs": [
        {"name": "input_ids", "shape": [1, 2], "datatype": "INT32", "data": [5, 6]}]},
     {"x-request-id": "req-2"}),
    ("POST", "/v1/models/nope:predict", {"instances": []}, {}),
    ("POST", "/v1/models/dbl:predict", {"rows": []}, {}),
]


def _logged(port, logger):
    out = []
    for method, path, body, headers in LOGGED_REQUESTS:
        status, _, data = _call(port, method, path, body, headers)
        out.append((status, json.loads(data) if status == 200 else None))
    events = [(e["type"], e["requestid"], e["inferenceserviceid"], e["specversion"],
               e["source"], json.dumps(e["data"], default=lambda a: a.tolist(),
                                       sort_keys=True))
              for e in logger.entries]
    return out, events


def test_logger_records_each_inference_as_the_jax_server_does():
    """The logger half of ``test_serve.py``'s server case: a request and a
    response CloudEvent an inference, paired by ``x-request-id``, with the
    JAX server's types, sources and payloads."""
    jlog, tlog = JLogger(), RequestLogger()
    jrep = _JaxReplica([_JDoubler("dbl")], logger=jlog)
    tsrv = ModelServer([_Doubler("dbl")], http_port=0, logger=tlog).start()
    try:
        want, got = _logged(jrep.port, jlog), _logged(tsrv.port, tlog)
    finally:
        jrep.close()
        tsrv.stop()
    assert got == want
    kinds = [e[0] for e in got[1]]
    assert kinds == ["org.kubeflow.serving.inference.request",
                     "org.kubeflow.serving.inference.response"] * 2
    assert [e[1] for e in got[1]] == ["req-1", "req-1", "req-2", "req-2"]
    assert all(e["specversion"] == "1.0" and e["time"] > 0 for e in tlog.entries)
    assert len({e["id"] for e in tlog.entries}) == 4


def test_logger_events_carry_the_ambient_trace_ids(tmp_path):
    """``test_trace.py``'s log-correlation case on both packages, then over
    HTTP: a request with an ``x-kft-trace`` context logs both events under
    its trace id, and a JSONL sink takes numpy payloads."""
    import numpy as np

    for trace_mod, logger_cls in ((jtrace, JLogger), (ttrace, RequestLogger)):
        span = trace_mod.TRACER.span("dataplane")
        tok = trace_mod.set_current(span)
        try:
            lg = logger_cls()
            lg.log_request("m", "r1", {"x": 1})
            assert lg.entries[0]["trace_id"] == span.trace_id
            assert lg.entries[0]["span_id"] == span.span_id
        finally:
            trace_mod.reset_current(tok)
            span.end()
        lg = logger_cls()
        lg.log_response("m", "r1", {"x": 1})
        assert "trace_id" not in lg.entries[0] and "span_id" not in lg.entries[0]

    sink = tmp_path / "events.jsonl"
    tlog = RequestLogger(str(sink))
    old = ttrace.TRACER.sample_every
    ttrace.TRACER.sample_every = 1
    tsrv = ModelServer([_Doubler("dbl")], http_port=0, logger=tlog).start()
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    try:
        status = _call(tsrv.port, "POST", "/v1/models/dbl:predict",
                       {"instances": [[1]]},
                       {"x-kft-trace": f"00-{trace_id}-00f067aa0ba902b7-01"})[0]
        tlog.log_request("dbl", "np", {"a": np.arange(3)})
    finally:
        tsrv.stop()
        ttrace.TRACER.sample_every = old
        tlog.close()
    lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert status == 200 and len(lines) == 3
    assert [ln["trace_id"] for ln in lines[:2]] == [trace_id, trace_id]
    assert lines[0]["span_id"] == lines[1]["span_id"] != "00f067aa0ba902b7"
    assert lines[2]["data"] == {"a": [0, 1, 2]}


def test_logger_callable_sink_and_graph_steps():
    """A callable sink gets every event; each graph step is an inference
    of its model, logged as one."""
    seen = []
    server = ModelServer([_Add("a1", 1), _Add("a10", 10)], http_port=0,
                         logger=RequestLogger(seen.append))
    server.register_graph(tgraph.GraphSpec.from_manifest({
        "metadata": {"name": "g"}, "spec": {"nodes": {"root": {
            "routerType": "Sequence",
            "steps": [{"serviceName": "a1"}, {"serviceName": "a10"}]}}}}))
    server.start()
    try:
        status, _, data = _call(server.port, "POST", "/v1/graphs/g:infer",
                                {"instances": [[0]]})
    finally:
        server.stop()
    assert status == 200 and json.loads(data) == {"instances": [[11]]}
    assert [(e["inferenceserviceid"], e["type"].rsplit(".", 1)[1]) for e in seen] == [
        ("a1", "request"), ("a1", "response"), ("a10", "request"), ("a10", "response")]
    assert seen[3]["data"] == {"instances": [[11]]}
