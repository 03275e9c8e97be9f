"""The port's InferenceService control plane (``serve/spec.py``,
``serve/controller.py``, ``serve/composite.py``) against the JAX package's.

Each case applies one spec sequence to a JAX ``InferenceServiceController``
and to the port's and compares what they report: conditions, which
revision serves, replica counts, revision picks by request id, loads and
retirements. The autoscaler's series run under one injected clock (each
controller module's ``time`` and each ``KPARecommender``'s ``clock``
default are patched). The ModelMesh cases
run the JAX ``JAXModel`` and the port's ``TorchModel`` on CPU weights. The
end-to-end case serves a bert-tiny InferenceService from its manifest, an
HF-format directory behind ``storageUri``, through both controllers: the
port's side adds ``device: cpu`` to the predictor's ``extra`` (the port's
runtimes run on the card by default), the JAX side ``attn_impl:
reference`` (its tests' CPU attention).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

import kubeflow_tpu.autoscale.kpa as jkpa
import kubeflow_tpu_torch.autoscale.kpa as tkpa
import kubeflow_tpu.serve.controller as jctl
import kubeflow_tpu.serve.spec as jspec
from kubeflow_tpu.serve.composite import ComposedService as JComposed
from kubeflow_tpu.serve.model import EchoModel as JEcho
from kubeflow_tpu.serve.model import Model as JModel
from kubeflow_tpu.serve.modelmesh import ModelMesh as JMesh
from kubeflow_tpu.serve.runtimes import default_registry as jax_registry
from kubeflow_tpu_torch.gateway.router import canary_slot
import kubeflow_tpu_torch.serve.controller as tctl
import kubeflow_tpu_torch.serve.spec as tspec
from kubeflow_tpu_torch.serve.composite import ComposedService as TComposed
from kubeflow_tpu_torch.serve.model import Model as TModel
from kubeflow_tpu_torch.serve.modelmesh import ModelMesh as TMesh
from kubeflow_tpu_torch.serve.runtimes import default_registry as torch_registry
from kubeflow_tpu_torch.serve.server import ModelServer
from test_modelmesh import PER_MODEL, _jax_model
from test_torch_bert import VOCAB, _hf_state, write_hf_dir
from test_torch_bert_serve import _call, _JaxReplica
from test_torch_modelmesh import _torch_model

ROOT = Path(__file__).resolve().parents[1]


class EchoModel(TModel):
    """The JAX ``EchoModel`` for the port's ``Model``."""

    def predict(self, inputs, headers=None):
        return inputs


TEcho = EchoModel


SIDES = {
    "jax": SimpleNamespace(ctl=jctl, spec=jspec, echo=JEcho, model=JModel,
                           composed=JComposed, mesh=JMesh, toy=_jax_model, kpa=jkpa),
    "torch": SimpleNamespace(ctl=tctl, spec=tspec, echo=TEcho, model=TModel,
                             composed=TComposed, mesh=TMesh, toy=_torch_model,
                             kpa=tkpa),
}


def _echo_registry(side, log=None):
    """An ``echo`` runtime whose factory records ``(name, version)``."""
    S = SIDES[side]
    reg = S.spec.RuntimeRegistry()

    def factory(name, path, version=0, **kw):
        if log is not None:
            log.append((name, version))
        return S.echo(f"{name}-v{version}")

    reg.register(S.spec.ServingRuntime("echo", ("echo",), factory))
    return reg


def _controller(side, reg, monkeypatch=None, clock=None, **kw):
    """A controller of ``side``; with ``clock``, every stamp and window of
    it reads that clock."""
    S = SIDES[side]
    if clock is not None:
        monkeypatch.setattr(S.ctl, "time", SimpleNamespace(monotonic=clock))
        monkeypatch.setitem(S.kpa.KPARecommender.__init__.__kwdefaults__,
                            "clock", clock)
    return S.ctl.InferenceServiceController(reg, **kw)


def _spec(side, name="svc", *, transformer=None, explainer=None, **pred):
    S = SIDES[side].spec
    pred.setdefault("model_format", "echo")
    return S.InferenceServiceSpec(
        name, S.PredictorSpec(**pred),
        transformer=None if transformer is None else S.ComponentSpec(**transformer),
        explainer=None if explainer is None else S.ComponentSpec(**explainer))


def _describe(m):
    if m is None:
        return None
    if hasattr(m, "components"):
        return (type(m).__name__, m.name, [(c.name, c.ready) for c in m.components])
    return (type(m).__name__, m.name, m.ready)


def _state(st):
    rs = st.replicas
    return {"conditions": list(st.conditions), "ready": st.ready,
            "default": _describe(st.default_model),
            "canary": _describe(st.canary_model),
            "pct": st.spec.predictor.canary_traffic_percent,
            "replicas": (rs.ready_replicas, rs.desired_replicas, rs.cold_starts)}


# ------------------------------------------------------------------- spec


def test_spec_validate_and_runtime_resolution_match_jax():
    for side in SIDES:
        S = SIDES[side].spec
        _spec(side).validate()
        bad = [dict(min_replicas=2, max_replicas=1), dict(min_replicas=-1),
               dict(canary_traffic_percent=101), dict(model_format=None)]
        for kw in bad:
            with pytest.raises(ValueError) as e:
                _spec(side, **kw).validate()
            with pytest.raises(ValueError) as je:
                _spec("jax", **kw).validate()
            assert str(e.value) == str(je.value)
        with pytest.raises(ValueError, match="needs a name"):
            _spec(side, name="").validate()
        reg = _echo_registry(side)
        assert reg.resolve(S.ComponentSpec(model_format="echo")).name == "echo"
        with pytest.raises(ValueError, match="no runtime supports"):
            reg.resolve(S.ComponentSpec(model_format="onnx"))
        with pytest.raises(ValueError, match="unknown runtime"):
            reg.resolve(S.ComponentSpec(runtime="nope"))


def _fields(spec):
    """A spec as plain data (each package's classes differ)."""
    def comp(c):
        if c is None:
            return None
        return {k: (dict(v) if k == "extra" else v)
                for k, v in vars(c).items() if k != "mesh"}

    return {"name": spec.name, "namespace": spec.namespace,
            "predictor": comp(spec.predictor),
            "transformer": comp(spec.transformer),
            "explainer": comp(spec.explainer)}


MANIFESTS = {
    "canary_and_components": {
        "kind": "InferenceService",
        "metadata": {"name": "m", "namespace": "team"},
        "spec": {
            "predictor": {"minReplicas": 0, "maxReplicas": "3", "scaleTarget": 2,
                          "canaryTrafficPercent": "25",
                          "model": {"modelFormat": {"name": "bert"},
                                    "storageUri": "file:///x", "runtime": "r",
                                    "extra": {"dtype": "bfloat16"}}},
            "transformer": {"model": {"modelFormat": "echo"}},
            "explainer": {"modelFormat": {"name": "sklearn"}, "minReplicas": 2},
        }},
    "defaults": {"metadata": {"name": "d"},
                 "spec": {"predictor": {"model": {"modelFormat": {"name": "x"}}}}},
    "min_only": {"metadata": {"name": "d"},
                 "spec": {"predictor": {"minReplicas": 3,
                                        "model": {"modelFormat": {"name": "x"}}}}},
}

BAD_MANIFESTS = {
    "no_predictor": {"kind": "InferenceService", "metadata": {"name": "x"},
                     "spec": {}},
    "wrong_kind": {"kind": "InferenceGraph", "metadata": {"name": "x"}},
    "bad_bounds": {"metadata": {"name": "x"},
                   "spec": {"predictor": {"minReplicas": 3, "maxReplicas": 1,
                                          "model": {"modelFormat": "x"}}}},
    "bad_pct": {"metadata": {"name": "x"},
                "spec": {"predictor": {"canaryTrafficPercent": 120,
                                       "model": {"modelFormat": "x"}}}},
    "no_name": {"spec": {"predictor": {"model": {"modelFormat": "x"}}}},
    "no_format": {"metadata": {"name": "x"},
                  "spec": {"predictor": {"model": {"storageUri": "file:///x"}}}},
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_from_manifest_matches_jax(name):
    doc = MANIFESTS[name]
    got = tspec.InferenceServiceSpec.from_manifest(doc)
    want = jspec.InferenceServiceSpec.from_manifest(doc)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("name", sorted(BAD_MANIFESTS))
def test_from_manifest_rejects_as_jax_does(name):
    doc = BAD_MANIFESTS[name]
    with pytest.raises(ValueError) as je:
        jspec.InferenceServiceSpec.from_manifest(doc)
    with pytest.raises(ValueError) as te:
        tspec.InferenceServiceSpec.from_manifest(doc)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["bert_isvc.yaml", "llm_isvc.yaml"])
def test_manifest_copies_are_byte_equal_and_parse_as_jax(name):
    ours = ROOT / "kubeflow_tpu_torch" / "examples" / "manifests" / name
    theirs = ROOT / "kubeflow_tpu" / "examples" / "manifests" / name
    assert ours.read_bytes() == theirs.read_bytes()
    doc = yaml.safe_load(ours.read_text())
    assert _fields(tspec.InferenceServiceSpec.from_manifest(doc)) == _fields(
        jspec.InferenceServiceSpec.from_manifest(doc))


def test_chip_smoke_manifest_is_the_port_copy():
    """``chip_smoke.py`` (whose host has no PyYAML) carries the kserve-bert
    manifest as a literal; it must be the shipped YAML, and its phase
    rewrites only ``storageUri``."""
    import chip_smoke

    doc = yaml.safe_load(
        (ROOT / "kubeflow_tpu_torch/examples/manifests/bert_isvc.yaml").read_text())
    assert chip_smoke.BERT_ISVC_MANIFEST == doc
    got = chip_smoke.isvc_manifest("file:///tmp/w")
    doc["spec"]["predictor"]["model"]["storageUri"] = "file:///tmp/w"
    assert got == doc
    assert chip_smoke.BERT_ISVC_MANIFEST != got  # a copy, not the constant


def test_component_mesh_field():
    from kubeflow_tpu_torch.core.mesh import MeshSpec

    c = tspec.ComponentSpec(model_format="x", mesh=MeshSpec(model=2))
    assert c.mesh.model == 2 and tspec.ComponentSpec().mesh is None


# ------------------------------------------------------------- controller

#: (verb, arguments): one rollout history, applied to both controllers
SEQUENCE = [
    ("apply", dict(extra={"version": 1})),
    ("apply", dict(extra={"version": 1})),                      # no change
    ("apply", dict(extra={"version": 2}, canary_traffic_percent=30)),
    ("apply", dict(extra={"version": 2}, canary_traffic_percent=30)),
    ("apply", dict(extra={"version": 3}, canary_traffic_percent=30)),
    ("promote", None),
    ("promote", None),                                          # no canary
    ("apply", dict(extra={"version": 3})),
    ("apply", dict(extra={"version": 4})),                      # plain rollout
    ("apply", dict(extra={"version": 4}, min_replicas=0, max_replicas=3)),
    ("apply", dict(extra={"version": 5}, canary_traffic_percent=0)),
    ("apply", dict(extra={"version": 5},
                   transformer=dict(model_format="echo", extra={"version": 9}))),
    ("apply", dict(extra={"version": 5},
                   transformer=dict(model_format="echo", extra={"version": 8}),
                   explainer=dict(model_format="echo"))),
    ("delete", None),
]


def _run_sequence(side):
    log = []
    ctl = _controller(side, _echo_registry(side, log))
    trail, seen = [], []
    for verb, kw in SEQUENCE:
        if verb == "apply":
            kw = dict(kw)
            st = ctl.apply(_spec(side, transformer=kw.pop("transformer", None),
                                 explainer=kw.pop("explainer", None), **kw))
        elif verb == "promote":
            ctl.promote_canary("svc")
            st = ctl.get("svc")
        else:
            ctl.delete("svc")
            trail.append(("deleted", [_describe(m) for m in seen]))
            continue
        for m in (st.default_model, st.canary_model):
            if m is not None and m not in seen:
                seen.append(m)
        trail.append(_state(st))
    return trail, log


def test_spec_sequence_gives_the_jax_conditions_revisions_and_loads():
    jtrail, jlog = _run_sequence("jax")
    ttrail, tlog = _run_sequence("torch")
    assert ttrail == jtrail
    assert tlog == jlog
    # the port's own reading of the trail: the canary served, was promoted
    # and the retired revisions unloaded
    assert ttrail[2]["canary"] == ("EchoModel", "svc-v2", True)
    assert ttrail[5]["default"][1] == "svc-v3" and ttrail[5]["pct"] == 100
    assert ttrail[-1][0] == "deleted"
    assert all(not ready for *_, ready in ttrail[-1][1] if isinstance(ready, bool))


def test_route_picks_match_jax_and_the_gateway_hash(monkeypatch):
    """Mirrors ``test_serve.py``'s canary case and ``test_gateway.py``'s
    request-id case: the same ids pick the same revisions in both
    controllers, each pick is ``canary_slot``'s, and the seeded fallback
    draws the same sequence."""
    picks = {}
    for side in SIDES:
        ctl = _controller(side, _echo_registry(side), canary_salt="edge")
        ctl.apply(_spec(side, extra={"version": 1}))
        ctl.apply(_spec(side, extra={"version": 2}, canary_traffic_percent=30))
        st = ctl.get("svc")
        by_id = [ctl.route("svc", request_id=f"r-{i}").name for i in range(1000)]
        again = [ctl.route("svc", request_id=f"r-{i}").name for i in range(1000)]
        assert by_id == again  # retry-stable
        seeded = [ctl.route("svc").name for _ in range(400)]
        picks[side] = (by_id, seeded, st.canary_model.name)
    assert picks["torch"] == picks["jax"]
    by_id, seeded, canary = picks["torch"]
    assert [p == canary for p in by_id] == [
        canary_slot(f"r-{i}", "edge") < 30 for i in range(1000)]
    assert 0.27 <= sum(p == canary for p in by_id) / 1000 <= 0.33
    assert 0.2 < sum(p == canary for p in seeded) / 400 < 0.4


def test_plain_rollout_reloads_model_as_jax_does():
    for side in SIDES:
        loads = []
        ctl = _controller(side, _echo_registry(side, loads))
        ctl.apply(_spec(side, "r", extra={"version": 1}))
        m1 = ctl.get("r").default_model
        ctl.apply(_spec(side, "r", extra={"version": 1}))
        assert ctl.get("r").default_model is m1 and loads == [("r", 1)]
        ctl.apply(_spec(side, "r", extra={"version": 2}))
        st = ctl.get("r")
        assert st.default_model is not m1 and not m1.ready
        assert loads == [("r", 1), ("r", 2)] and st.canary_model is None


def _tick_clock():
    t = [1000.0]
    return t, (lambda: t[0])


def test_scale_to_zero_and_cold_start_match_jax(monkeypatch):
    """Mirrors ``test_serve.py``'s scale-to-zero case under one clock."""
    out = {}
    for side in SIDES:
        t, clock = _tick_clock()
        ctl = _controller(side, _echo_registry(side), monkeypatch, clock,
                          idle_scale_to_zero_s=0.0)
        ctl.apply(_spec(side, "z", min_replicas=0, max_replicas=2))
        st = ctl.get("z")
        ctl.route("z")
        t[0] += 1.0
        zero = ctl.autoscale_tick("z")
        released = not st.default_model.ready
        t[0] += 1.0
        m = ctl.route("z")
        cold = (m.ready, st.replicas.cold_starts)
        st.spec.predictor.scale_target = 1
        st.replicas.in_flight = 5
        t[0] += 1.0
        out[side] = (zero, released, cold, ctl.autoscale_tick("z"))
    assert out["torch"] == out["jax"] == (0, True, (True, 1), 2)


#: (seconds since the last step, in-flight, a request routed?, re-apply?)
SERIES = ([(1, 0, True, False), (1, 8, True, False), (1, 8, False, False),
           (1, 0, False, True), (2, 0, False, False), (30, 0, False, False),
           (31, 0, False, False), (5, 1, True, False), (1, 3, True, False),
           (70, 0, False, False), (70, 0, False, False), (1, 12, True, False),
           (1, 2, False, True), (200, 0, False, False)])


def test_autoscale_tick_series_match_jax(monkeypatch):
    """Mirrors ``test_autoscale.py``'s controller tick (recommender, panic
    hold, a re-apply that keeps the scale), then a longer in-flight series
    to zero and back: the same replica counts in both controllers."""
    counts = {}
    for side in SIDES:
        t, clock = _tick_clock()
        ctl = _controller(side, _echo_registry(side), monkeypatch, clock,
                          idle_scale_to_zero_s=60.0)
        kw = dict(min_replicas=0, max_replicas=4, scale_target=2)
        ctl.apply(_spec(side, "s", **kw))
        trail = []
        for dt, inflight, routed, reapply in SERIES:
            t[0] += dt
            if reapply:
                ctl.apply(_spec(side, "s", **kw))
            st = ctl.get("s")
            if routed:
                ctl.route("s")
            st.replicas.in_flight = inflight
            n = ctl.autoscale_tick("s")
            trail.append((n, st.replicas.desired_replicas,
                          st.replicas.cold_starts, st.default_model.ready))
        counts[side] = trail
    assert counts["torch"] == counts["jax"]
    trail = counts["torch"]
    assert [n for n, *_ in trail[:3]] == [1, 2, 3]  # the stable window fills
    assert trail[3][0] == trail[2][0]  # the re-apply kept the scale
    assert trail[9] == (0, 0, 0, False)  # idle past the grace: weights gone
    assert trail[11][2:] == (1, True)  # the next request cold-started it


def test_tick_reapply_preserves_scale_as_in_jax(monkeypatch):
    """``test_autoscale.py``'s case as it stands, under one clock."""
    out = {}
    for side in SIDES:
        t, clock = _tick_clock()
        ctl = _controller(side, _echo_registry(side), monkeypatch, clock,
                          idle_scale_to_zero_s=60.0)
        kw = dict(min_replicas=1, max_replicas=4, scale_target=2)
        ctl.apply(_spec(side, "s", **kw))
        ctl.get("s").replicas.in_flight = 8
        first = ctl.autoscale_tick("s")
        ctl.apply(_spec(side, "s", **kw))
        kept = ctl.get("s").replicas.desired_replicas
        ctl.get("s").replicas.in_flight = 0
        t[0] += 1.0
        out[side] = (first, kept, ctl.autoscale_tick("s"))
    assert out["torch"] == out["jax"] == (4, 4, 4)


# ----------------------------------------------------------- composition


def test_transformer_component_brackets_predictor_as_in_jax():
    import asyncio

    outs = {}
    for side in SIDES:
        S = SIDES[side]

        class Upper(S.model):
            def preprocess(self, payload, headers=None):
                return {"instances": [s.upper() for s in payload["instances"]]}

            def postprocess(self, outputs, headers=None):
                return {"predictions": [f"<{p}>" for p in outputs["predictions"]]}

        class Echo(S.model):
            def predict(self, inputs, headers=None):
                return {"predictions": list(inputs["instances"])}

        svc = S.composed("svc", Echo("p"), transformer=Upper("t"))
        out = svc({"instances": ["a", "b"]})
        outs[side] = asyncio.run(out) if side == "jax" else out
        # the lifecycle form (the batcher's path) brackets the same way
        if side == "torch":
            flat = svc.postprocess(svc.predict(svc.preprocess({"instances": ["c"]})))
            assert flat == {"predictions": ["<C>"]}
            assert svc.components == [svc.transformer, svc.predictor]
    assert outs["torch"] == outs["jax"] == {"predictions": ["<A>", "<B>"]}


def test_explainer_component_and_v1_explain_endpoint_match_jax(tmp_path):
    """Mirrors ``test_serve.py``'s explainer case on the CPU: the same
    sklearn checkpoint as predictor and explainer through both controllers,
    served by both servers; attributions exact, bodies equal."""
    import joblib
    from sklearn.linear_model import LogisticRegression

    rng = np.random.RandomState(4)
    X = rng.randn(80, 3)
    y = (X @ [2.0, -1.0, 0.5] > 0).astype(int)
    clf = LogisticRegression().fit(X, y)
    src = tmp_path / "m"
    src.mkdir()
    joblib.dump(clf, src / "model.joblib")
    bodies = {}
    for side, reg, extra in (("jax", jax_registry(), {}),
                             ("torch", torch_registry(), {"device": "cpu"})):
        S = SIDES[side].spec
        ctl = SIDES[side].ctl.InferenceServiceController(
            reg, model_dir=str(tmp_path / f"dl-{side}"))
        st = ctl.apply(S.InferenceServiceSpec(
            name="sk",
            predictor=S.PredictorSpec(model_format="sklearn",
                                      storage_uri=f"file://{src}", extra=extra),
            explainer=S.ComponentSpec(model_format="sklearn",
                                      storage_uri=f"file://{src}", extra=extra)))
        assert st.ready and "PredictorReady" in st.conditions
        model = ctl.route("sk")
        if side == "jax":
            server = _JaxReplica([model])
            port = server.port
        else:
            server = ModelServer([model], http_port=0).start()
            port = server.port
        try:
            body = {"instances": [[1.0, 2.0, 3.0]]}
            got = []
            for path in ("/v1/models/sk:explain", "/v1/models/sk:predict"):
                status, _, data = _call(port, "POST", path, body)
                got.append((status, json.loads(data)))
            bodies[side] = got
        finally:
            if side == "jax":
                server.close()
            else:
                server.stop()
    assert [s for s, _ in bodies["torch"]] == [s for s, _ in bodies["jax"]] == [200, 200]
    exp = bodies["torch"][0][1]["explanations"][0]
    jexp = bodies["jax"][0][1]["explanations"][0]
    np.testing.assert_allclose(exp["contributions"], jexp["contributions"],
                               rtol=1e-6, atol=1e-9)
    total = sum(exp["contributions"]) + exp["intercept"][0]
    assert abs(total - float(clf.decision_function([[1.0, 2.0, 3.0]])[0])) < 1e-6
    assert bodies["torch"][1][1] == bodies["jax"][1][1]


def test_explain_without_explainer_is_501_on_both_servers():
    class Doubler:
        def predict(self, inputs, headers=None):
            return {"predictions": [[2 * v for v in r] for r in inputs["instances"]]}

    jm = type("JD", (Doubler, JModel), {})("dbl")
    tm = type("TD", (Doubler, TModel), {})("dbl")
    jrep = _JaxReplica([jm])
    tsrv = ModelServer([tm], http_port=0).start()
    try:
        got = [_call(p, "POST", "/v1/models/dbl:explain", {"instances": [[1]]})[0]
               for p in (jrep.port, tsrv.port)]
    finally:
        jrep.close()
        tsrv.stop()
    assert got == [501, 501]


# ---------------------------------------------------------------- modelmesh


def _toy_registry(side, built=None):
    S = SIDES[side]
    reg = S.spec.RuntimeRegistry()

    def factory(name, path, **kw):
        if built is not None:
            built.append(kw.get("flavor", "v1"))
        return S.toy(name)

    reg.register(S.spec.ServingRuntime(name="toy", supported_formats=("toy",),
                                       factory=factory, priority=1))
    return reg


def _predict_one(m, row):
    out = m.predict(m.preprocess({"instances": [row]}))
    return np.asarray(out).shape[0]


def test_controller_places_services_onto_the_mesh_as_jax_does():
    """Mirrors ``test_modelmesh.py``'s placement case."""
    out = {}
    for side in SIDES:
        S = SIDES[side]
        mesh = S.mesh(2 * PER_MODEL + 64)
        ctl = S.ctl.InferenceServiceController(_toy_registry(side), model_mesh=mesh)
        for i in range(3):
            ctl.apply(_spec(side, f"svc{i}", model_format="toy"))
        lazy = mesh.resident()
        shapes = [_predict_one(ctl.route(f"svc{i}"), [5, 6]) for i in (0, 1, 2)]
        resident = sorted(mesh.resident())
        evictions = mesh.stats["evictions"]
        ctl.delete("svc1")
        out[side] = (lazy, shapes, resident, evictions, sorted(mesh.names()))
    assert out["torch"] == out["jax"]
    lazy, shapes, resident, evictions, names = out["torch"]
    assert lazy == [] and shapes == [1, 1, 1] and len(resident) <= 2
    assert evictions >= 1 and not any(n.startswith("default/svc1@") for n in names)


def test_rollout_replaces_model_without_bricking_service_as_in_jax():
    """Mirrors ``test_modelmesh.py``'s rollout case."""
    out = {}
    for side in SIDES:
        S = SIDES[side]
        built = []
        mesh = S.mesh(8 * PER_MODEL)
        ctl = S.ctl.InferenceServiceController(_toy_registry(side, built),
                                               model_mesh=mesh)
        ctl.apply(_spec(side, model_format="toy", extra={"flavor": "v1"}))
        first = _predict_one(ctl.route("svc"), [1])
        ctl.apply(_spec(side, model_format="toy", extra={"flavor": "v2"}))
        m2 = ctl.route("svc")
        out[side] = (first, _predict_one(m2, [1]), list(built), m2.ready,
                     len(mesh.names()))
    assert out["torch"] == out["jax"] == (1, 1, ["v1", "v2"], True, 1)


def test_rollout_with_shared_component_keeps_new_service_alive_as_in_jax():
    """Mirrors ``test_modelmesh.py``'s refcounted shared-component case:
    only the transformer changes, so the predictor's mesh entry is shared
    by the old and new materialisations and survives the old one's
    retire."""
    out = {}
    for side in SIDES:
        S = SIDES[side]
        mesh = S.mesh(8 * PER_MODEL)
        ctl = S.ctl.InferenceServiceController(_toy_registry(side), model_mesh=mesh)

        def spec(tflavor):
            return _spec(side, model_format="toy",
                         transformer=dict(model_format="toy",
                                          extra={"flavor": tflavor}))

        ctl.apply(spec("t1"))
        first = _predict_one(ctl.route("svc"), [1])
        ctl.apply(spec("t2"))
        m2 = ctl.route("svc")
        out[side] = (first, _predict_one(m2, [1]), m2.ready, len(mesh.names()))
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == (1, 1, True)


# ------------------------------------------------------------- threads


def test_apply_races_readers_without_errors():
    """The gateway's probe thread reads the services while ``apply`` swaps
    revisions and ``route`` picks them: the snapshot and the locks keep
    every reader consistent. Bounded by counts, not time."""
    from kubeflow_tpu_torch.gateway.router import RouteTable

    ctl = tctl.InferenceServiceController(_echo_registry("torch"))
    ctl.apply(_spec("torch", extra={"version": 0}))
    done = threading.Event()
    errors = []
    table = RouteTable()
    running = threading.Barrier(4, timeout=60)  # three readers and the applier
    passes = [0, 0, 0]
    passed = threading.Condition()

    def reader(k):
        try:
            running.wait()
            while not done.is_set():
                table.update_from_controller(ctl)
                m = ctl.route("svc", request_id=f"{k}")
                assert m is not None and m.name.startswith("svc-v")
                for key, st in ctl.services():
                    assert key.startswith("default/")
                with passed:
                    passes[k] += 1
                    passed.notify_all()
        except Exception as e:  # noqa: BLE001 — the assertion below reports
            with passed:
                errors.append(e)
                passed.notify_all()

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
    for th in threads:
        th.start()
    try:
        running.wait()  # every reader is in its loop before the first apply
        for i in range(1, 120):
            ctl.apply(_spec("torch", f"svc{i % 7}", extra={"version": i}))
            ctl.apply(_spec("torch", extra={"version": i},
                            canary_traffic_percent=(0, 30, 100)[i % 3]))
            if i % 5 == 0:
                ctl.promote_canary("svc")
            if i % 10 == 0:  # every reader passes again amid the applies
                with passed:
                    seen = list(passes)
                    assert passed.wait_for(lambda: errors or all(
                        n > m for n, m in zip(passes, seen)), 60)
                if errors:
                    break
    finally:
        done.set()
        for th in threads:
            th.join(60)
    assert not errors, errors[0]
    assert all(n >= 11 for n in passes)
    table.update_from_controller(ctl)  # a feed after the race sees them all
    assert {r.name for r in table.routes()} == {"svc"} | {f"svc{i}" for i in range(7)}


# ------------------------------------------------------------ end to end


TEXTS = ["The Cat sat on the mat.", "the cats sat, Paris", "a b ?",
         "paris is the capital of the mat"]


def test_bert_tiny_isvc_from_manifest_predicts_as_the_jax_controller(tmp_path):
    """kserve-bert's manifest, ``storageUri`` pointed at a bert-tiny
    HF-format directory: both controllers materialise it (the storage
    initializer copies it under ``model_dir``), and the served answers
    are identical, in process and over HTTP."""
    vocab = VOCAB + [f"w{i}" for i in range(1024 - len(VOCAB))]
    d = write_hf_dir(tmp_path / "hf", _hf_state(pooler=False), vocab=vocab)
    base = yaml.safe_load(
        (ROOT / "kubeflow_tpu_torch/examples/manifests/bert_isvc.yaml").read_text())
    preds, http = {}, {}
    for side, reg, extra in (("jax", jax_registry(), {"attn_impl": "reference"}),
                             ("torch", torch_registry(), {"device": "cpu"})):
        doc = json.loads(json.dumps(base))
        model = doc["spec"]["predictor"]["model"]
        model["storageUri"] = f"file://{d}"
        model["extra"] = extra
        S = SIDES[side]
        spec = S.spec.InferenceServiceSpec.from_manifest(doc)
        ctl = S.ctl.InferenceServiceController(
            reg, model_dir=str(tmp_path / f"models-{side}"))
        st = ctl.apply(spec)
        assert st.ready and st.conditions == ["PredictorReady", "Ready"]
        assert st.replicas.ready_replicas == 1 and st.replicas.desired_replicas == 1
        m = ctl.route("bert")
        assert m._storage_path.startswith(str(tmp_path / f"models-{side}"))
        payload = {"instances": TEXTS + [{"input_ids": [2, 5, 6, 3]}]}
        preds[side] = m.postprocess(m.predict(m.preprocess(payload)))
        server = (_JaxReplica([m]) if side == "jax"
                  else ModelServer([m], http_port=0).start())
        try:
            status, _, data = _call(server.port, "POST", "/v1/models/bert:predict",
                                    {"instances": TEXTS[:2]})
            http[side] = (status, json.loads(data))
        finally:
            if side == "jax":
                server.close()
            else:
                server.stop()
    assert preds["torch"] == preds["jax"]
    assert http["torch"] == http["jax"] and http["torch"][0] == 200
    assert len(preds["torch"]["predictions"]) == 5


def test_manifest_dtype_string_reaches_the_runtime(tmp_path):
    """An ``extra`` value from YAML is a string: ``dtype: bfloat16`` gives
    a bf16 model, as the JAX runtime's flax config takes the name."""
    import torch

    doc = {"metadata": {"name": "b"}, "spec": {"predictor": {"model": {
        "modelFormat": {"name": "bert-tiny"},
        "extra": {"dtype": "bfloat16", "device": "cpu"}}}}}
    ctl = tctl.InferenceServiceController(torch_registry(),
                                          model_dir=str(tmp_path))
    st = ctl.apply(tspec.InferenceServiceSpec.from_manifest(doc))
    assert st.default_model.config.dtype == torch.bfloat16
    for bad in ("int8", "bfloat17"):
        doc["spec"]["predictor"]["model"]["extra"]["dtype"] = bad
        with pytest.raises(ValueError, match="floating-point torch dtype"):
            ctl.apply(tspec.InferenceServiceSpec.from_manifest(doc))


def test_isvc_modules_are_ported():
    pkg = ROOT / "kubeflow_tpu_torch" / "serve"
    for name in ("controller.py", "composite.py", "graph.py", "logger.py", "spec.py"):
        assert (ROOT / "kubeflow_tpu" / "serve" / name).exists()
        assert (pkg / name).exists(), name
    import kubeflow_tpu_torch.serve as serve

    for name in ("InferenceServiceController", "ComposedService", "GraphSpec",
                 "InferenceGraph", "RequestLogger", "InferenceServiceSpec",
                 "PredictorSpec", "ServingRuntime", "ModelServer", "LMEngineModel"):
        assert getattr(serve, name).__name__ == name
    with pytest.raises(AttributeError):
        serve.NoSuchThing  # noqa: B018
