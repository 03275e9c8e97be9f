"""The port's ModelMesh (``kubeflow_tpu_torch/serve/modelmesh.py``): the
cases of ``tests/test_modelmesh.py`` that need no controller, on
``TorchModel``s with CPU weights and an injected clock, as the JAX file
runs them on ``JAXModel``s. Where a case's outcome is a number or a
sequence (LRU order, stats, jittered cooldowns a seed draws), the JAX
mesh runs the same sequence beside it and the two must agree. One case
serves ``MeshBackedModel``s through the port's ``ModelServer``.

The footprint rule is JAX's: a model's weights (here ``module``'s
parameters and buffers), and 0 bytes for a model without them, such as
a tabular booster."""

from __future__ import annotations

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu.serve import modelmesh as jmm
from kubeflow_tpu_torch.serve.model import BucketSpec, TorchModel
from kubeflow_tpu_torch.serve.modelmesh import (
    MeshBackedModel,
    ModelMesh,
    ModelState,
    _device_bytes,
)
from kubeflow_tpu_torch.serve.server import ModelServer
from test_modelmesh import _jax_model

PER_MODEL = 32 * 32 * 4  # bytes of the test model's weights


class _Weights(torch.nn.Module):
    def __init__(self, d: int, dev):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones((d, d), device=dev))


def _torch_model(name: str, d: int = 32, cls=TorchModel):
    """A ``TorchModel`` whose device weights are one ``d x d`` f32 matrix:
    ``_jax_model``'s function on the CPU."""

    def apply_fn(module, ids, mask, tt):
        emb = module.w[ids.long() % module.w.shape[0]]
        return emb.sum(-1, keepdim=True) + mask[..., None].float()

    return cls(name, apply_fn, lambda dev: _Weights(d, dev),
               buckets=BucketSpec(batch_sizes=(1, 2), seq_lens=(8,)), device="cpu")


def test_device_bytes_reads_the_weights_as_jax_does(tmp_path):
    m = _torch_model("m")
    assert _device_bytes(m) == 0  # not loaded: no weights
    m.load()
    assert _device_bytes(m) == PER_MODEL
    m.module.register_buffer("scale", torch.ones(8))
    assert _device_bytes(m) == PER_MODEL + 8 * 4  # buffers count too
    jm = _jax_model("m")
    jm.load()
    assert jmm._device_bytes(jm) == PER_MODEL
    m.unload()
    assert _device_bytes(m) == 0

    # a booster's node arrays are not weights: 0 bytes, as in JAX
    from test_xgboost_runtime import STUMP, _checkpoint, _write

    from kubeflow_tpu.serve.xgboost_runtime import XGBoostRuntimeModel as JaxXGB
    from kubeflow_tpu_torch.serve.xgboost_runtime import XGBoostRuntimeModel

    _write(tmp_path, _checkpoint([STUMP], num_feature=1))
    gbt, jgbt = XGBoostRuntimeModel("g", str(tmp_path), device="cpu"), JaxXGB("g", str(tmp_path))
    gbt.load()
    jgbt.load()
    assert _device_bytes(gbt) == jmm._device_bytes(jgbt) == 0
    assert gbt.walk.resident_bytes > 0


def test_lazy_registration_costs_no_hbm():
    mesh = ModelMesh(hbm_budget_bytes=2 * PER_MODEL + 64)
    for i in range(8):
        mesh.register(f"m{i}", lambda i=i: _torch_model(f"m{i}"))
    assert mesh.resident() == [] and mesh.resident_bytes() == 0
    assert mesh.names() == [f"m{i}" for i in range(8)]
    assert mesh.readiness("m3")["state"] == ModelState.REGISTERED


def _lru_run(mesh_cls, make):
    t = [0.0]
    mesh = mesh_cls(2 * PER_MODEL + 64, clock=lambda: t[0])
    for i in range(3):
        mesh.register(f"m{i}", lambda i=i: make(f"m{i}"))
    trail = []
    for now, name in ((1.0, "m0"), (2.0, "m1"), (3.0, "m0"), (4.0, "m2"), (5.0, "m1")):
        t[0] = now
        mesh.model(name)
        trail.append((mesh.resident(), dict(mesh.stats), mesh.resident_bytes()))
    return mesh, trail


def test_lru_eviction_under_budget():
    mesh, trail = _lru_run(ModelMesh, _torch_model)
    assert trail[1][0] == ["m0", "m1"]
    assert trail[3][0] == ["m0", "m2"]  # m2 evicted m1, not the touched m0
    assert trail[3][1]["evictions"] == 1
    assert trail[4][0] == ["m1", "m2"]  # m1 reloads, evicting the LRU m0
    assert mesh.stats["evictions"] == 2
    assert mesh.stats["loads"] == 4
    assert mesh.readiness("m0")["state"] == ModelState.REGISTERED
    _, jtrail = _lru_run(jmm.ModelMesh, _jax_model)
    assert trail == jtrail


def test_model_larger_than_budget_fails_closed():
    mesh = ModelMesh(PER_MODEL // 2)
    mesh.register("big", lambda: _torch_model("big"))
    with pytest.raises(RuntimeError, match="budget"):
        mesh.model("big")
    assert mesh.readiness("big")["state"] == ModelState.FAILED
    assert mesh.readiness("big")["error"] == f"model needs {PER_MODEL} bytes > budget {PER_MODEL // 2}"
    assert mesh.resident() == []


def test_broken_factory_fails_only_its_model():
    mesh = ModelMesh(4 * PER_MODEL)
    mesh.register("ok", lambda: _torch_model("ok"))

    def boom():
        raise OSError("corrupt checkpoint")

    mesh.register("bad", boom)
    with pytest.raises(RuntimeError, match="corrupt checkpoint"):
        mesh.model("bad")
    assert mesh.readiness("bad")["state"] == ModelState.FAILED
    assert mesh.readiness("bad")["error"] == "OSError: corrupt checkpoint"
    mesh.model("ok")
    assert mesh.resident() == ["ok"]


def test_unknown_model_is_keyerror():
    mesh = ModelMesh(PER_MODEL)
    with pytest.raises(KeyError):
        mesh.model("ghost")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_mesh_backed_models_serve_through_the_model_server():
    """Three proxies over a budget of two behind the port's ``ModelServer``:
    round-robin requests pull models in and evict the LRU; every answer is
    the model's own when it is served alone."""
    alone = _torch_model("alone")
    alone.load()
    mesh = ModelMesh(2 * PER_MODEL + 64)
    proxies = [MeshBackedModel(mesh, f"m{i}", lambda i=i: _torch_model(f"m{i}"))
               for i in range(3)]
    srv = ModelServer(proxies, http_port=0).start()
    try:
        assert mesh.resident() == []  # ready proxies: the server loads none
        rows = [[1, 2, 3], [4, 5]]
        want = alone.postprocess(alone.predict(alone.preprocess({"instances": rows})))
        for i in (0, 1, 2, 0, 1, 2):
            status, body = _post(srv.port, f"/v1/models/m{i}:predict", {"instances": rows})
            assert status == 200 and body == want
            assert f"m{i}" in mesh.resident() and len(mesh.resident()) <= 2
            assert mesh.resident_bytes() == PER_MODEL * len(mesh.resident())
        status, body = _post(srv.port, "/v1/models/m1:explain", {"instances": rows})
        assert status == 501 and body["error"] == "model 'm1' has no explainer"
        assert mesh.stats["evictions"] >= 4
    finally:
        srv.stop()
    assert mesh.resident() == []  # stop() unloads every proxy: releases


def test_failed_load_recovers_after_cooldown():
    t = [0.0]
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise OSError("transient storage flake")
        return _torch_model("f")

    mesh = ModelMesh(4 * PER_MODEL, clock=lambda: t[0], retry_cooldown_s=5.0)
    proxy = MeshBackedModel(mesh, "f", flaky)
    with pytest.raises(RuntimeError, match="transient"):
        mesh.model("f")
    t[0] = 1.0
    assert not proxy.ready
    with pytest.raises(RuntimeError, match="retry in"):
        mesh.model("f")
    assert attempts["n"] == 1
    t[0] = 6.0
    assert proxy.ready
    mesh.model("f")
    assert mesh.resident() == ["f"]


def test_concurrent_loads_serialize_within_budget():
    mesh = ModelMesh(2 * PER_MODEL + 64)
    for i in range(2):
        mesh.register(f"m{i}", lambda i=i: _torch_model(f"m{i}"))
    errs = []

    def hit(name):
        try:
            for _ in range(5):
                mesh.model(name)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(f"m{i % 2}",)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    assert mesh.resident_bytes() <= mesh.budget
    assert mesh.stats["loads"] == 2


def test_scale_to_zero_then_cold_start_recovers():
    mesh = ModelMesh(4 * PER_MODEL)
    loads = {"n": 0}

    def factory():
        loads["n"] += 1
        return _torch_model("svc")

    proxy = MeshBackedModel(mesh, "svc", factory)
    proxy.load()
    assert mesh.resident() == ["svc"]
    proxy.unload()
    assert mesh.resident() == [] and "svc" in mesh.names()
    out = proxy.predict(proxy.preprocess({"instances": [[1, 2]]}))
    assert out.shape[0] == 1 and loads["n"] == 2
    assert proxy({"instances": [[1, 2]]}) == {"predictions": out.tolist()}
    proxy.retire()
    assert "svc" not in mesh.names()


def test_pinned_entry_never_evicted_mid_request():
    mesh = ModelMesh(2 * PER_MODEL + 64)
    for n in ("a", "b", "c"):
        mesh.register(n, lambda n=n: _torch_model(n))
    mesh.model("a")
    mesh.model("b")
    with mesh.pinned("a") as am:
        mesh.model("c")  # evicts b (LRU among unpinned), not the pinned a
        assert "a" in mesh.resident() and "b" not in mesh.resident()
        assert am.module is not None
        mesh.model("b")  # a pinned, so c goes
        assert "a" in mesh.resident() and "c" not in mesh.resident()
        assert am.predict(am.preprocess({"instances": [[1, 2]]})).shape[0] == 1


def test_deregister_while_pinned_drains_at_unpin():
    mesh = ModelMesh(4 * PER_MODEL)
    mesh.register("m", lambda: _torch_model("m"))
    with mesh.pinned("m") as model:
        mesh.deregister("m")
        assert "m" not in mesh.names()
        assert model.module is not None
        assert mesh.resident_bytes() == PER_MODEL  # draining bytes still count
        out = model.predict([np.asarray([1, 2], np.int32)])
        assert out.shape[0] == 1
    assert model.module is None
    assert mesh.resident_bytes() == 0


def test_explain_through_mesh_backed_model():
    class Attrib(TorchModel):
        def explain(self, payload, headers=None):
            return {"explanations": ["ok"]}

    mesh = ModelMesh(4 * PER_MODEL)
    proxy = MeshBackedModel(mesh, "a", lambda: _torch_model("a", cls=Attrib))
    assert proxy.explain({"instances": [[1]]}) == {"explanations": ["ok"]}


def _jittered(mesh_cls, seed):
    """The cooldown a failure draws, and the window's edges, under ``seed``."""
    def broken():
        raise OSError("backend down")

    t = [0.0]
    mesh = mesh_cls(4 * PER_MODEL, clock=lambda: t[0], retry_cooldown_s=5.0,
                    retry_jitter=0.2, jitter_seed=seed)
    mesh.register("b", broken)
    with pytest.raises(RuntimeError):
        mesh.model("b")
    cd = mesh.readiness("b")["cooldown_s"]
    t[0] = cd - 0.01
    with pytest.raises(RuntimeError, match="retry in"):
        mesh.model("b")
    t[0] = cd + 0.01
    with pytest.raises(RuntimeError, match="backend down"):
        mesh.model("b")
    return cd


def test_retry_cooldown_jitter_desynchronizes_replicas():
    cooldowns = [_jittered(ModelMesh, seed) for seed in range(6)]
    assert all(5.0 <= cd < 6.0 for cd in cooldowns)
    assert len(set(cooldowns)) > 1
    # the same seeds draw JAX's cooldowns
    assert cooldowns == [_jittered(jmm.ModelMesh, seed) for seed in range(6)]


def test_mesh_backed_model_ready_uses_jittered_cooldown():
    t = [0.0]
    mesh = ModelMesh(4 * PER_MODEL, clock=lambda: t[0], retry_cooldown_s=5.0,
                     retry_jitter=0.5, jitter_seed=123)

    def broken():
        raise OSError("nope")

    proxy = MeshBackedModel(mesh, "m", broken)
    with pytest.raises(RuntimeError):
        mesh.model("m")
    cd = mesh.readiness("m")["cooldown_s"]
    assert cd > 5.0
    t[0] = 5.0
    assert not proxy.ready
    t[0] = cd
    assert proxy.ready
    assert mesh.cooldown_remaining("m") == 0.0


def test_modelmesh_load_failure_counter():
    from kubeflow_tpu_torch.obs.prom import REGISTRY

    def broken():
        raise ValueError("bad weights")

    mesh = ModelMesh(4 * PER_MODEL, retry_cooldown_s=0.0)
    mesh.register("counted", broken)
    for _ in range(3):
        with pytest.raises(RuntimeError):
            mesh.model("counted")
    assert 'kft_modelmesh_load_failures_total{model="counted"} 3' in REGISTRY.expose()


def test_retry_jitter_validation():
    with pytest.raises(ValueError, match="retry_jitter"):
        ModelMesh(1024, retry_jitter=1.5)
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        ModelMesh(0)
    t = [0.0]
    mesh = ModelMesh(1024, clock=lambda: t[0], retry_cooldown_s=5.0, retry_jitter=0.0)

    def broken():
        raise OSError("x")

    mesh.register("z", broken)
    with pytest.raises(RuntimeError):
        mesh.model("z")
    assert mesh.readiness("z")["cooldown_s"] == 5.0
