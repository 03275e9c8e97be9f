"""The port's tabular predictors (``kubeflow_tpu_torch/serve/{xgboost,
lightgbm,pmml,sklearn}_runtime.py``) against the JAX runtimes.

Every case of ``tests/test_xgboost_runtime.py``,
``tests/test_lightgbm_runtime.py`` and ``tests/test_pmml_runtime.py``,
and the sklearn and ``:explain`` cases of ``tests/test_serve.py`` that
need no controller, run here on the same checkpoints (the JAX files'
own writers, imported) and the same seeded numpy inputs, through both
packages:

- parsing: every ``BoosterArrays`` field bit-equal to JAX's;
- routing: the port's final walk cursors equal the JAX walk's
  (``_jax_leaves`` runs the JAX program's scan) and the host walk's;
  class outputs identical;
- margins and probabilities: within rtol 1e-5 and atol 1e-5 of JAX's,
  or the JAX file's own bound for the case where that is tighter, and
  each case's expectation at the JAX file's bound;
- fail-closed parses raise JAX's exception type and message;
- the end-to-end cases go through the port's stdlib ``ModelServer``
  (v1 ``:predict``, v2 ``/infer``, ``:explain``) and the JAX aiohttp
  ``ModelServer`` with the same bodies.

The port runs on the CPU here (``device="cpu"``), where its walk is the
same torch ops the card runs.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import math
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from kubeflow_tpu.serve import lightgbm_runtime as jl
from kubeflow_tpu.serve import pmml_runtime as jp
from kubeflow_tpu.serve import sklearn_runtime as js
from kubeflow_tpu.serve import xgboost_runtime as jx
from kubeflow_tpu_torch.serve import lightgbm_runtime as tl
from kubeflow_tpu_torch.serve import pmml_runtime as tp
from kubeflow_tpu_torch.serve import sklearn_runtime as ts
from kubeflow_tpu_torch.serve import xgboost_runtime as tx
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer
from test_lightgbm_runtime import _fuzz_once, _oracle_margin, _random_tree, _to_text
from test_pmml_runtime import FOREST, HEADER, LOGISTIC, REGRESSION, TREE, _split_doc
from test_xgboost_runtime import STUMP, _checkpoint, _random_checkpoint, _tree, _write

RTOL = ATOL = 1e-5
BOOSTER_FIELDS = ("feat", "thresh", "left", "right", "default_left", "is_leaf",
                  "leaf_value", "tree_class")
BOOSTER_META = ("max_depth", "num_class", "num_feature", "base_score", "objective")


# --------------------------------------------------------------- helpers

def _same_booster(jb, tb):
    """Bit-equal parse results: every array's dtype, shape and bytes, and
    the metadata."""
    for f in BOOSTER_FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in BOOSTER_META:
        assert getattr(jb, f) == getattr(tb, f), f


def _jax_leaves(b, x):
    """The JAX program's final cursors ``(T, B)``: the scan of
    ``kubeflow_tpu/serve/xgboost_runtime.py`` ``build_device_predict``."""
    import jax
    import jax.numpy as jnp

    feat, thresh = jnp.asarray(b.feat), jnp.asarray(b.thresh)
    left, right = jnp.asarray(b.left), jnp.asarray(b.right)
    dleft = jnp.asarray(b.default_left)
    x = jnp.asarray(x)

    def walk(node, _):
        f = jnp.take_along_axis(feat, node, axis=1)
        th = jnp.take_along_axis(thresh, node, axis=1)
        dl = jnp.take_along_axis(dleft, node, axis=1)
        xv = x.T[f, jnp.arange(x.shape[0])[None, :]]
        go_left = jnp.where(jnp.isnan(xv), dl, xv < th)
        nxt = jnp.where(go_left, jnp.take_along_axis(left, node, axis=1),
                        jnp.take_along_axis(right, node, axis=1))
        return nxt, None

    node0 = jnp.zeros((b.n_trees, x.shape[0]), jnp.int32)
    node, _ = jax.lax.scan(walk, node0, None, length=b.max_depth)
    return np.asarray(node)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=min(rtol, RTOL), atol=min(atol, ATOL))


def _hold(jb, tb, x, output="auto", rtol=RTOL, atol=ATOL):
    """Both walks on ``x``: routing identical (JAX scan, port cursors and
    the host walk), outputs within tolerance (integer outputs equal).
    Returns the port's output."""
    x = np.asarray(x, np.float32)
    twalk = tx.build_device_predict(tb, output, device="cpu")
    want_leaves = _jax_leaves(jb, x)
    np.testing.assert_array_equal(twalk.leaves(x), want_leaves)
    np.testing.assert_array_equal(tx.leaves_numpy(tb, x), want_leaves)
    got = twalk(x).numpy()
    want = np.asarray(jx.build_device_predict(jb, output)(x))
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, rtol, atol)
    return got


def _xgb(path):
    jb, tb = jx.parse_xgboost_json(path), tx.parse_xgboost_json(path)
    _same_booster(jb, tb)
    return jb, tb


def _lgb(path):
    jb, tb = jl.parse_lightgbm_txt(path), tl.parse_lightgbm_txt(path)
    _same_booster(jb, tb)
    return jb, tb


def _same_error(jfn, tfn, exc=Exception):
    """Both raise: the same type and the same message."""
    with pytest.raises(exc) as je:
        jfn()
    with pytest.raises(exc) as te:
        tfn()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)
    return str(te.value)


def _jax_http(models, requests):
    """``(status, text)`` of each ``(path, body)`` POSTed to a JAX
    aiohttp ``ModelServer`` over ``models``."""
    from aiohttp.test_utils import TestClient, TestServer

    from kubeflow_tpu.serve.server import ModelServer as JaxServer

    async def run():
        out = []
        async with TestClient(TestServer(JaxServer(models).build_app())) as c:
            for path, body in requests:
                r = await c.post(path, json=body)
                out.append((r.status, await r.text()))
        return out

    return asyncio.run(run())


def _port_http(models, requests):
    """The same through the port's stdlib ``ModelServer``."""
    srv = ModelServer(models, http_port=0).start()
    out = []
    try:
        for path, body in requests:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
            try:
                conn.request("POST", path, body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                out.append((resp.status, resp.read().decode()))
            finally:
                conn.close()
    finally:
        srv.stop()
    return out


def _v2(x, name="x"):
    x = np.asarray(x, np.float32)
    return {"inputs": [{"name": name, "shape": list(x.shape), "datatype": "FP32",
                        "data": x.reshape(-1).tolist()}]}


def _same_answers(jout, tout):
    """Statuses equal; on a 200 the same JSON, numbers within tolerance."""
    for (jst, jtext), (tst, ttext) in zip(jout, tout, strict=True):
        assert tst == jst, (ttext, jtext)
        if jst != 200:
            continue
        jb, tb = json.loads(jtext), json.loads(ttext)
        if "outputs" in jb:
            assert tb["model_name"] == jb["model_name"]
            for jt, tt in zip(jb["outputs"], tb["outputs"], strict=True):
                assert {k: tt[k] for k in ("name", "shape", "datatype")} == {
                    k: jt[k] for k in ("name", "shape", "datatype")}
                _close(tt["data"], jt["data"])
        elif "predictions" in jb:
            _close(tb["predictions"], jb["predictions"])
        else:
            assert tb.keys() == jb.keys()
            for je, te in zip(jb["explanations"], tb["explanations"], strict=True):
                _close(te["contributions"], je["contributions"])
                _close(te["intercept"], je["intercept"])


# ----------------------------------------------- tests/test_xgboost_runtime.py

def test_single_stump_regression(tmp_path):
    jb, tb = _xgb(_write(tmp_path, _checkpoint([STUMP], num_feature=1, base_score=2.0)))
    x = np.asarray([[0.0], [0.9], [np.nan]], np.float32)
    got = _hold(jb, tb, x, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, [3.0, -1.0, 3.0], rtol=1e-6)


def test_depth_and_missing_routing_match_host_walk(tmp_path):
    t = _tree(
        [1, 0, 2, 0, 0, 0, 0],
        [0.0, -1.0, 5.0, 0.25, -0.5, 1.5, -2.25],
        [1, 3, 5, -1, -1, -1, -1],
        [2, 4, 6, -1, -1, -1, -1],
        [False, True, False, False, False, False, False],
    )
    jb, tb = _xgb(_write(tmp_path, _checkpoint([t, STUMP], num_feature=3)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = np.nan
    got = _hold(jb, tb, x, output="margin")
    np.testing.assert_allclose(got[:, 0], tx.margin_numpy(tb, x)[:, 0], rtol=1e-5)


def test_fuzz_random_forests_match_host_walk(tmp_path):
    rng = np.random.default_rng(7)
    for trial in range(5):
        doc = _random_checkpoint(rng, n_trees=11, num_feature=5)
        jb, tb = _xgb(_write(tmp_path, doc, f"m{trial}.json"))
        x = rng.normal(size=(32, 5)).astype(np.float32)
        x[rng.random(x.shape) < 0.2] = np.nan
        got = _hold(jb, tb, x, output="margin")
        np.testing.assert_allclose(got[:, 0], tx.margin_numpy(tb, x)[:, 0], rtol=1e-4)


def test_binary_logistic_outputs_probability(tmp_path):
    jb, tb = _xgb(_write(tmp_path, _checkpoint(
        [STUMP], num_feature=1, base_score=0.5, objective="binary:logistic")))
    x = np.asarray([[0.0], [0.9]], np.float32)
    prob = _hold(jb, tb, x)
    np.testing.assert_allclose(
        prob, 1.0 / (1.0 + np.exp(-np.asarray([1.0, -3.0]))), rtol=1e-5)
    assert ((prob > 0) & (prob < 1)).all()


def test_multiclass_softmax_and_softprob(tmp_path):
    rng = np.random.default_rng(3)
    doc = _random_checkpoint(rng, n_trees=9, num_feature=4, num_class=3,
                             objective="multi:softprob")
    jb, tb = _xgb(_write(tmp_path, doc))
    x = rng.normal(size=(16, 4)).astype(np.float32)
    probs = _hold(jb, tb, x)
    assert probs.shape == (16, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    margins = tx.margin_numpy(tb, x)
    np.testing.assert_array_equal(probs.argmax(-1), margins.argmax(-1))
    _close(_hold(jb, tb, x, output="margin"), margins)
    doc["learner"]["objective"]["name"] = "multi:softmax"
    jb2, tb2 = _xgb(_write(tmp_path, doc, "m2.json"))
    cls = _hold(jb2, tb2, x)  # class ids: identical to JAX's, int32
    np.testing.assert_array_equal(cls, margins.argmax(-1))
    _hold(jb2, tb2, x, output="prob")


def test_runtime_model_lifecycle_and_validation(tmp_path):
    _write(tmp_path, _checkpoint([STUMP], num_feature=1))
    jm = jx.XGBoostRuntimeModel("gbt", str(tmp_path))
    m = tx.XGBoostRuntimeModel("gbt", str(tmp_path), device="cpu")
    jm.load()
    m.load()
    assert m.ready
    out = m.postprocess(m.predict(m.preprocess({"instances": [[0.0]]})))
    np.testing.assert_allclose(out["predictions"], [1.5])  # 1.0 + 0.5 base
    assert out == jm.postprocess(jm.predict(jm.preprocess({"instances": [[0.0]]})))
    msg = _same_error(lambda: jm.preprocess([[1.0, 2.0]]),
                      lambda: m.preprocess([[1.0, 2.0]]), ValueError)
    assert "expects 1 features" in msg
    m.unload()
    assert not m.ready and m.walk is None


def test_rejects_non_xgboost_json(tmp_path):
    p = tmp_path / "model.json"
    p.write_text(json.dumps({"not": "a booster"}))
    msg = _same_error(lambda: jx.parse_xgboost_json(str(p)),
                      lambda: tx.parse_xgboost_json(str(p)), RuntimeError)
    assert "not an XGBoost JSON checkpoint" in msg


def test_e2e_through_model_server(tmp_path):
    """The xgboost format resolves from both registries; the same v1 and
    v2 bodies get the same answers from both servers."""
    from kubeflow_tpu.serve.runtimes import default_registry as jax_registry
    from kubeflow_tpu.serve.spec import ComponentSpec as JaxComponent
    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.spec import ComponentSpec

    _write(tmp_path, _checkpoint([STUMP], num_feature=1))
    jrt = jax_registry().resolve(JaxComponent(model_format="xgboost", storage_uri="x"))
    rt = default_registry().resolve(ComponentSpec(model_format="xgboost", storage_uri="x"))
    assert rt.name == jrt.name == "kubeflow-tpu-xgboost"
    jm, m = jrt.factory("gbt", str(tmp_path)), rt.factory("gbt", str(tmp_path), device="cpu")
    jm.load()
    reqs = [("/v1/models/gbt:predict", {"instances": [[0.9], [0.0]]}),
            ("/v2/models/gbt/infer", _v2([[0.9], [0.0], [np.nan]])),
            ("/v2/models/gbt/infer", _v2([[0.9, 1.0]])),          # 400: 2 features
            ("/v1/models/gbt:predict", {"instances": [[1.0, 2.0]]})]
    tout = _port_http([m], reqs)
    _same_answers(_jax_http([jm], reqs), tout)
    np.testing.assert_allclose(json.loads(tout[0][1])["predictions"], [-2.5, 1.5])
    assert json.loads(tout[1][1])["outputs"][0]["data"] == [-2.5, 1.5, 1.5]


def test_categorical_splits_fail_closed(tmp_path):
    t = dict(STUMP)
    t["split_type"] = [1, 0, 0]
    t["categories"] = [2, 5]
    path = _write(tmp_path, _checkpoint([t], num_feature=1))
    msg = _same_error(lambda: jx.parse_xgboost_json(path),
                      lambda: tx.parse_xgboost_json(path), RuntimeError)
    assert "categorical" in msg


def test_ubj_and_missing_checkpoints_fail_closed(tmp_path):
    (tmp_path / "model.ubj").write_bytes(b"{")
    _same_error(lambda: jx._find_model_file(str(tmp_path)),
                lambda: tx._find_model_file(str(tmp_path)), RuntimeError)
    (tmp_path / "model.ubj").unlink()
    (tmp_path / "a.json").write_text("{}")
    (tmp_path / "b.json").write_text("{}")
    msg = _same_error(lambda: jx._find_model_file(str(tmp_path)),
                      lambda: tx._find_model_file(str(tmp_path)), RuntimeError)
    assert "ambiguous" in msg


def test_predict_buckets_batch_sizes(tmp_path):
    """Odd batch sizes pad to the next power of two and slice back —
    answers identical to the exact-shape run."""
    rng = np.random.default_rng(5)
    doc = _random_checkpoint(rng, n_trees=5, num_feature=3)
    _write(tmp_path, doc)
    jm = jx.XGBoostRuntimeModel("gbt", str(tmp_path))
    m = tx.XGBoostRuntimeModel("gbt", str(tmp_path), device="cpu")
    jm.load()
    m.load()
    x = rng.normal(size=(7, 3)).astype(np.float32)
    assert tx.bucket_rows(x).shape == (8, 3)
    out = m.predict(x)
    assert out.shape[0] == 7
    np.testing.assert_allclose(out, tx.margin_numpy(m.booster, x)[:, 0], rtol=1e-4)
    _close(out, m.walk(x).numpy())
    _close(out, jm.predict(x))


# ---------------------------------------------- tests/test_lightgbm_runtime.py

@pytest.mark.parametrize("seed", range(6))
def test_lightgbm_regression_parity_fuzz(tmp_path, seed):
    trees, text, x = _fuzz_once(seed, "regression")
    p = tmp_path / "model.txt"
    p.write_text(text)
    jb, tb = _lgb(str(p))
    got = _hold(jb, tb, x)
    np.testing.assert_allclose(got, _oracle_margin(trees, x)[:, 0], rtol=1e-5, atol=1e-5)


def test_lightgbm_binary_and_multiclass_links(tmp_path):
    trees, text, x = _fuzz_once(7, "binary sigmoid:1")
    p = tmp_path / "model.txt"
    p.write_text(text)
    jb, tb = _lgb(str(p))
    want = 1.0 / (1.0 + np.exp(-_oracle_margin(trees, x)[:, 0]))
    np.testing.assert_allclose(_hold(jb, tb, x, atol=1e-6), want, rtol=1e-5, atol=1e-6)

    trees, text, x = _fuzz_once(9, "multiclass num_class:3", num_class=3)
    (tmp_path / "mc.txt").write_text(text)
    jb, tb = _lgb(str(tmp_path / "mc.txt"))
    m = _oracle_margin(trees, x, num_class=3)
    e = np.exp(m - m.max(axis=1, keepdims=True))
    np.testing.assert_allclose(_hold(jb, tb, x, atol=1e-6),
                               e / e.sum(axis=1, keepdims=True), rtol=1e-5, atol=1e-6)


def test_lightgbm_le_boundary_is_exact(tmp_path):
    tree = {
        "num_leaves": 2, "split_feature": [0], "threshold": [1.25],
        "decision_type": [2], "left_child": [-1], "right_child": [-2],
        "leaf_value": [10.0, 20.0],
    }
    p = tmp_path / "model.txt"
    p.write_text(_to_text([tree], n_feat=1))
    jb, tb = _lgb(str(p))
    x = np.asarray(
        [[1.25], [np.nextafter(np.float32(1.25), np.float32(2))], [1.0]], np.float32)
    np.testing.assert_allclose(_hold(jb, tb, x), [10.0, 20.0, 10.0])


def test_lightgbm_rejects_unsupported_and_serves_e2e(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text(_to_text(
        [_random_tree(np.random.default_rng(0), 3, 4)], objective="poisson"))
    assert "not supported" in _same_error(
        lambda: jl.parse_lightgbm_txt(str(bad)),
        lambda: tl.parse_lightgbm_txt(str(bad)), RuntimeError)

    cat = _random_tree(np.random.default_rng(1), 3, 4)
    (tmp_path / "cat.txt").write_text(_to_text([cat]).replace("num_cat=0", "num_cat=1"))
    assert "categorical" in _same_error(
        lambda: jl.parse_lightgbm_txt(str(tmp_path / "cat.txt")),
        lambda: tl.parse_lightgbm_txt(str(tmp_path / "cat.txt")), RuntimeError)

    zero_missing = dict(cat, decision_type=[4] * 3)
    (tmp_path / "zm.txt").write_text(_to_text([zero_missing]))
    assert "zero_as_missing" in _same_error(
        lambda: jl.parse_lightgbm_txt(str(tmp_path / "zm.txt")),
        lambda: tl.parse_lightgbm_txt(str(tmp_path / "zm.txt")), RuntimeError)

    (tmp_path / "nohdr.txt").write_text("version=v4\n")
    _same_error(lambda: jl.parse_lightgbm_txt(str(tmp_path / "nohdr.txt")),
                lambda: tl.parse_lightgbm_txt(str(tmp_path / "nohdr.txt")), RuntimeError)

    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.spec import PredictorSpec

    trees, text, x = _fuzz_once(3, "regression", with_nan=False)
    mdir = tmp_path / "mnt"
    mdir.mkdir()
    (mdir / "model.txt").write_text(text)
    rt = default_registry().resolve(
        PredictorSpec(model_format="lightgbm", storage_uri=f"file://{mdir}"))
    assert rt.name == "kubeflow-tpu-lightgbm"
    m = rt.factory("lgb", str(mdir), device="cpu")
    assert isinstance(m, tl.LightGBMRuntimeModel)
    jm = jl.LightGBMRuntimeModel("lgb", str(mdir))
    jm.load()
    reqs = [("/v1/models/lgb:predict", {"instances": x[:3].tolist()}),
            ("/v2/models/lgb/infer", _v2(x[:5]))]
    tout = _port_http([m], reqs)
    _same_answers(_jax_http([jm], reqs), tout)
    np.testing.assert_allclose(json.loads(tout[0][1])["predictions"],
                               _oracle_margin(trees, x[:3])[:, 0], rtol=1e-5, atol=1e-5)


def test_lightgbm_le_boundary_nonrepresentable_midpoint(tmp_path):
    lo = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    hi = float(np.nextafter(np.float32(lo), np.float32(2.0)))
    t = (lo + hi) / 2.0
    assert float(np.float32(t)) == hi
    tree = {
        "num_leaves": 2, "split_feature": [0], "threshold": [repr(t)],
        "decision_type": [2], "left_child": [-1], "right_child": [-2],
        "leaf_value": [10.0, 20.0],
    }
    p = tmp_path / "model.txt"
    p.write_text(_to_text([tree], n_feat=1))
    jb, tb = _lgb(str(p))
    x = np.asarray([[lo], [hi]], np.float32)
    np.testing.assert_allclose(_hold(jb, tb, x), [10.0, 20.0])
    thr = np.asarray([t, 1.25, -0.3, 0.1 + 0.2, 1e-40])
    assert jl._le_to_lt(thr).tobytes() == tl._le_to_lt(thr).tobytes()


# -------------------------------------------------- tests/test_pmml_runtime.py

def _pmml(tmp_path, doc, name="m"):
    """Both runtimes loaded on ``doc``; tree documents also parse to
    bit-equal boosters."""
    p = tmp_path / f"{name}.pmml"
    p.write_text(doc)
    jk, jpay = jp.parse_pmml(str(p))
    tk, tpay = tp.parse_pmml(str(p))
    assert tk == jk
    if jk == "trees":
        _same_booster(jpay, tpay)
    else:
        for a, b in zip(jpay[:2], tpay[:2]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert jpay[2:] == tpay[2:]
    jm = jp.PMMLRuntimeModel(name, str(p))
    m = tp.PMMLRuntimeModel(name, str(p), device="cpu")
    jm.load()
    m.load()
    assert m.num_feature == jm.num_feature
    return jm, m, (jpay, tpay) if jk == "trees" else None


def _pmml_predict(jm, m, x, rtol=RTOL, atol=ATOL, trees=None):
    x = np.asarray(x, np.float32)
    got = m.predict(m.preprocess({"instances": x.tolist()}))
    _close(got, np.asarray(jm.predict(x)), rtol, atol)
    if trees is not None:
        jb, tb = trees
        _hold(jb, tb, x, rtol=rtol, atol=atol)
    return got


def test_pmml_regression_model_matmul(tmp_path):
    jm, m, _ = _pmml(tmp_path, REGRESSION)
    out = _pmml_predict(jm, m, [[1.0, 2.0], [0.0, 4.0]], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out, [2.5, -0.5], rtol=1e-6)


def test_pmml_logistic_link(tmp_path):
    jm, m, _ = _pmml(tmp_path, LOGISTIC)
    x = np.asarray([[0.0, 0.0], [1.0, 1.0]], np.float32)
    out = _pmml_predict(jm, m, x, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out, 1 / (1 + np.exp(-(3 * x[:, 0] + x[:, 1]))), rtol=1e-6)


def test_pmml_tree_model_walk(tmp_path):
    jm, m, trees = _pmml(tmp_path, TREE)
    cases = [([0.5, -2.0], 10.0), ([0.5, -1.0], 20.0), ([0.6, 0.0], 30.0),
             ([0.0, 5.0], 20.0)]
    out = _pmml_predict(jm, m, [c[0] for c in cases], rtol=1e-6, atol=0, trees=trees)
    np.testing.assert_allclose(out, [c[1] for c in cases], rtol=1e-6)


def test_pmml_forest_average(tmp_path):
    jm, m, trees = _pmml(tmp_path, FOREST)
    out = _pmml_predict(jm, m, [[-1.0, 0.0], [1.0, 2.0]], rtol=1e-6, atol=0, trees=trees)
    np.testing.assert_allclose(out, [6.0, 12.0], rtol=1e-6)


def test_pmml_weighted_average_is_a_mean(tmp_path):
    doc = FOREST.replace(
        'multipleModelMethod="average"', 'multipleModelMethod="weightedAverage"'
    ).replace("<Segment><True/>", '<Segment weight="2.0"><True/>')
    jm, m, trees = _pmml(tmp_path, doc, "wavg")
    out = _pmml_predict(jm, m, [[-1.0, 0.0]], rtol=1e-6, atol=0, trees=trees)
    np.testing.assert_allclose(out, [6.0], rtol=1e-6)


def _parse_both(tmp_path, doc, name):
    p = tmp_path / name
    p.write_text(doc)
    return _same_error(lambda: jp.parse_pmml(str(p)), lambda: tp.parse_pmml(str(p)),
                       RuntimeError)


def test_pmml_first_match_order_fails_closed(tmp_path):
    true_first = TREE.replace(
        """<Node score="-1.0">
    <SimplePredicate field="x0" operator="lessOrEqual" value="0.5"/>""",
        """<Node score="-1.0">
    <True/>""",
    )
    assert "first child" in _parse_both(tmp_path, true_first, "tf.pmml")
    noncomp = TREE.replace(
        '<SimplePredicate field="x0" operator="greaterThan" value="0.5"/>',
        '<SimplePredicate field="x1" operator="greaterThan" value="0.5"/>',
    )
    assert "complement" in _parse_both(tmp_path, noncomp, "nc.pmml")


def test_pmml_fail_closed_and_registry(tmp_path):
    compound = TREE.replace(
        '<SimplePredicate field="x0" operator="lessOrEqual" value="0.5"/>',
        '<CompoundPredicate booleanOperator="and">'
        '<SimplePredicate field="x0" operator="lessOrEqual" value="0.5"/>'
        "</CompoundPredicate>",
    )
    assert "SimplePredicate or True" in _parse_both(tmp_path, compound, "c.pmml")
    assert "not <PMML>" in _parse_both(tmp_path, "<NotPMML/>", "bad.pmml")
    assert "not valid PMML XML" in _parse_both(tmp_path, "<PMML", "broken.pmml")
    assert "no supported model element" in _parse_both(
        tmp_path, HEADER + "<NeuralNetwork/></PMML>", "n.pmml")
    exponent = REGRESSION.replace('coefficient="2.0"/>', 'coefficient="2.0" exponent="2"/>')
    assert "exponent" in _parse_both(tmp_path, exponent, "e.pmml")
    ghost = REGRESSION.replace('name="x1" coefficient', 'name="x9" coefficient')
    assert "not in DataDictionary" in _parse_both(tmp_path, ghost, "g.pmml")

    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.spec import PredictorSpec

    rt = default_registry().resolve(PredictorSpec(model_format="pmml",
                                                  storage_uri="file:///x"))
    assert rt.name == "kubeflow-tpu-pmml"
    jm, m, _ = _pmml(tmp_path, REGRESSION, "reg")
    msg = _same_error(lambda: jm.preprocess({"instances": [[1.0, 2.0, 3.0]]}),
                      lambda: m.preprocess({"instances": [[1.0, 2.0, 3.0]]}), ValueError)
    assert "expects 2 features" in msg
    assert "unsupported" in _same_error(
        lambda: jp.build_linear_predict(np.eye(2), np.zeros(2), "probit"),
        lambda: tp.build_linear_predict(np.eye(2), np.zeros(2), "probit", "cpu"),
        RuntimeError)


def _random_forest_doc(rng, n_feat):
    """``tests/test_pmml_runtime.py``'s fuzz forest, drawn in the same
    order from the same generator."""

    def rand_node(depth):
        if depth == 0 or rng.random() < 0.3:
            return f'<Node score="{round(float(rng.normal()), 3)}">%PRED%</Node>'
        f = int(rng.integers(0, n_feat))
        t = round(float(rng.normal()), 3)
        op_l, op_r = (
            ("lessOrEqual", "greaterThan")
            if rng.random() < 0.5 else ("lessThan", "greaterOrEqual")
        )
        left = rand_node(depth - 1).replace(
            "%PRED%", f'<SimplePredicate field="x{f}" operator="{op_l}" value="{t}"/>')
        right = rand_node(depth - 1).replace(
            "%PRED%", f'<SimplePredicate field="x{f}" operator="{op_r}" value="{t}"/>')
        return f"<Node>%PRED%{left}{right}</Node>"

    trees = [rand_node(3).replace("%PRED%", "<True/>") for _ in range(5)]
    header = (
        '<?xml version="1.0"?><PMML version="4.4"><DataDictionary>'
        + "".join(f'<DataField name="x{i}" optype="continuous"/>' for i in range(n_feat))
        + "</DataDictionary>"
    )
    doc = (
        header
        + '<MiningModel functionName="regression">'
        + '<Segmentation multipleModelMethod="sum">'
        + "".join(f"<Segment><True/>"
                  f'<TreeModel functionName="regression">{t}</TreeModel>'
                  f"</Segment>" for t in trees)
        + "</Segmentation></MiningModel></PMML>"
    )
    return trees, doc


def _eval_node(el, x):
    kids = [c for c in el if c.tag.endswith("Node")]
    if not kids:
        return float(el.get("score"))
    for kid in kids:
        sp = next((c for c in kid if c.tag.endswith("SimplePredicate")), None)
        v = x[int(sp.get("field")[1:])]
        t = float(sp.get("value"))
        ok = {"lessOrEqual": v <= t, "lessThan": v < t,
              "greaterThan": v > t, "greaterOrEqual": v >= t}[sp.get("operator")]
        if ok:
            return _eval_node(kid, x)
    raise AssertionError("no branch matched")


def test_pmml_fuzz_forest_against_independent_walker(tmp_path):
    rng = np.random.default_rng(0)
    n_feat = 3
    trees, doc = _random_forest_doc(rng, n_feat)
    jm, m, booster = _pmml(tmp_path, doc, "f")
    x = rng.normal(size=(64, n_feat)).astype(np.float32)
    got = _pmml_predict(jm, m, x, trees=booster)
    roots = [next(c for c in ET.fromstring(f"<w>{t}</w>") if c.tag == "Node")
             for t in trees]
    want = [sum(_eval_node(r, row) for r in roots) for row in x]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pmml_threshold_ulp_boundaries(tmp_path):
    lo = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    hi = float(np.nextafter(np.float32(lo), np.float32(2.0)))
    t_up = (lo + hi) / 2.0
    assert float(np.float32(t_up)) == hi
    jm, m, trees = _pmml(tmp_path, _split_doc("lessOrEqual", t_up), "ule")
    np.testing.assert_allclose(
        _pmml_predict(jm, m, [[lo, 0.0], [hi, 0.0]], trees=trees), [10.0, 20.0])
    t_dn = (1.0 + lo) / 2.0
    assert float(np.float32(t_dn)) == 1.0
    jm, m, trees = _pmml(tmp_path, _split_doc("lessThan", t_dn), "ult")
    np.testing.assert_allclose(
        _pmml_predict(jm, m, [[1.0, 0.0], [lo, 0.0]], trees=trees), [10.0, 20.0])
    for t in (t_up, t_dn, 0.1, -2.5, 1e-40):
        assert jp._le_to_lt32(t).tobytes() == tp._le_to_lt32(t).tobytes()
        assert jp._lt_to_lt32(t).tobytes() == tp._lt_to_lt32(t).tobytes()


def test_pmml_deep_node_chain_fails_closed(tmp_path):
    pair = (
        '<Node score="0.0"><SimplePredicate field="x0"'
        ' operator="lessOrEqual" value="0.25"/></Node>'
        '<Node score="1.0"><SimplePredicate field="x0"'
        ' operator="greaterThan" value="0.25"/></Node>'
    )
    for i in range(1200):
        pair = (
            f'<Node><SimplePredicate field="x0" operator="lessOrEqual"'
            f' value="{i}.5"/>{pair}</Node>'
            f'<Node score="1.0"><SimplePredicate field="x0"'
            f' operator="greaterThan" value="{i}.5"/></Node>'
        )
    doc = HEADER + ('<TreeModel functionName="regression"><Node><True/>'
                    + pair + "</Node></TreeModel></PMML>")
    assert "deeper than" in _parse_both(tmp_path, doc, "deep.pmml")


def test_pmml_classification_shapes_fail_closed(tmp_path):
    raw_margin = LOGISTIC.replace(' normalizationMethod="logit"', "")
    assert "normalizationMethod" in _parse_both(tmp_path, raw_margin, "rm.pmml")
    ctree = TREE.replace('<TreeModel functionName="regression">',
                         '<TreeModel functionName="classification">')
    assert "classification" in _parse_both(tmp_path, ctree, "ct.pmml")
    cmm = FOREST.replace('<MiningModel functionName="regression">',
                         '<MiningModel functionName="classification">')
    assert "classification" in _parse_both(tmp_path, cmm, "cm.pmml")
    _, m, _ = _pmml(tmp_path, LOGISTIC, "ok")
    assert m.ready


def test_pmml_softmax_regression_tables(tmp_path):
    """A three-table softmax RegressionModel: probabilities as JAX's."""
    tables = "".join(
        f'<RegressionTable intercept="{b}" targetCategory="{c}">'
        f'<NumericPredictor name="x0" coefficient="{w0}"/>'
        f'<NumericPredictor name="x1" coefficient="{w1}"/></RegressionTable>'
        for c, (b, w0, w1) in enumerate([(0.5, 1.0, -1.0), (0.0, -2.0, 0.5),
                                         (-0.25, 0.3, 0.7)]))
    doc = HEADER + (
        '<RegressionModel functionName="classification" '
        'normalizationMethod="softmax"><MiningSchema>'
        '<MiningField name="y" usageType="target"/></MiningSchema>'
        + tables + "</RegressionModel></PMML>")
    jm, m, _ = _pmml(tmp_path, doc, "sm")
    x = np.random.default_rng(4).normal(size=(9, 2)).astype(np.float32)
    got = _pmml_predict(jm, m, x)
    assert got.shape == (9, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


# ------------------------------------- tests/test_serve.py: sklearn, :explain

def _sklearn_dir(tmp_path, est, name="model.joblib"):
    import joblib

    tmp_path.mkdir(exist_ok=True)
    joblib.dump(est, tmp_path / name)
    return str(tmp_path)


def _sk_both(path):
    jm = js.SklearnRuntimeModel("sk", path)
    m = ts.SklearnRuntimeModel("sk", path, device="cpu")
    jm.load()
    m.load()
    return jm, m


def test_sklearn_linear_runtime_on_the_device_matches_sklearn(tmp_path):
    from sklearn.linear_model import LinearRegression, LogisticRegression

    rng = np.random.RandomState(0)
    X = rng.randn(200, 5)
    y = (X @ [1.0, -2.0, 0.5, 0.0, 1.5] > 0).astype(int)
    clf = LogisticRegression().fit(X, y)
    jm, m = _sk_both(_sklearn_dir(tmp_path / "clf", clf))
    assert m._linear is not None and jm._jitted is not None
    Xq = rng.randn(16, 5)
    out = m.predict(m.preprocess({"instances": Xq.tolist()}))
    np.testing.assert_array_equal(out, clf.predict(Xq))
    want = jm.predict(jm.preprocess({"instances": Xq.tolist()}))
    assert out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)

    reg = LinearRegression().fit(X, X @ [1, 2, 3, 4, 5.0])
    jm2, m2 = _sk_both(_sklearn_dir(tmp_path / "reg", reg))
    out2 = m2.predict(m2.preprocess({"instances": Xq.tolist()}))
    np.testing.assert_allclose(out2, reg.predict(Xq), rtol=1e-4)
    _close(out2, jm2.predict(jm2.preprocess({"instances": Xq.tolist()})), atol=0)

    # three classes: argmax on the device, mapped through string classes_
    y3 = np.asarray(["a", "b", "c"])[np.argmax(X[:, :3], axis=1)]
    jm3, m3 = _sk_both(_sklearn_dir(tmp_path / "c3", LogisticRegression().fit(X, y3)))
    out3 = m3.predict(m3.preprocess({"instances": Xq.tolist()}))
    np.testing.assert_array_equal(out3, jm3.predict(jm3.preprocess(
        {"instances": Xq.tolist()})))


def test_sklearn_nonlinear_falls_back_to_host(tmp_path):
    from sklearn.tree import DecisionTreeClassifier

    rng = np.random.RandomState(1)
    X = rng.randn(100, 4)
    y = (X[:, 0] * X[:, 1] > 0).astype(int)
    tree = DecisionTreeClassifier(max_depth=4).fit(X, y)
    jm, m = _sk_both(_sklearn_dir(tmp_path, tree, "model.pkl"))
    assert m._linear is None and jm._jitted is None
    Xq = rng.randn(8, 4)
    got = m.predict(m.preprocess({"instances": Xq.tolist()}))
    np.testing.assert_array_equal(got, tree.predict(Xq))
    np.testing.assert_array_equal(got, jm.predict(jm.preprocess({"instances": Xq.tolist()})))


def test_sklearn_runtime_through_registry_and_server(tmp_path):
    """The sklearn format resolves from the port's registry; v1, v2 and
    ``:explain`` answer as the JAX server does for the same bodies."""
    from sklearn.linear_model import LogisticRegression

    from kubeflow_tpu_torch.serve.runtimes import default_registry
    from kubeflow_tpu_torch.serve.spec import PredictorSpec

    rng = np.random.RandomState(2)
    X = rng.randn(100, 3)
    y = (X.sum(1) > 0).astype(int)
    src = _sklearn_dir(tmp_path / "m", LogisticRegression().fit(X, y))
    rt = default_registry().resolve(PredictorSpec(model_format="sklearn",
                                                  storage_uri=f"file://{src}"))
    assert rt.name == "kubeflow-tpu-sklearn"
    m = rt.factory("sk", src, device="cpu")
    jm = js.SklearnRuntimeModel("sk", src)
    jm.load()
    rows = [[1.0, 1.0, 1.0], [-2.0, -1.0, -1.0]]
    reqs = [("/v1/models/sk:predict", {"instances": rows}),
            ("/v2/models/sk/infer", _v2(rows)),
            ("/v1/models/sk:explain", {"instances": rows}),
            ("/v1/models/sk:explain", {"rows": rows}),             # 400
            ("/v1/models/nope:explain", {"instances": rows})]      # 404
    tout = _port_http([m], reqs)
    _same_answers(_jax_http([jm], reqs), tout)
    assert json.loads(tout[0][1])["predictions"] == [1, 0]


def test_sklearn_fail_closed_on_garbage(tmp_path):
    (tmp_path / "model.pkl").write_bytes(b"not a pickle")
    m = ts.SklearnRuntimeModel("bad", str(tmp_path), device="cpu")
    _same_error(lambda: js.SklearnRuntimeModel("bad", str(tmp_path)).load(), m.load)
    assert not m.ready
    (tmp_path / "model.pkl").unlink()
    _sklearn_dir(tmp_path, {"not": "an estimator"})
    assert "no predict()" in _same_error(
        lambda: js.SklearnRuntimeModel("bad", str(tmp_path)).load(), m.load, RuntimeError)
    assert not m.ready


def test_sklearn_ovo_svc_stays_on_host_and_correct(tmp_path):
    from sklearn.svm import SVC

    rng = np.random.RandomState(3)
    X = rng.randn(120, 4)
    y = rng.randint(0, 3, 120)
    svc = SVC(kernel="linear").fit(X, y)
    jm, m = _sk_both(_sklearn_dir(tmp_path, svc))
    assert m._linear is None, "OVO estimator must not take the argmax path"
    Xq = rng.randn(16, 4)
    got = m.predict(m.preprocess({"instances": Xq.tolist()}))
    np.testing.assert_array_equal(got, svc.predict(Xq))
    np.testing.assert_array_equal(got, jm.predict(jm.preprocess({"instances": Xq.tolist()})))
    msg = _same_error(lambda: jm.explain({"instances": Xq.tolist()}),
                      lambda: m.explain({"instances": Xq.tolist()}), NotImplementedError)
    assert "sklearn.linear_model" in msg


def test_explainer_v1_explain_endpoint(tmp_path):
    """``:explain`` over a linear model: the attributions are JAX's, and
    exact — contributions + intercept reconstruct the decision function."""
    from sklearn.linear_model import LogisticRegression

    rng = np.random.RandomState(4)
    X = rng.randn(80, 3)
    y = (X @ [2.0, -1.0, 0.5] > 0).astype(int)
    clf = LogisticRegression().fit(X, y)
    jm, m = _sk_both(_sklearn_dir(tmp_path, clf))
    body = {"instances": [[1.0, 2.0, 3.0]]}
    reqs = [("/v1/models/sk:explain", body), ("/v1/models/sk:predict", body)]
    tout = _port_http([m], reqs)
    _same_answers(_jax_http([jm], reqs), tout)
    exp = json.loads(tout[0][1])["explanations"][0]
    total = sum(exp["contributions"]) + exp["intercept"][0]
    want = float(clf.decision_function([[1.0, 2.0, 3.0]])[0])
    assert abs(total - want) < 1e-6


class _Doubler(Model):
    def predict(self, inputs, headers=None):
        return {"predictions": [[2 * v for v in row] for row in inputs["instances"]]}


def test_explain_without_explainer_is_501():
    """A model without an explainer: 501, with the JAX server's reason."""
    from kubeflow_tpu.serve.model import Model as JaxModel

    class JaxDoubler(JaxModel):
        def predict(self, inputs, headers=None):
            return {"predictions": [[2 * v for v in row] for row in inputs["instances"]]}

    reqs = [("/v1/models/dbl:explain", {"instances": [[1]]})]
    (jst, jtext), = _jax_http([JaxDoubler("dbl")], reqs)
    (tst, ttext), = _port_http([_Doubler("dbl")], reqs)
    assert tst == jst == 501
    reason = json.loads(ttext)["error"]
    assert reason == "model 'dbl' has no explainer"
    assert jtext == f"501: {reason}"


def test_tabular_payload_and_model_file_helpers(tmp_path):
    """``serve/tabular.py`` is JAX's, answer for answer."""
    from kubeflow_tpu.serve import tabular as jt
    from kubeflow_tpu_torch.serve import tabular as tt

    for payload in ({"instances": [[1, 2], [3, 4]]}, {"inputs": {"a": [[1.5, 2]]}},
                    [0.5, 1.5], [[1, float("nan")]]):
        a, b = jt.coerce_tabular_payload(payload), tt.coerce_tabular_payload(payload)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    _same_error(lambda: jt.coerce_tabular_payload([[[1]]]),
                lambda: tt.coerce_tabular_payload([[[1]]]), ValueError)
    kw = dict(preferred=("model.json",), suffixes=(".json",), kind="x")
    _same_error(lambda: jt.find_model_file(str(tmp_path), **kw),
                lambda: tt.find_model_file(str(tmp_path), **kw), RuntimeError)
    (tmp_path / "only.json").write_text("{}")
    assert tt.find_model_file(str(tmp_path), **kw) == jt.find_model_file(str(tmp_path), **kw)


def test_linear_walks_run_no_host_fallback(tmp_path):
    """On the CPU the port's walks run the same torch ops they run on the
    card, and ``device=None`` means the card: without one it raises."""
    import torch

    path = _write(tmp_path, _checkpoint([STUMP], num_feature=1))
    tb = tx.parse_xgboost_json(path)
    walk = tx.build_device_predict(tb, device="cpu")
    assert walk.resident_bytes > 0 and walk.feat.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tx.build_device_predict(tb)
        with pytest.raises(RuntimeError, match="CUDA"):
            tx.XGBoostRuntimeModel("gbt", str(tmp_path)).load()
    assert math.isfinite(float(walk(np.zeros((1, 1), np.float32))[0]))
