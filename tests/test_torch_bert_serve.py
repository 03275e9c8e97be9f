"""The port's BERT serving path against the JAX package's: the v1/v2
protocol codecs, the bucketed predictor (``TorchModel`` against
``JAXModel``), ``BertRuntimeModel``, the thread-based batcher against the
asyncio one, and the stdlib ``ModelServer``'s ``:predict``, ``/infer``
and ``/metrics`` against the JAX aiohttp server, on the CPU at
``bert_tiny`` width.

Both runtimes serve the same weights (the JAX runtime's fresh init,
bridged); the JAX one runs ``attn_impl="reference"``, the port the flash
wrapper's plain twin. Predictions are argmax ids, compared exactly: the
f32 logits agree within 2e-5 (``tests/test_torch_bert.py``), and these
seeded inputs hold no top-2 margin that small.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch
from aiohttp import web

from kubeflow_tpu.models.bert import bert_tiny as jax_bert_tiny
from kubeflow_tpu.serve import batcher as jbatcher
from kubeflow_tpu.serve import protocol as jprotocol
from kubeflow_tpu.serve import server as jserver
from kubeflow_tpu.serve.model import BucketSpec as JaxBuckets
from kubeflow_tpu.serve.runtimes import BertRuntimeModel as JaxBertRuntime
from kubeflow_tpu_torch.examples import bert_serve
from kubeflow_tpu_torch.models.bert import bert_tiny
from kubeflow_tpu_torch.models.bridge import bert_params_to_state_dict
from kubeflow_tpu_torch.serve import deadline as dl
from kubeflow_tpu_torch.serve import protocol
from kubeflow_tpu_torch.serve.batcher import Batcher, BatcherConfig
from kubeflow_tpu_torch.serve.model import BucketSpec, TorchModel
from kubeflow_tpu_torch.serve.runtimes import BertRuntimeModel
from kubeflow_tpu_torch.serve.server import ModelServer

BUCKETS = ((1, 4), (16, 32))
TEXTS = ["hello [MASK] world", "the cat sat on the mat.",
         "a much longer request that runs past sixteen tokens: one two three "
         "four five six seven eight nine ten"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the module's servers and clients are threads,
    and the CPU is shared with concurrent, timing-bound test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_runtime():
    m = JaxBertRuntime("bert", None, config=jax_bert_tiny(attn_impl="reference"),
                       buckets=JaxBuckets(*BUCKETS))
    m.load()
    return m


@pytest.fixture(scope="module")
def weights():
    """The JAX runtime's fresh weights as the port's state dict."""
    m = _jax_runtime()
    sd = bert_params_to_state_dict(jax.tree_util.tree_map(np.asarray, m._params))
    m.unload()
    return sd


def _torch_runtime(sd, **kw):
    m = BertRuntimeModel("bert", None, config=bert_tiny(),
                         buckets=BucketSpec(*BUCKETS), device="cpu",
                         state_dict=sd, **kw)
    m.load()
    return m


def _serve(model, payload):
    return model.postprocess(model.predict(model.preprocess(payload)))


# ------------------------------------------------------------------- protocol

NAMED_CASES = [
    ("lone_ids", {"input_ids": np.arange(8, dtype=np.int32).reshape(2, 4)}),
    ("ids_mask_types", {
        "input_ids": np.arange(12, dtype=np.int32).reshape(3, 4),
        "attention_mask": np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]],
                                   np.int32),
        "token_type_ids": np.array([[0, 0, 1, 1]] * 3, np.int64)}),
]


@pytest.mark.parametrize("name,tensors", NAMED_CASES, ids=[c[0] for c in NAMED_CASES])
def test_protocol_codecs_match_jax(name, tensors):
    rows, jrows = protocol.rows_from_named(tensors), jprotocol.rows_from_named(tensors)
    assert len(rows) == len(jrows)
    for r, jr in zip(rows, jrows):
        if isinstance(jr, dict):
            assert r.keys() == jr.keys()
            for k in jr:
                np.testing.assert_array_equal(r[k], jr[k])
        else:
            np.testing.assert_array_equal(r, jr)
    body = {"inputs": [protocol.InferTensor(k, v).to_v2() for k, v in tensors.items()]}
    assert body == {"inputs": [jprotocol.InferTensor(k, v).to_v2()
                               for k, v in tensors.items()]}
    dec, jdec = protocol.decode_v2(body), jprotocol.decode_v2(body)
    assert dec.keys() == jdec.keys()
    for k in dec:
        assert dec[k].dtype == jdec[k].dtype
        np.testing.assert_array_equal(dec[k], jdec[k])
    out = np.arange(6, dtype=np.int64).reshape(2, 3)
    for arg in (out, {"a": out, "b": out.astype(np.float32)}):
        assert protocol.encode_v2("m", arg) == jprotocol.encode_v2("m", arg)
    assert protocol.encode_v1(out) == jprotocol.encode_v1(out)
    assert protocol.decode_v1({"instances": [1]}) == jprotocol.decode_v1({"instances": [1]})


def test_protocol_errors_match_jax():
    bad = {"a": np.zeros((2, 3)), "b": np.zeros((3, 3))}
    for mod in (protocol, jprotocol):
        with pytest.raises(ValueError, match="batch dims disagree"):
            mod.rows_from_named(bad)
        with pytest.raises(ValueError, match="no input tensors"):
            mod.rows_from_named({})
        with pytest.raises(ValueError, match="'inputs'"):
            mod.decode_v2({})
        with pytest.raises(ValueError, match="'instances'"):
            mod.decode_v1({})
    bf16 = {"name": "x", "shape": [2], "datatype": "BF16", "data": [16256, 16384]}
    got = protocol.InferTensor.from_v2(bf16).data
    np.testing.assert_array_equal(got, jprotocol.InferTensor.from_v2(bf16).data)
    assert got.dtype == np.uint16


# ------------------------------------------------------------------ predictor

RAGGED = [
    {"input_ids": [1, 2, 3], "attention_mask": [1, 1]},
    {"input_ids": [1, 2, 3], "token_type_ids": [0, 0, 0, 1]},
    {"attention_mask": [1, 1]},
]


def test_ragged_rows_are_rejected_with_the_jax_message(weights):
    jrt, trt = _jax_runtime(), _torch_runtime(weights)
    for row in RAGGED:
        with pytest.raises(ValueError) as want:
            jrt.preprocess({"instances": [row]})
        with pytest.raises(ValueError) as got:
            trt.preprocess({"instances": [row]})
        assert str(got.value) == str(want.value)
    for rt in (jrt, trt):
        with pytest.raises(ValueError, match="exceeds max bucket"):
            rt.predict(rt.preprocess({"instances": TEXTS * 2}))
        with pytest.raises(ValueError, match="exceeds max bucket"):
            rt.predict(rt.preprocess({"instances": [list(range(1, 40))]}))


PAYLOADS = [
    ("one_text", {"instances": TEXTS[:1]}),
    ("texts_bucket4", {"instances": TEXTS}),
    ("long_seq32", {"instances": [TEXTS[2]]}),
    ("ids_and_named", {"instances": [
        [101, 7, 8, 102],
        {"input_ids": [101, 7, 8, 9, 10, 11, 12, 102],
         "attention_mask": [1, 1, 1, 1, 0, 0, 0, 0]},
        {"input_ids": [101, 7, 8, 9, 10, 11, 12, 102],
         "token_type_ids": [0, 0, 0, 0, 1, 1, 1, 1]},
        {"text": "the [MASK] sat"}]}),
    ("v2_named", {"inputs": {
        "input_ids": np.array([[101, 5, 6, 7, 102], [101, 9, 9, 102, 0]], np.int32),
        "attention_mask": np.array([[1, 1, 1, 1, 1], [1, 1, 1, 1, 0]], np.int32)}}),
    ("v2_lone", {"inputs": {"input_ids": np.array([[101, 5, 6, 102]], np.int32)}}),
]


def test_predict_matches_jax_model_over_buckets(weights):
    """Every payload shape through both predictors' lifecycle: equal
    argmax rows, one per instance, each as long as its seq bucket."""
    jrt, trt = _jax_runtime(), _torch_runtime(weights)
    assert "compiles" not in trt.stats
    trt.warmup()  # every bucket, not counted as a request
    assert trt.stats["requests"] == 0
    for name, payload in PAYLOADS:
        want, got = _serve(jrt, payload), _serve(trt, payload)
        assert got == want, name
        n = len(TorchModel.payload_rows(payload))
        assert len(got["predictions"]) == n
        assert {len(r) for r in got["predictions"]} <= set(BUCKETS[1])
    assert trt.stats["requests"] == len(PAYLOADS) == len(trt.stats["predict_ms"])
    # a masked row's valid positions do not depend on what pads it
    alone = _serve(trt, {"instances": [{"input_ids": [101, 7, 8, 102]}]})
    beside = _serve(trt, {"instances": [{"input_ids": [101, 7, 8, 102]}, TEXTS[2]]})
    assert alone["predictions"][0][:4] == beside["predictions"][0][:4]


def test_mask_and_token_types_reach_the_model(weights):
    """The JAX ``tests/test_serve.py`` check through the runtime: a v2
    attention_mask and token_type_ids each change the answer."""
    trt = _torch_runtime(weights)
    ids = np.array([[101, 7, 8, 9, 10, 11, 12, 102]], np.int32)
    full = {"input_ids": ids, "attention_mask": np.ones((1, 8), np.int32)}
    half = {"input_ids": ids,
            "attention_mask": np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.int32)}
    tt = {**full, "token_type_ids": np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)}
    out = {k: trt.predict(trt.preprocess({"inputs": v}))
           for k, v in (("full", full), ("half", half), ("tt", tt))}
    assert not np.array_equal(out["full"], out["half"])
    assert not np.array_equal(out["full"], out["tt"])


def test_out_of_range_ids_are_rejected(weights):
    trt = _torch_runtime(weights)
    with pytest.raises(ValueError, match=r"input_ids must lie in \[0, 1024\)"):
        trt.preprocess({"instances": [[101, 1024]]})
    with pytest.raises(ValueError, match="input_ids must lie"):
        trt.preprocess({"instances": [[-1, 5]]})
    with pytest.raises(ValueError, match=r"token_type_ids must lie in \[0, 2\)"):
        trt.preprocess({"instances": [{"input_ids": [1, 2], "token_type_ids": [0, 2]}]})
    with pytest.raises(ValueError, match="empty request"):
        trt.preprocess({"instances": []})


# -------------------------------------------------------------------- batcher

def _until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition not reached"
        time.sleep(0.002)


def _submit_in_thread(b, instances, **kw):
    box = {}

    def run():
        try:
            box["out"] = b.submit(instances, **kw)
        except Exception as e:  # noqa: BLE001 — read by the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def test_batcher_flushes_by_size_and_by_latency():
    calls = []

    def handler(flat):
        calls.append(list(flat))
        return [x * 10 for x in flat]

    b = Batcher(handler, BatcherConfig(max_batch_size=4, max_latency_ms=60_000))
    try:
        threads = [_submit_in_thread(b, [i]) for i in range(3)]
        _until(lambda: b.queue_depth == 3)
        assert calls == []  # under the size and far from the latency
        assert b.submit([3]) == [30]
        for t, box in threads:
            t.join(10)
            assert not t.is_alive()
        assert sorted(box["out"][0] for _, box in threads) == [0, 10, 20]
        assert len(calls) == 1 and sorted(calls[0]) == [0, 1, 2, 3]
    finally:
        b.close()
    b = Batcher(handler, BatcherConfig(max_batch_size=100, max_latency_ms=30))
    try:
        t0 = time.monotonic()
        assert b.submit([7, 8]) == [70, 80]
        assert time.monotonic() - t0 >= 0.03
        assert calls[-1] == [7, 8] and b.stats["batches"] == 1
    finally:
        b.close()


def test_batcher_splits_like_the_jax_batcher():
    """An oversize submit is split into handler calls of at most
    max_batch_size; outputs, stats and occupancy equal the JAX
    batcher's."""
    cfg = dict(max_batch_size=3, max_latency_ms=5)
    sizes, jsizes = [], []

    def handler(flat):
        sizes.append(len(flat))
        return [x + 1 for x in flat]

    async def jhandler(flat):
        jsizes.append(len(flat))
        return [x + 1 for x in flat]

    b = Batcher(handler, BatcherConfig(**cfg))
    jb = jbatcher.Batcher(jhandler, jbatcher.BatcherConfig(**cfg))
    try:
        for n in (7, 1, 3):
            want = asyncio.run(jb.submit(list(range(n))))
            assert b.submit(list(range(n))) == want == [x + 1 for x in range(n)]
    finally:
        b.close()
    assert sizes == jsizes == [3, 3, 1, 1, 3]
    assert b.stats == jb.stats
    assert b.mean_occupancy == jb.mean_occupancy == 11 / 5


def test_batcher_isolates_a_failing_caller():
    def handler(flat):
        if any(x < 0 for x in flat):
            raise ValueError("negative instance")
        return [x * 2 for x in flat]

    b = Batcher(handler, BatcherConfig(max_batch_size=8, max_latency_ms=200))
    try:
        (tg, good), (tb, bad) = (_submit_in_thread(b, [1, 2]),
                                 _submit_in_thread(b, [-1]))
        for t in (tg, tb):
            t.join(10)
            assert not t.is_alive()
        assert good == {"out": [2, 4]}
        assert isinstance(bad["err"], ValueError)
        assert b.stats["fail_isolations"] == 1
        assert b.stats["batches"] == 1 and b.stats["instances"] == 2
        with pytest.raises(ValueError, match="negative"):
            b.submit([-5])  # alone: its own error, no isolation
        assert b.stats["fail_isolations"] == 1
    finally:
        b.close()


def test_batcher_sheds_expired_entries_and_runs_handler_outside_the_lock():
    release, entered = threading.Event(), threading.Event()
    calls = []

    def handler(flat):
        calls.append(list(flat))
        if flat == ["block"]:
            entered.set()
            assert release.wait(10)
        return flat

    key = (("stage", "batch_queue"),)
    child = dl.DEADLINE_EXPIRED._children.get(key)
    c0 = child.value if child else 0.0
    b = Batcher(handler, BatcherConfig(max_batch_size=8, max_latency_ms=1))
    try:
        t1, box1 = _submit_in_thread(b, ["block"])
        assert entered.wait(10)
        # the handler is running: a new submit still queues (no lock held)
        t2, box2 = _submit_in_thread(b, ["late"], deadline=time.monotonic() + 0.02)
        t3, box3 = _submit_in_thread(b, ["fine"], deadline=time.monotonic() + 60)
        _until(lambda: b.queue_depth == 2)
        time.sleep(0.05)  # "late" expires while it waits for the flush
        release.set()
        for t in (t1, t2, t3):
            t.join(10)
            assert not t.is_alive()
        assert box1 == {"out": ["block"]} and box3 == {"out": ["fine"]}
        assert isinstance(box2["err"], dl.DeadlineExceeded)
        assert box2["err"].stage == "batch_queue"
        assert calls == [["block"], ["fine"]]  # the expired entry cost nothing
        assert b.stats["deadline_shed"] == 1
        assert dl.DEADLINE_EXPIRED._children[key].value == c0 + 1
    finally:
        release.set()
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit([1])


# ----------------------------------------------------------------- over HTTP

class _JaxReplica:
    """A JAX ``ModelServer`` on an ephemeral port, its event loop on a
    thread of its own."""

    def __init__(self, models, **kw):
        self.models = models
        self.server = jserver.ModelServer(models, **kw)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def up():
            runner = web.AppRunner(self.server.build_app())
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return runner, site._server.sockets[0].getsockname()[1]

        self.runner, self.port = asyncio.run_coroutine_threadsafe(
            up(), self.loop).result(60)

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(
                self.runner.cleanup(), self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()
            for m in self.models:
                m.unload()


def _call(port, method, path, body=None, headers=None):
    """``(status, headers, body bytes)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _v2(ids, mask=None, dtype="INT32"):
    ids = np.asarray(ids)
    inputs = [{"name": "input_ids", "shape": list(ids.shape), "datatype": dtype,
               "data": ids.reshape(-1).tolist()}]
    if mask is not None:
        mask = np.asarray(mask)
        inputs.append({"name": "attention_mask", "shape": list(mask.shape),
                       "datatype": "INT32", "data": mask.reshape(-1).tolist()})
    return {"inputs": inputs}


#: (method, path, body): the same requests to the JAX and the port's server
REQUESTS = [
    ("POST", "/v1/models/bert:predict", {"instances": TEXTS[:2]}),
    ("POST", "/v1/models/bert:predict", {"instances": [TEXTS[2]]}),
    ("POST", "/v1/models/bert:predict", {"instances": [
        {"input_ids": [101, 7, 8, 9, 102], "attention_mask": [1, 1, 1, 0, 0]},
        [101, 4, 102]]}),
    ("POST", "/v2/models/bert/infer", _v2([[101, 7, 8, 9, 102]], [[1, 1, 1, 1, 1]])),
    ("POST", "/v2/models/bert/infer",
     _v2([[101, 7, 8, 9, 102], [101, 3, 102, 0, 0]], [[1] * 5, [1, 1, 1, 0, 0]])),
    ("POST", "/v2/models/bert/infer", _v2([[101, 5, 6, 102]], dtype="INT64")),
    ("POST", "/v2/models/bert/infer", {"inputs": []}),            # 400
    ("POST", "/v2/models/bert/infer", {"nothing": 1}),            # 400
    ("POST", "/v2/models/bert/infer", b"{not json"),              # 400
    ("POST", "/v2/models/bert/infer", {"inputs": [               # 400: shape
        {"name": "input_ids", "shape": [2, 3], "datatype": "INT32",
         "data": [1, 2, 3]}]}),
    ("POST", "/v1/models/bert:predict", {"instances": [           # 400: ragged
        {"input_ids": [1, 2, 3], "attention_mask": [1, 1]}]}),
    ("POST", "/v1/models/bert:predict", {"rows": []}),             # 400
    ("POST", "/v1/models/nope:predict", {"instances": ["x"]}),     # 404
    ("POST", "/v2/models/nope/infer", _v2([[1, 2]])),              # 404
]

BATCHER_NAMES = ("kft_server_queue_depth", "kubeflow_tpu_batcher_")


def _batcher_lines(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(BATCHER_NAMES) and 'model="bert"' in ln)


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batcher"])
def test_http_predict_and_infer_match_the_jax_server(batched, weights):
    """Every request of ``REQUESTS`` gets the JAX server's status and, on
    a 200, its JSON body; ``/metrics`` carries the same batcher series
    (none without a batcher)."""
    cfg = dict(max_batch_size=16, max_latency_ms=5) if batched else None
    jrep = _JaxReplica([_jax_runtime()], batcher=cfg and jbatcher.BatcherConfig(**cfg))
    tsrv = ModelServer([_torch_runtime(weights)], http_port=0,
                       batcher=cfg and BatcherConfig(**cfg)).start()
    try:
        if batched:  # clamped to the top batch bucket, as in JAX
            assert tsrv.batchers["bert"].config.max_batch_size == BUCKETS[0][-1]
        for method, path, body in REQUESTS:
            js, _, jraw = _call(jrep.port, method, path, body)
            ts, _, traw = _call(tsrv.port, method, path, body)
            assert ts == js, (path, body, traw)
            if js == 200:
                assert json.loads(traw) == json.loads(jraw), (path, body)
        _, _, jm = _call(jrep.port, "GET", "/metrics")
        _, _, tm = _call(tsrv.port, "GET", "/metrics")
        want = _batcher_lines(jm.decode())
        assert _batcher_lines(tm.decode()) == want
        assert bool(want) == batched
    finally:
        tsrv.stop()
        jrep.close()


def test_http_batcher_shed_and_isolation_match_the_jax_server(weights):
    """Through a batcher with a 300 ms window: a request whose deadline
    ends inside the window is shed from the batch queue (503 with
    Retry-After: 1); a ragged row co-batched with a good one fails alone
    (400 and 200), and both servers count one fail isolation."""
    cfg = dict(max_batch_size=4, max_latency_ms=300)
    jrep = _JaxReplica([_jax_runtime()], batcher=jbatcher.BatcherConfig(**cfg))
    tsrv = ModelServer([_torch_runtime(weights)], http_port=0,
                       batcher=BatcherConfig(**cfg)).start()
    key = (("stage", "batch_queue"),)
    child = dl.DEADLINE_EXPIRED._children.get(key)
    c0 = child.value if child else 0.0
    try:
        for port in (jrep.port, tsrv.port):
            status, headers, _ = _call(port, "POST", "/v1/models/bert:predict",
                                       {"instances": ["late"]},
                                       {"x-kft-deadline-ms": "60"})
            assert status == 503 and headers.get("retry-after") == "1"
            results = [None, None]

            def post(i, body, port=port):
                results[i] = _call(port, "POST", "/v1/models/bert:predict", body)[0]

            threads = [threading.Thread(target=post, args=(0, {"instances": [TEXTS[0]]})),
                       threading.Thread(target=post, args=(1, {"instances": [
                           {"input_ids": [1, 2, 3], "attention_mask": [1]}]}))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
                assert not t.is_alive()
            assert results == [200, 400]
        assert tsrv.batchers["bert"].stats["deadline_shed"] == 1
        assert dl.DEADLINE_EXPIRED._children[key].value == c0 + 1
        _, _, jm = _call(jrep.port, "GET", "/metrics")
        _, _, tm = _call(tsrv.port, "GET", "/metrics")
        assert _batcher_lines(tm.decode()) == _batcher_lines(jm.decode())
        assert 'kubeflow_tpu_batcher_fail_isolations{model="bert"} 1' in tm.decode()
    finally:
        tsrv.stop()
        jrep.close()


# ---------------------------------------------------------- weights and CLI

def test_storage_path_fails_closed(tmp_path, weights):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a checkpoint")
    empty = tmp_path / "empty"
    empty.mkdir()
    odd = tmp_path / "odd"
    odd.mkdir()
    (odd / "notes.txt").write_text("x")
    wrong = tmp_path / "wrong.pt"
    torch.save({"encoder.embed.embedding": torch.zeros(3, 3)}, str(wrong))
    for path in (tmp_path / "missing", empty, odd, junk, wrong):
        m = BertRuntimeModel("bert", str(path), config=bert_tiny(), device="cpu")
        with pytest.raises(RuntimeError):
            m.load()
        assert not m.ready and m.module is None
    # a saved state serves what the state dict serves
    saved = tmp_path / "state.pt"
    torch.save(weights, str(saved))
    a = BertRuntimeModel("bert", str(saved), config=bert_tiny(),
                         buckets=BucketSpec(*BUCKETS), device="cpu")
    a.load()
    assert _serve(a, {"instances": TEXTS}) == _serve(_torch_runtime(weights),
                                                    {"instances": TEXTS})
    with pytest.raises(TypeError):
        BertRuntimeModel("bert", None, config=bert_tiny(), device="cpu", no_such=1)


def test_bert_serve_example_serves_and_fails_closed(tmp_path, monkeypatch, capsys):
    class _Stop:
        def Event(self):  # noqa: N802 — stands in for threading.Event
            class E:
                def wait(self):
                    raise KeyboardInterrupt

            return E()

    monkeypatch.setattr(bert_serve, "threading", _Stop())
    assert bert_serve.main(["--tiny", "--device", "cpu", "--port", "0"]) == 0
    out = capsys.readouterr().out
    assert "serving 'bert'" in out and "device=cpu" in out
    with pytest.raises(RuntimeError, match="does not exist"):
        bert_serve.main(["--model-dir", str(tmp_path / "missing"), "--tiny",
                         "--device", "cpu", "--port", "0"])
