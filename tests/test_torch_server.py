"""The port's stdlib ``ModelServer`` serving an ``LMEngineModel`` on CPU.

Concurrent ``/v2/models/lm/generate`` requests must come back with the
tokens the JAX ``LMEngine`` gives for the same prompts on the same
(bridged) weights, greedy, f32; the routes answer with the JAX server's
JSON shapes and status codes.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import TransformerLM as JaxLM
from kubeflow_tpu.serve.engine import LMEngine as JaxEngine
from kubeflow_tpu_torch.models.bridge import params_to_state_dict
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.serve.engine import EngineOverloaded, LMEngineModel
from kubeflow_tpu_torch.serve.generate import LMRuntimeModel
from kubeflow_tpu_torch.serve.model import BucketSpec, Model
from kubeflow_tpu_torch.serve.server import ModelServer

KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=128)
ENGINE = dict(max_batch=2, chunk_steps=4, kv_pool_tokens=16 * 12,
              page_size=16)
BUCKETS, MAX_NEW = (16, 32), 12


class _Overloaded(Model):
    def predict(self, inputs, headers=None):
        raise EngineOverloaded("full")


@pytest.fixture(scope="module")
def served():
    jcfg = JaxConfig(**KW, attn_impl="reference", dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    lm = LMEngineModel(
        "lm", config=TransformerConfig(**KW),
        state_dict=params_to_state_dict(params), device="cpu",
        max_new_tokens=MAX_NEW, prefill_buckets=BUCKETS, eos_id=1, **ENGINE,
    )
    clm = LMRuntimeModel(
        "clm", config=TransformerConfig(**KW),
        state_dict=params_to_state_dict(params), device="cpu",
        buckets=BucketSpec(batch_sizes=(1,), seq_lens=BUCKETS), max_new_tokens=4,
    )
    server = ModelServer([lm, clm, _Overloaded("busy")], http_port=0).start()
    try:
        yield server, (jmodel, jcfg, params)
    finally:
        server.stop()


def _call(server, method, path, body=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_concurrent_generate_matches_jax_engine(served):
    server, (jmodel, jcfg, params) = served
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, KW["vocab_size"], size=n)]
               for n in (6, 13, 21, 30)]
    with ThreadPoolExecutor(4) as ex:
        replies = list(ex.map(
            lambda p: _call(server, "POST", "/v2/models/lm/generate",
                            {"input_ids": p, "max_new_tokens": MAX_NEW}),
            prompts,
        ))
    jeng = JaxEngine(jmodel, jcfg, params, max_seq=max(BUCKETS) + MAX_NEW,
                     prefill_buckets=BUCKETS, eos_id=1, pipeline_depth=0,
                     **ENGINE).start()
    try:
        want = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    finally:
        jeng.stop()
    assert [status for status, _ in replies] == [200] * 4
    assert [body for _, body in replies] == [{"token_ids": w} for w in want]


def test_v1_predict_and_health(served):
    server, _ = served
    assert _call(server, "GET", "/v2/health/ready") == (
        200, {"ready": True, "role": "both"})
    status, body = _call(server, "POST", "/v1/models/lm:predict", {
        "instances": [{"input_ids": [5, 9, 11], "max_new_tokens": 3},
                      [7, 8, 9, 10]],
    })
    assert status == 200 and len(body["predictions"]) == 2
    assert 1 <= len(body["predictions"][0]["token_ids"]) <= 3
    assert 1 <= len(body["predictions"][1]["token_ids"]) <= MAX_NEW


@pytest.mark.parametrize("method,path,body,status,key", [
    ("POST", "/v2/models/nope/generate", {"input_ids": [3]}, 404, "error"),
    ("POST", "/v2/models/lm/generate", b"{not json", 400, "error"),
    ("POST", "/v2/models/lm/generate", {"input_ids": []}, 400, "error"),
    # text goes through the tokenizer (tests/test_torch_generate.py holds
    # its ids against JAX's)
    ("POST", "/v2/models/lm/generate", {"text": "hello"}, 200, "token_ids"),
    ("POST", "/v1/models/lm:predict", {"rows": []}, 400, "error"),
    ("POST", "/v2/models/busy/generate", {"input_ids": [3]}, 429, "error"),
    ("GET", "/nowhere", None, 404, "error"),
    # a causal-lm runtime generates but does not stream, as in JAX
    ("POST", "/v2/models/clm/generate", {"text": "hello"}, 200, "token_ids"),
    ("POST", "/v2/models/clm/generate_stream", {"input_ids": [3]}, 501, "error"),
], ids=["unknown_model", "bad_json", "empty_prompt", "text_prompt",
        "v1_no_instances", "overloaded", "unknown_route", "causal_lm_generate",
        "causal_lm_stream"])
def test_error_statuses(served, method, path, body, status, key):
    server, _ = served
    got, payload = _call(server, method, path, body)
    assert got == status and key in payload


def test_request_logger_records_generate_and_streams(served):
    """The JAX server's logging on the engine routes: ``/generate`` is a
    request and a response event; a stream logs its request at admission
    and, when it ends, every token it sent with ``streamed`` and
    ``complete``. A second server over the fixture's engine carries the
    logger (``kill`` leaves the model loaded for the other tests)."""
    from kubeflow_tpu_torch.serve.logger import RequestLogger

    server, _ = served
    lg = RequestLogger()
    logged = ModelServer([server.models["lm"]], http_port=0, logger=lg).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{logged.port}/v2/models/lm/generate",
            data=json.dumps({"input_ids": [5, 9, 11]}).encode(),
            headers={"Content-Type": "application/json", "x-request-id": "g-1"})
        with urllib.request.urlopen(req, timeout=60) as r:
            generated = json.loads(r.read())
        req = urllib.request.Request(
            f"http://127.0.0.1:{logged.port}/v2/models/lm/generate_stream",
            data=json.dumps({"input_ids": [5, 9, 11]}).encode(),
            headers={"Content-Type": "application/json", "x-request-id": "s-1"})
        with urllib.request.urlopen(req, timeout=60) as r:
            frames = [json.loads(ln[6:]) for ln in r.read().decode().splitlines()
                      if ln.startswith("data: ")]
        # the stream's response event is logged after its last chunk is
        # written, so the client can read it all first: wait, bounded
        ev = threading.Event()
        for _ in range(6000):
            if len(lg.entries) >= 4:
                break
            ev.wait(0.01)
    finally:
        logged.kill()
    streamed = [t for f in frames for t in f.get("token_ids", [])]
    assert frames[-1] == {"done": True, "n_tokens": len(streamed)}
    assert streamed == generated["token_ids"]  # greedy: the same tokens
    events = [(e["type"].rsplit(".", 1)[1], e["requestid"], e["data"])
              for e in lg.entries]
    assert events == [
        ("request", "g-1", {"instances": [{"input_ids": [5, 9, 11]}]}),
        ("response", "g-1", {"predictions": [generated]}),
        ("request", "s-1", {"instances": [{"input_ids": [5, 9, 11]}]}),
        ("response", "s-1", {"predictions": [{"token_ids": streamed}],
                             "streamed": True, "complete": True}),
    ]
