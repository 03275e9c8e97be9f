"""HTTP model server on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection): the JAX
``serve/server.py`` ``DataPlane`` and ``ModelServer`` contract for an LM
replica, with the same routes, JSON shapes, status codes and metric
lines.

- ``GET  /`` → ``{"status": "alive"}``; ``GET /v2/health/live``
- ``GET  /v2/health/ready`` → ``{"ready": bool, "role": role}`` (503
  with ``"draining": true`` once :meth:`ModelServer.stop` began)
- ``GET  /v1/models``, ``/v1/models/{m}``, ``/v2/models/{m}`` (metadata,
  ``"platform": "torch-cuda"``)
- ``POST /v1/models/{m}:predict`` ``{"instances": [...]}`` →
  ``{"predictions": [...]}``
- ``POST /v1/models/{m}:explain`` ``{"instances": [...]}`` →
  ``{"explanations": [...]}`` from the model's ``explain`` (501 for a
  model without an explainer, as in JAX)
- ``POST /v2/models/{m}/infer`` ``{"inputs": [{name, shape, datatype,
  data}]}`` → ``{"model_name", "outputs": [...]}`` (``serve/protocol.py``;
  named tensors become per-instance rows, so ``attention_mask`` and
  ``token_type_ids`` reach the model, and a lone tensor's rows reach a
  tabular model as its ``(batch, features)`` matrix)
- ``POST /v2/models/{m}/generate`` (one row) → ``{"token_ids": [...]}``,
  from an engine model or a ``causal-lm`` runtime (``LMRuntimeModel``)
- ``POST /v2/models/{m}/generate_stream`` (engine models; 501 for a
  ``causal-lm`` runtime, as in JAX) → server-sent events: one
  ``data: {"token_ids": [...]}`` frame per chunk, then ``{"done": true,
  "n_tokens": n}``, or ``{"error": ..., "resumable": true}`` when the
  watchdog restarted the engine mid-stream (resend with
  ``x-kft-resume-tokens`` holding the tokens received)
- ``GET  /v2/models/{m}/prefix_cache`` → ``{"keys", "count", "tokens"}``
  of the stored prefix entries
- ``POST /v2/models/{m}/prefix_cache:export`` ``{"keys"?, "limit"?}`` →
  the entries as an npz body (``serve/kv_codec.py``)
- ``POST /v2/models/{m}/prefix_cache:pull`` ``{"peer", "keys"?}`` →
  ``{"imported", "peer"}``: the entries exported by ``peer``, imported
  here (502 when the peer fails)
- ``POST /v2/models/{m}/kv_span:prefill`` ``{"ids", "temperature",
  "seed"?}`` → the finished KV span of ``ids`` with its ``__meta__``, an
  npz body: the prefill replica's half of disaggregated serving
- ``GET  /v1/graphs`` → ``{"graphs": [...]}``; ``POST
  /v1/graphs/{g}:infer`` runs the InferenceGraph ``g``
  (:meth:`ModelServer.register_graph`, ``serve/graph.py``): 404 for an
  unknown graph, 400 for a bad body or a Switch no branch matches
- ``GET  /metrics`` → Prometheus text
- ``GET  /debug/traces`` (``limit`` 1–256, default 64;
  ``format=perfetto``) → the tail-sampled request traces
  (``obs/trace.py``), or their Chrome/Perfetto ``trace_event`` JSON

``role`` (``"both"``, ``"prefill"`` or ``"decode"``, the ``kft serve
--role`` split) is advertised by readiness; every replica answers every
route, and a gateway steers by the role. ``batcher`` (a
``BatcherConfig``) puts a dynamic batcher (``serve/batcher.py``) in
front of every model: ``:predict``, ``/infer`` and ``/generate`` rows
are coalesced across requests, up to the model's top batch bucket.
``logger`` (a ``serve/logger.py`` ``RequestLogger``) records a request
and a response CloudEvent for each ``:predict``, ``/infer``,
``/generate`` and graph step, and for each stream (its tokens, and
whether the client stayed to the end), under the request's
``x-request-id`` (or a fresh one) and its trace ids.

Request tracing: ``:predict``, ``/infer`` and ``/generate`` run under a
``dataplane`` span, ``/generate_stream`` under a ``dataplane.stream``
span; each continues the ``x-kft-trace`` context off the wire (or mints
a trace) and restamps the header, so the batcher's and the engine's spans
parent onto it. ``kv_span:prefill`` hands the caller's context to the
engine, so a shipped prefill lands in the decode replica's trace.

Request headers reach the model with lower-cased names. The deadline
contract is normalized once at admission (:meth:`ModelServer.
effective_headers`): a client's ``x-kft-deadline-abs`` is stripped, the
budget (``x-kft-deadline-ms``, else ``default_deadline_ms``) is stamped
as this process's absolute deadline, and an expired one fails at once.

Errors: malformed input 400, unknown model 404, an unported feature or a
model without an engine (or prefix cache) for a KV route 501,
``EngineOverloaded`` 429, ``AdmissionShed`` 503 with ``Retry-After`` =
ceil(its estimate), ``DeadlineExceeded`` 503 with ``Retry-After: 1``,
``EngineRestarting`` a bare 503 (retry elsewhere).
"""

from __future__ import annotations

import json
import math
import re
import socket
import sys
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kubeflow_tpu_torch.obs import names
from kubeflow_tpu_torch.obs import trace as _trace
from kubeflow_tpu_torch.obs.trace import (
    TPOT_MS,
    TRACER,
    TTFT_MS,
    ctx_from_headers,
    debug_traces,
)
from kubeflow_tpu_torch.serve.batcher import Batcher, BatcherConfig
from kubeflow_tpu_torch.serve.deadline import (
    DEADLINE_ABS_HEADER,
    DEADLINE_EXPIRED,
    AdmissionShed,
    DeadlineExceeded,
    deadline_from_headers,
)
from kubeflow_tpu_torch.serve.engine import (
    KV_SHIP_BYTES,
    KV_SHIP_MS,
    EngineOverloaded,
)
from kubeflow_tpu_torch.serve.headers import TRACE_HEADER
from kubeflow_tpu_torch.serve.kv_codec import decode_kv_entries, encode_kv_entries
from kubeflow_tpu_torch.serve.logger import RequestLogger
from kubeflow_tpu_torch.serve.model import Model, TorchModel
from kubeflow_tpu_torch.serve.protocol import decode_v2, encode_v2
from kubeflow_tpu_torch.serve.watchdog import EngineRestarting

_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_EXPLAIN = re.compile(r"^/v1/models/([^/:]+):explain$")
_INFER = re.compile(r"^/v2/models/([^/]+)/infer$")
_GENERATE = re.compile(r"^/v2/models/([^/]+)/generate$")
_GENERATE_STREAM = re.compile(r"^/v2/models/([^/]+)/generate_stream$")
_V1_MODEL = re.compile(r"^/v1/models/([^/:]+)$")
_V2_MODEL = re.compile(r"^/v2/models/([^/]+)$")
_PREFIX_INDEX = re.compile(r"^/v2/models/([^/]+)/prefix_cache$")
_PREFIX_EXPORT = re.compile(r"^/v2/models/([^/]+)/prefix_cache:export$")
_PREFIX_PULL = re.compile(r"^/v2/models/([^/]+)/prefix_cache:pull$")
_KV_SPAN_PREFILL = re.compile(r"^/v2/models/([^/]+)/kv_span:prefill$")
_GRAPH_INFER = re.compile(r"^/v1/graphs/([^/:]+):infer$")


class _HTTPError(Exception):
    def __init__(self, status: int, reason: str, headers: dict | None = None):
        super().__init__(reason)
        self.status, self.reason, self.headers = status, reason, headers or {}


def _error_status(e: Exception) -> tuple[int, dict]:
    """HTTP status and headers of an exception: the JAX server's
    ``_shed_response`` taxonomy, then the port's input errors."""
    if isinstance(e, _HTTPError):
        return e.status, e.headers
    if isinstance(e, AdmissionShed):
        return 503, {"Retry-After": str(math.ceil(e.retry_after_s))}
    if isinstance(e, DeadlineExceeded):
        return 503, {"Retry-After": "1"}
    if isinstance(e, EngineRestarting):
        return 503, {}
    if isinstance(e, EngineOverloaded):
        return 429, {}
    if isinstance(e, NotImplementedError):
        return 501, {}
    if isinstance(e, (ValueError, KeyError, TypeError)):
        return 400, {}
    traceback.print_exception(e)
    return 500, {}


def _span_status(e: BaseException) -> str:
    """Span terminal status for the error taxonomy: shed, deadline and
    poisoned statuses put the trace in the tail-sampler's keep pool."""
    if isinstance(e, DeadlineExceeded):
        return "deadline"
    if isinstance(e, (AdmissionShed, EngineOverloaded)):
        return "shed"
    if isinstance(e, EngineRestarting):
        return "poisoned"
    return "error"


def _end_failed(span, e: BaseException) -> None:
    if span:
        status = _span_status(e)
        if status == "error":
            span.set_attr("error", f"{type(e).__name__}: {e}")
        span.end(status)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    #: the listen backlog (socketserver's default is 5): a burst of
    #: concurrent clients must not have its connections dropped and
    #: retried by TCP while the accept loop spawns their threads
    request_queue_size = 128

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], ConnectionError):
            return  # a client that went away: nothing to report
        super().handle_error(request, client_address)


class _Stream:
    """A route's answer that is a token stream (sent as SSE), with its
    ``dataplane.stream`` span and the request id its logged events carry."""

    def __init__(self, name: str, it, span=None, req_id: str = ""):
        self.name, self.it, self.span = name, it, span
        self.req_id = req_id


class ModelServer:
    """Hosts ``Model``s over HTTP. ``http_port=0`` binds an ephemeral
    port; after :meth:`start` the bound port is ``self.port``.

    ``default_deadline_ms`` bounds requests that carry no
    ``x-kft-deadline-ms`` (KServe's request timeout). ``drain_grace_s``:
    on :meth:`stop`, readiness answers 503 first, then in-flight requests
    get this long to finish before the listener closes. ``role``: the
    replica's pool in disaggregated serving, reported by readiness.
    ``batcher``: a dynamic batcher in front of each model, its
    ``max_batch_size`` clamped to the model's top batch bucket.
    ``logger``: a ``RequestLogger`` for every inference's request and
    response events."""

    def __init__(self, models: list[Model], *, http_port: int = 8080,
                 host: str = "127.0.0.1", drain_grace_s: float = 10.0,
                 default_deadline_ms: float | None = None,
                 role: str = "both", batcher: BatcherConfig | None = None,
                 logger: RequestLogger | None = None):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode'; got {role!r}"
            )
        self.role = role
        self.logger = logger
        self.host, self.http_port = host, http_port
        self.drain_grace_s = drain_grace_s
        self.default_deadline_ms = default_deadline_ms
        self.port: int | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._draining = False
        #: requests currently executing, per model (streams included): the
        #: load signal, and what the drain waits on
        self.inflight: dict[str, int] = {}
        self.metrics: dict[str, dict] = {"requests_total": {}, "latency_ms": {}}
        self._lock = threading.Lock()  # guards inflight, metrics, _conns
        #: open client connections, for :meth:`kill`
        self._conns: set = set()
        self.models: dict[str, Model] = {}
        self.batchers: dict[str, Batcher] = {}
        self._graphs: dict = {}  # name -> serve/graph.py InferenceGraph
        for m in models:
            if not m.ready:
                m.load()
            self.models[m.name] = m
            if batcher is not None:
                self.batchers[m.name] = self._batcher_for(m, batcher)
            if hasattr(m, "add_restart_listener"):
                # a supervised restart fails all pre-restart work: the load
                # signal must restart with it
                m.add_restart_listener(
                    lambda name=m.name: self.reset_load_signals(name))

    def register_graph(self, spec) -> None:
        """Build a ``GraphSpec`` over this server's models, served at
        ``POST /v1/graphs/{name}:infer``. Every ``serviceName`` must be one
        of them (checked here, as admission)."""
        self._graphs[spec.name] = spec.build(self)

    def has(self, name: str) -> bool:
        """Whether a model of this name is served (the graph's dataplane
        surface)."""
        return name in self.models

    def infer(self, name: str, payload, headers: dict | None = None):
        """One payload through model ``name``'s whole predict path (the
        batcher, then preprocess, predict and postprocess), as a
        ``:predict`` request would take it: the graph's dataplane
        surface."""
        return self._infer(name, payload, dict(headers or {}))

    def _batcher_for(self, model: Model, cfg: BatcherConfig) -> Batcher:
        buckets = getattr(model, "buckets", None)
        if buckets is not None and cfg.max_batch_size > buckets.batch_sizes[-1]:
            # a chunk larger than the top bucket would fail every caller
            cfg = BatcherConfig(max_batch_size=buckets.batch_sizes[-1],
                                max_latency_ms=cfg.max_latency_ms)
        return Batcher(lambda flat, m=model: self._predict_flat(m, flat), cfg)

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "ModelServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet: no per-request stderr
                return

            def setup(self):
                super().setup()
                with server._lock:
                    server._conns.add(self.connection)

            def finish(self):
                with server._lock:
                    server._conns.discard(self.connection)
                super().finish()

            def do_GET(self):
                self._respond(server._get, self.path)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                headers = {k.lower(): v for k, v in self.headers.items()}
                self._respond(server._post, self.path, body, headers)

            def _respond(self, fn, *args):
                headers, ctype = {}, "application/json"
                try:
                    status, payload = fn(*args)
                except Exception as e:  # noqa: BLE001 — the server keeps serving
                    status, headers = _error_status(e)
                    reason = e.reason if isinstance(e, _HTTPError) else str(e)
                    if status == 500:
                        reason = f"{type(e).__name__}: {e}"
                    payload = {"error": reason}
                if isinstance(payload, _Stream):
                    server._send_stream(self, payload)
                    return
                if isinstance(payload, str):
                    data, ctype = payload.encode(), "text/plain; version=0.0.4"
                elif isinstance(payload, bytes):
                    data, ctype = payload, "application/octet-stream"
                else:
                    data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

        self._httpd = _HTTPServer((self.host, self.http_port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="model-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful drain: readiness goes 503 first (balancers stop
        sending), in-flight work gets ``drain_grace_s`` to finish, then
        the listener closes, the batchers stop and the models unload."""
        self._draining = True
        deadline = time.monotonic() + self.drain_grace_s
        while self.total_inflight() > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        for b in self.batchers.values():
            b.close()
        for m in self.models.values():
            m.unload()

    def kill(self) -> None:
        """Die as a killed replica would: every open connection is shut
        down at once, mid-frame if a stream is writing, and the listener
        closes, with no drain. The models stay loaded (a new server over
        them can take this one's place). A chaos harness's in-process
        stand-in for SIGKILL."""
        with self._lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()

    # -- load signals ------------------------------------------------------- #

    def total_inflight(self) -> int:
        with self._lock:
            return sum(self.inflight.values())

    def reset_load_signals(self, name: str) -> None:
        """Zero a model's in-flight count after a supervised engine
        restart; requests poisoned by it unwind afterwards, and their
        decrements clamp at zero."""
        with self._lock:
            self.inflight[name] = 0

    def _enter(self, name: str) -> None:
        with self._lock:
            self.inflight[name] = self.inflight.get(name, 0) + 1

    def _leave(self, name: str, t0: float | None) -> None:
        """One request of ``name`` left; ``t0`` (its start) counts it
        served, with its latency."""
        with self._lock:
            self.inflight[name] = max(0, self.inflight.get(name, 0) - 1)
            if t0 is not None:
                m = self.metrics
                m["requests_total"][name] = m["requests_total"].get(name, 0) + 1
                m["latency_ms"].setdefault(name, deque(maxlen=4096)).append(
                    (time.perf_counter() - t0) * 1e3)

    # -- the deadline contract ---------------------------------------------- #

    def effective_headers(self, headers: dict | None) -> tuple[dict, float | None]:
        """Normalize the deadline contract once at admission: strip a
        client's absolute stamp (another process's clock), parse the wire
        budget or apply ``default_deadline_ms``, stamp this process's
        absolute deadline, and fail an expired one before it costs
        anything."""
        headers = dict(headers or {})
        headers.pop(DEADLINE_ABS_HEADER, None)
        headers.pop(DEADLINE_ABS_HEADER.title(), None)
        deadline = deadline_from_headers(headers)
        if deadline is None and self.default_deadline_ms is not None:
            deadline = time.monotonic() + self.default_deadline_ms / 1e3
        if deadline is not None:
            headers[DEADLINE_ABS_HEADER] = repr(deadline)
            if deadline - time.monotonic() <= 0:
                DEADLINE_EXPIRED.labels(stage="admission").inc()
                raise DeadlineExceeded(
                    "deadline already expired at the dataplane",
                    stage="admission",
                )
        return headers, deadline

    # -- routes ------------------------------------------------------------- #

    def _model(self, name: str) -> Model:
        model = self.models.get(name)
        if model is None:
            raise _HTTPError(404, f"model '{name}' not found")
        return model

    def _get(self, path: str):
        if path == "/":
            return 200, {"status": "alive"}
        if path == "/v2/health/live":
            return 200, {"live": True}
        if path == "/v2/health/ready":
            if self._draining:
                return 503, {"ready": False, "draining": True, "role": self.role}
            ready = all(m.ready for m in self.models.values())
            return 200, {"ready": ready, "role": self.role}
        if path == "/v1/models":
            return 200, {"models": sorted(self.models)}
        if path == "/v1/graphs":
            return 200, {"graphs": sorted(self._graphs)}
        if path == "/metrics":
            return 200, self._metrics_text()
        url = urllib.parse.urlsplit(path)
        if url.path == "/debug/traces":
            return 200, debug_traces(url.query)  # a bad limit: ValueError, 400
        if m := _PREFIX_INDEX.match(path):
            keys = self._prefix_engine(m.group(1)).prefix_index()
            return 200, {"keys": [list(k) for k in keys], "count": len(keys),
                         "tokens": sum(len(k) for k in keys)}
        if m := _V1_MODEL.match(path):
            model = self._model(m.group(1))
            return 200, {"name": model.name, "ready": model.ready}
        if m := _V2_MODEL.match(path):
            model = self._model(m.group(1))
            return 200, {"name": model.name, "ready": model.ready,
                         "platform": "torch-cuda"}
        raise _HTTPError(404, f"no route GET {path}")

    def _post(self, path: str, body: bytes, headers: dict[str, str]):
        if m := _PREDICT.match(path):
            payload = self._json(body)
            if not isinstance(payload, dict) or "instances" not in payload:
                raise _HTTPError(400, "v1 request must contain 'instances'")
            return 200, self._infer(m.group(1), payload, headers)
        if m := _EXPLAIN.match(path):
            payload = self._json(body)
            if not isinstance(payload, dict) or "instances" not in payload:
                raise _HTTPError(400, "v1 request must contain 'instances'")
            return 200, self._explain(m.group(1), payload, headers)
        if m := _INFER.match(path):
            return 200, self._v2_infer(m.group(1), body, headers)
        if m := _GENERATE.match(path):
            row = self._json(body)
            out = self._infer(m.group(1), {"instances": [row]}, headers)
            return 200, out["predictions"][0]
        if m := _GENERATE_STREAM.match(path):
            return 200, self._open_stream(m.group(1), body, headers)
        if m := _PREFIX_EXPORT.match(path):
            eng = self._prefix_engine(m.group(1))
            req = self._json(body) if body else {}
            if not isinstance(req, dict):
                raise _HTTPError(400, "export body must be a JSON object")
            return 200, encode_kv_entries(eng.export_prefix_entries(
                req.get("keys"), limit=req.get("limit")))
        if m := _PREFIX_PULL.match(path):
            return 200, self._prefix_pull(m.group(1), body)
        if m := _KV_SPAN_PREFILL.match(path):
            return 200, self._kv_span_prefill(m.group(1), body, headers)
        if m := _GRAPH_INFER.match(path):
            return 200, self._graph_infer(m.group(1), body)
        raise _HTTPError(404, f"no route POST {path}")

    @staticmethod
    def _json(body: bytes):
        try:
            return json.loads(body)
        except ValueError as e:
            raise _HTTPError(400, f"bad JSON: {e}") from None

    def _v2_infer(self, name: str, body: bytes, headers: dict[str, str]) -> dict:
        """``/infer``: a malformed body is a 400 before the model is
        touched; the answer is the predictions as one v2 tensor."""
        payload = self._json(body)
        try:
            tensors = decode_v2(payload)
            if not tensors:
                raise ValueError("v2 request has no input tensors")
        except Exception as e:  # noqa: BLE001 — any malformed body is a 400
            raise _HTTPError(400, f"bad v2 request: {e!r}") from None
        result = self._infer(name, {"inputs": tensors}, headers)
        preds = result["predictions"] if isinstance(result, dict) else result
        return encode_v2(name, np.asarray(preds))

    def _predict_flat(self, model: Model, flat: list) -> list:
        """The batcher's handler: one batch of rows through the model's
        lifecycle, one prediction a row."""
        out = model.postprocess(model.predict(model.preprocess({"instances": flat})))
        if isinstance(out, dict) and "predictions" in out:
            out = out["predictions"]
        out = list(out)
        if len(out) != len(flat):
            # a silent mismatch would slice wrong results back to callers
            raise RuntimeError(
                f"model '{model.name}' returned {len(out)} predictions "
                f"for {len(flat)} instances"
            )
        return out

    def _graph_infer(self, name: str, body: bytes):
        """``/v1/graphs/{name}:infer``: the JAX server's statuses: an
        unknown graph 404, a bad body or a ``ValueError`` (a Switch no
        branch matches) 400, a shed or unready model its own status, any
        other failure 500."""
        graph = self._graphs.get(name)
        if graph is None:
            raise _HTTPError(404, f"graph '{name}' not found")
        payload = self._json(body)
        try:
            return graph.infer(payload)
        except (ValueError, _HTTPError, AdmissionShed, DeadlineExceeded,
                EngineRestarting, EngineOverloaded):
            raise
        except Exception as e:  # noqa: BLE001 — a 500, as in the reference
            traceback.print_exception(e)
            raise _HTTPError(500, f"{type(e).__name__}: {e}") from e

    def _infer(self, name: str, payload, headers: dict[str, str]):
        model = self._model(name)
        if not model.ready:
            raise _HTTPError(503, f"model '{name}' not ready")
        if isinstance(payload, dict) and isinstance(payload.get("inputs"), dict):
            # v2 named tensors -> per-instance rows, so multi-input requests
            # batch correctly and keep attention_mask/token_type_ids
            payload = {"instances": TorchModel.payload_rows(payload)}
        headers, deadline = self.effective_headers(headers)
        # continue the wire context (gateway or client) or mint a trace for
        # direct traffic; the restamped header parents the engine spans
        span = TRACER.span("dataplane", ctx=ctx_from_headers(headers))
        req_id = headers.get("x-request-id") or str(uuid.uuid4())
        ctok = None
        if span:
            span.set_attr("model", name)
            span.set_attr("request_id", req_id)
            headers[TRACE_HEADER] = span.header()
            ctok = _trace.set_current(span)
        try:
            if self.logger is not None:
                self.logger.log_request(name, req_id, payload)
            t0 = time.perf_counter()
            self._enter(name)
            try:
                batcher = self.batchers.get(name)
                if (batcher is not None and isinstance(payload, dict)
                        and "instances" in payload):
                    result = {"predictions": batcher.submit(
                        list(payload["instances"]), deadline=deadline,
                        trace=span if span else None)}
                else:
                    result = model(payload, headers)
            except BaseException as e:
                self._leave(name, None)
                _end_failed(span, e)
                raise
            self._leave(name, t0)
            if self.logger is not None:
                self.logger.log_response(name, req_id, result)
        finally:
            if ctok is not None:
                _trace.reset_current(ctok)
        if span:
            span.end()
        return result

    def _explain(self, name: str, payload: dict, headers: dict[str, str]) -> dict:
        """``:explain``: the model's attributions, wrapped as
        ``{"explanations": ...}`` unless the model wrapped them."""
        model = self._model(name)
        if not model.ready:
            raise _HTTPError(503, f"model '{name}' not ready")
        out = model.explain(payload, headers)
        if isinstance(out, dict) and "explanations" in out:
            return out
        return {"explanations": out}

    def _open_stream(self, name: str, body: bytes, headers) -> _Stream:
        """Admit one streamed row EAGERLY: a shed, overload or expired
        deadline raises here and is answered with its status before any
        byte of a 200."""
        model = self._model(name)
        stream_rows = getattr(model, "stream_row_tokens", None)
        if stream_rows is None:
            raise _HTTPError(501, f"model '{name}' does not support streaming")
        if not model.ready:
            raise _HTTPError(503, f"model '{name}' not ready")
        doc = self._json(body)
        row = model.preprocess({"instances": [doc]})[0]
        # the stream's own dataplane span: continue the wire context or
        # mint one, restamped so the engine spans parent onto it
        span = TRACER.span("dataplane.stream", ctx=ctx_from_headers(headers))
        if span:
            span.set_attr("model", name)
        req_id = headers.get("x-request-id") or str(uuid.uuid4())
        if self.logger is not None:
            ctok = _trace.set_current(span) if span else None
            try:
                self.logger.log_request(name, req_id, {"instances": [doc]})
            finally:
                if ctok is not None:
                    _trace.reset_current(ctok)
        try:
            headers, _ = self.effective_headers(headers)
            if span:
                headers[TRACE_HEADER] = span.header()
            return _Stream(name, stream_rows(row, headers), span, req_id)
        except BaseException as e:
            _end_failed(span, e)
            raise

    # -- KV movement between replicas --------------------------------------- #

    def _prefix_engine(self, name: str):
        eng = getattr(self._model(name), "engine", None)
        if eng is None or not eng.prefix_cache_enabled:
            raise _HTTPError(501, f"model '{name}' has no prefix cache to transfer")
        return eng

    def _prefix_pull(self, name: str, body: bytes) -> dict:
        """Import the entries that ``peer`` exports into this replica's
        prefix cache: the new owner's side of a hash-ring remap."""
        eng = self._prefix_engine(name)
        req = self._json(body)
        try:
            peer = str(req["peer"]).rstrip("/")
            keys = req.get("keys")
        except (KeyError, TypeError, AttributeError) as e:
            raise _HTTPError(400, f"pull body needs a 'peer': {e!r}") from None
        export = urllib.request.Request(
            f"{peer}/v2/models/{name}/prefix_cache:export",
            data=json.dumps({"keys": keys} if keys is not None else {}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(export, timeout=120.0) as resp:
                blob = resp.read()
        except urllib.error.HTTPError as e:
            raise _HTTPError(502, f"peer export returned {e.code}") from None
        except (urllib.error.URLError, OSError) as e:
            raise _HTTPError(502, f"peer {peer} unreachable: {e}") from None
        entries, _ = decode_kv_entries(blob)
        return {"imported": eng.import_prefix_entries(entries), "peer": peer}

    def _kv_span_prefill(self, name: str, body: bytes, headers) -> bytes:
        """Prefill ``ids`` on this replica's engine and answer the
        finished span through the npz codec (``__meta__``: ``real_len``,
        ``first_tok``, ``valid``); the caller is a decode replica's
        ``fetch_kv_span``."""
        eng = getattr(self._model(name), "engine", None)
        if eng is None:
            raise _HTTPError(501, f"model '{name}' has no engine to prefill spans")
        req = self._json(body)
        try:
            ids = [int(t) for t in req["ids"]]
            temperature = float(req.get("temperature", 0.0))
            seed = req.get("seed")
            seed = None if seed is None else int(seed)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise _HTTPError(400, f"bad kv_span request: {e!r}") from None
        if not ids:
            raise _HTTPError(400, "empty ids")
        _, deadline = self.effective_headers(headers)
        # the decode replica's kv.ship context parents this engine's spans
        # under the same trace id
        tree, meta = eng.prefill_span(ids, temperature=temperature,
                                      deadline=deadline, seed=seed,
                                      trace=ctx_from_headers(headers))
        blob = encode_kv_entries([(tuple(ids), tree)], meta)
        KV_SHIP_BYTES.labels(model=name, direction="export").inc(len(blob))
        return blob

    def _send_stream(self, handler: BaseHTTPRequestHandler, s: _Stream) -> None:
        """Server-sent events over chunked transfer encoding, one frame per
        token chunk, flushed as it comes. A client that went away fails a
        write; closing the iterator then cancels its engine row."""

        def chunk(data: bytes) -> None:
            handler.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            handler.wfile.flush()

        def frame(payload: dict) -> None:
            chunk(f"data: {json.dumps(payload)}\n\n".encode())

        t0 = time.perf_counter()
        self._enter(s.name)
        total = 0
        streamed: list[int] = []
        gone = False
        ctok = _trace.set_current(s.span) if s.span else None
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            while True:
                try:
                    toks = next(s.it)
                except StopIteration:
                    end = {"done": True, "n_tokens": total}
                    break
                except Exception as e:  # noqa: BLE001 — sent as a frame
                    end = {"error": str(e)}
                    if isinstance(e, EngineRestarting):
                        # not terminal for the generation, only for this
                        # engine: resend with the tokens received so far
                        end["resumable"] = True
                    break
                toks = [int(t) for t in toks]
                total += len(toks)
                streamed.extend(toks)
                frame({"token_ids": toks})
            frame(end)
            chunk(b"")  # the terminating zero-length chunk
        except ConnectionError:
            handler.close_connection = True  # the client went away
            gone = True
        finally:
            s.it.close()
            self._leave(s.name, t0)
            if self.logger is not None:
                self.logger.log_response(
                    s.name, s.req_id,
                    {"predictions": [{"token_ids": streamed}],
                     "streamed": True, "complete": not gone})
            if s.span:
                s.span.set_attr("tokens_streamed", total)
                s.span.end("cancelled" if gone else None)
            if ctok is not None:
                _trace.reset_current(ctok)

    # -- /metrics ----------------------------------------------------------- #

    def _metrics_text(self) -> str:
        """The JAX server's ``/metrics`` lines for the parts the port has."""
        lines = []
        with self._lock:
            requests = dict(self.metrics["requests_total"])
            latency = {k: sorted(v) for k, v in self.metrics["latency_ms"].items()}
            inflight = dict(self.inflight)
        for name, n in requests.items():
            lines.append(f'{names.REQUESTS_TOTAL}{{model="{name}"}} {n}')
        for name, srt in latency.items():
            if srt:
                p50 = srt[len(srt) // 2]
                p99 = srt[min(len(srt) - 1, int(len(srt) * 0.99))]
                lines.append(f'{names.LATENCY_P50_MS}{{model="{name}"}} {p50:.3f}')
                lines.append(f'{names.LATENCY_P99_MS}{{model="{name}"}} {p99:.3f}')
        for name in sorted(self.models):
            lines.append(
                f'{names.SERVER_INFLIGHT}{{model="{name}"}} {inflight.get(name, 0)}')
        for name, b in sorted(self.batchers.items()):
            lines.append(f'{names.SERVER_QUEUE_DEPTH}{{model="{name}"}} '
                         f'{b.queue_depth}')
        for name, b in sorted(self.batchers.items()):
            label = f'{{model="{name}"}}'
            lines += [
                f'{names.BATCHER_BATCHES}{label} {b.stats["batches"]}',
                f'{names.BATCHER_INSTANCES}{label} {b.stats["instances"]}',
                f'{names.BATCHER_MEAN_OCCUPANCY}{label} {b.mean_occupancy:.3f}',
                f'{names.BATCHER_FAIL_ISOLATIONS}{label} '
                f'{b.stats["fail_isolations"]}',
            ]
        for name in sorted(self.models):
            model = self.models[name]
            eng = getattr(model, "engine", None)
            if eng is not None:
                lines.extend(_engine_lines(name, eng))
            wd = getattr(model, "watchdog", None)
            if wd is not None:
                for reason, n in sorted(wd.stats["trips"].items()):
                    lines.append(f'{names.ENGINE_WATCHDOG_TRIPS_TOTAL}'
                                 f'{{model="{name}",reason="{reason}"}} {n}')
                lines.append(f'{names.ENGINE_RESTARTS_TOTAL}{{model="{name}"}} '
                             f'{wd.stats["restarts"]}')
        lines.extend(TTFT_MS.expose())
        lines.extend(TPOT_MS.expose())
        lines.extend(KV_SHIP_BYTES.expose())
        lines.extend(KV_SHIP_MS.expose())
        return "\n".join(lines) + "\n"


def _engine_lines(name: str, eng) -> list[str]:
    """An engine's scheduler stats, active rows, overlap gauges, spec and
    prefix counters (transfers included), host-tier occupancy and, for a
    paged engine, pager stats, read-path flag and int8 error."""
    label = f'{{model="{name}"}}'
    lines = [f"{names.ENGINE_PREFIX}{key}{label} {val}"
             for key, val in dict(eng.stats).items()]  # snapshot: the loop writes
    lines.append(f"{names.ENGINE_ACTIVE_ROWS}{label} {int(eng.active.sum())}")
    ov = dict(eng.overlap)
    lines += [
        f'{names.ENGINE_DECODE_GAP_MS}{label} {ov["decode_gap_ms"]:.3f}',
        f'{names.ENGINE_D2H_DRAIN_MS}{label} {ov["d2h_drain_ms"]:.3f}',
        f'{names.ENGINE_CARRY_UPLOADS_TOTAL}{label} {ov["carry_uploads"]}',
        f'{names.ENGINE_SLOT_OCCUPANCY}{label} {ov["slot_occupancy"]:.3f}',
        f'{names.ENGINE_SPEC_ACCEPTANCE}{label} {ov["spec_acceptance"]:.3f}',
        f'{names.ENGINE_SPEC_PROPOSED_TOTAL}{label} {eng.stats["spec_proposed"]}',
        f'{names.ENGINE_SPEC_ACCEPTED_TOTAL}{label} {eng.stats["spec_accepted"]}',
    ]
    pc = eng.prefix_cache_stats()
    lines += [
        f'{names.ENGINE_PREFIX_HITS_TOTAL}{label} {pc["hits"]}',
        f'{names.ENGINE_PREFIX_TOKENS_REUSED_TOTAL}{label} {pc["tokens_reused"]}',
        f'{names.ENGINE_PREFIX_ENTRIES}{label} {pc["entries"]}',
        f'{names.ENGINE_PREFIX_TOKENS_STORED}{label} {pc["tokens_stored"]}',
        f'{names.ENGINE_PREFIX_IMPORTED_TOTAL}{label} {pc["imported"]}',
        f'{names.ENGINE_PREFIX_EXPORTED_TOTAL}{label} {pc["exported"]}',
    ]
    tier = getattr(eng, "host_kv_tier", None)
    if tier is not None:
        res = tier.resident()
        lines += [f'{names.ENGINE_KV_OFFLOAD_BYTES}{label} {res["bytes"]}',
                  f'{names.ENGINE_KV_OFFLOAD_RESIDENT_ROWS}{label} {res["rows"]}']
    if eng.pager is not None:  # paged engines: pool pressure, read path
        lines += [f"{names.ENGINE_KV_PREFIX}{key}{label} {val}"
                  for key, val in eng.pager.stats().items()]
        lines.append(f"{names.ENGINE_PAGED_ATTN_KERNEL}{label} "
                     f"{int(eng.paged_attn_impl == 'kernel')}")
        if "kv_quant_error" in ov:
            lines.append(f'{names.ENGINE_KV_QUANT_ERROR}{label} '
                         f'{ov["kv_quant_error"]:.6f}')
    return lines
