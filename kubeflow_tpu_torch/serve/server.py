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
- ``GET  /metrics`` → Prometheus text

``role`` (``"both"``, ``"prefill"`` or ``"decode"``, the ``kft serve
--role`` split) is advertised by readiness; every replica answers every
route, and a gateway steers by the role.

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
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeflow_tpu_torch.obs import names
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
    TPOT_MS,
    TTFT_MS,
    EngineOverloaded,
)
from kubeflow_tpu_torch.serve.kv_codec import decode_kv_entries, encode_kv_entries
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.watchdog import EngineRestarting

_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_GENERATE = re.compile(r"^/v2/models/([^/]+)/generate$")
_GENERATE_STREAM = re.compile(r"^/v2/models/([^/]+)/generate_stream$")
_V1_MODEL = re.compile(r"^/v1/models/([^/:]+)$")
_V2_MODEL = re.compile(r"^/v2/models/([^/]+)$")
_PREFIX_INDEX = re.compile(r"^/v2/models/([^/]+)/prefix_cache$")
_PREFIX_EXPORT = re.compile(r"^/v2/models/([^/]+)/prefix_cache:export$")
_PREFIX_PULL = re.compile(r"^/v2/models/([^/]+)/prefix_cache:pull$")
_KV_SPAN_PREFILL = re.compile(r"^/v2/models/([^/]+)/kv_span:prefill$")


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


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], ConnectionError):
            return  # a client that went away: nothing to report
        super().handle_error(request, client_address)


class _Stream:
    """A route's answer that is a token stream (sent as SSE)."""

    def __init__(self, name: str, it):
        self.name, self.it = name, it


class ModelServer:
    """Hosts ``Model``s over HTTP. ``http_port=0`` binds an ephemeral
    port; after :meth:`start` the bound port is ``self.port``.

    ``default_deadline_ms`` bounds requests that carry no
    ``x-kft-deadline-ms`` (KServe's request timeout). ``drain_grace_s``:
    on :meth:`stop`, readiness answers 503 first, then in-flight requests
    get this long to finish before the listener closes. ``role``: the
    replica's pool in disaggregated serving, reported by readiness."""

    def __init__(self, models: list[Model], *, http_port: int = 8080,
                 host: str = "127.0.0.1", drain_grace_s: float = 10.0,
                 default_deadline_ms: float | None = None,
                 role: str = "both"):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode'; got {role!r}"
            )
        self.role = role
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
        self._lock = threading.Lock()  # guards inflight and metrics
        self.models: dict[str, Model] = {}
        for m in models:
            if not m.ready:
                m.load()
            self.models[m.name] = m
            if hasattr(m, "add_restart_listener"):
                # a supervised restart fails all pre-restart work: the load
                # signal must restart with it
                m.add_restart_listener(
                    lambda name=m.name: self.reset_load_signals(name))

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "ModelServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet: no per-request stderr
                return

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
        the listener closes and the models unload."""
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
        for m in self.models.values():
            m.unload()

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
        if path == "/metrics":
            return 200, self._metrics_text()
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
        raise _HTTPError(404, f"no route POST {path}")

    @staticmethod
    def _json(body: bytes):
        try:
            return json.loads(body)
        except ValueError as e:
            raise _HTTPError(400, f"bad JSON: {e}") from None

    def _infer(self, name: str, payload: dict, headers: dict[str, str]) -> dict:
        model = self._model(name)
        if not model.ready:
            raise _HTTPError(503, f"model '{name}' not ready")
        headers, _ = self.effective_headers(headers)
        t0 = time.perf_counter()
        self._enter(name)
        try:
            result = model(payload, headers)
        except BaseException:
            self._leave(name, None)
            raise
        self._leave(name, t0)
        return result

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
        row = model.preprocess({"instances": [self._json(body)]})[0]
        headers, _ = self.effective_headers(headers)
        return _Stream(name, stream_rows(row, headers))

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
        tree, meta = eng.prefill_span(ids, temperature=temperature,
                                      deadline=deadline, seed=seed)
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
                frame({"token_ids": toks})
            frame(end)
            chunk(b"")  # the terminating zero-length chunk
        except ConnectionError:
            handler.close_connection = True  # the client went away
        finally:
            s.it.close()
            self._leave(s.name, t0)

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
