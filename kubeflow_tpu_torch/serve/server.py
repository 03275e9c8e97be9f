"""Minimal HTTP model server on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection).

Serves the routes of ``kubeflow_tpu/serve/server.py`` that an LM replica
needs, with the same JSON shapes:

- ``GET  /v2/health/ready`` → ``{"ready": bool, "role": "both"}``
- ``POST /v1/models/{m}:predict`` ``{"instances": [...]}`` →
  ``{"predictions": [...]}``
- ``POST /v2/models/{m}/generate`` (one row) → ``{"token_ids": [...]}``

Request headers reach the model's hooks with lower-cased names (an
``x-kft-seed`` seeds an ``LMEngineModel``'s sampling).

Errors: malformed input is 400, an unknown model 404, an unported
feature 501, ``EngineOverloaded`` 429 and a deadline 503 with
``Retry-After``. The aiohttp server's other routes (streaming, metrics,
traces, KV transfer, graphs) are ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeflow_tpu_torch.serve.engine import DeadlineExceeded, EngineOverloaded
from kubeflow_tpu_torch.serve.model import Model

_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_GENERATE = re.compile(r"^/v2/models/([^/]+)/generate$")


class _HTTPError(Exception):
    def __init__(self, status: int, reason: str, headers: dict | None = None):
        super().__init__(reason)
        self.status, self.reason, self.headers = status, reason, headers or {}


class ModelServer:
    """Hosts ``Model``s over HTTP. ``http_port=0`` binds an ephemeral
    port; after :meth:`start` the bound port is ``self.port``."""

    def __init__(self, models: list[Model], *, http_port: int = 8080,
                 host: str = "127.0.0.1"):
        self.models: dict[str, Model] = {}
        for m in models:
            if not m.ready:
                m.load()
            self.models[m.name] = m
        self.host, self.http_port = host, http_port
        self.port: int | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

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
                headers = {}
                try:
                    status, payload = fn(*args)
                except _HTTPError as e:
                    status, payload, headers = e.status, {"error": e.reason}, e.headers
                except Exception as e:  # noqa: BLE001 — the server keeps serving
                    traceback.print_exc()
                    status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((self.host, self.http_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="model-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        for m in self.models.values():
            m.unload()

    # -- routes ------------------------------------------------------------- #

    def _get(self, path: str):
        if path == "/v2/health/ready":
            ready = all(m.ready for m in self.models.values())
            return 200, {"ready": ready, "role": "both"}
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
        raise _HTTPError(404, f"no route POST {path}")

    @staticmethod
    def _json(body: bytes):
        try:
            return json.loads(body)
        except ValueError as e:
            raise _HTTPError(400, f"bad JSON: {e}") from None

    def _infer(self, name: str, payload: dict, headers: dict[str, str]) -> dict:
        model = self.models.get(name)
        if model is None:
            raise _HTTPError(404, f"model '{name}' not found")
        if not model.ready:
            raise _HTTPError(503, f"model '{name}' not ready")
        try:
            return model(payload, headers)
        except EngineOverloaded as e:
            raise _HTTPError(429, str(e)) from None
        except DeadlineExceeded as e:
            raise _HTTPError(503, str(e), {"Retry-After": "1"}) from None
        except NotImplementedError as e:
            raise _HTTPError(501, str(e)) from None
        except (ValueError, KeyError, TypeError) as e:
            raise _HTTPError(400, str(e)) from None
