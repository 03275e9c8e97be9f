"""Shared thread-hosted HTTP server base, on the standard library.

The port's ``kubeflow_tpu/obs/webhost.py``: the ``start()``/``stop()``/
``url`` surface of its ``ThreadedAiohttpServer``, served by
``http.server.ThreadingHTTPServer`` (the card's host has no aiohttp).
A bind error surfaces to the ``start()`` caller and leaves the server
unstarted, so a retry actually retries.

A subclass implements ``_routes()``: ``[(method, template, handler)]``.
A template's ``{name}`` segment matches as an aiohttp route's does (no
``/``), and ``handler(request) -> (status, JSON body)``. A path that no
route matches answers 404 and a method that none of its routes takes
answers 405, both with a JSON ``{"error": ...}`` body.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable


class Request:
    """One request as a route handler sees it: ``match_info`` holds the
    template's segments, URL-decoded."""

    def __init__(self, method: str, path: str, match_info: dict[str, str],
                 body: bytes):
        self.method, self.path = method, path
        self.match_info, self.body = match_info, body

    def json(self) -> Any:
        return json.loads(self.body or b"")


Handler = Callable[[Request], "tuple[int, Any]"]


def _compile(template: str) -> re.Pattern:
    parts = re.split(r"\{(\w+)\}", template)
    rx = "".join(
        re.escape(p) if i % 2 == 0 else f"(?P<{p}>[^{{}}/]+)"
        for i, p in enumerate(parts)
    )
    return re.compile(rx + "$")


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], ConnectionError):
            return  # a client that went away: nothing to report
        super().handle_error(request, client_address)


class ThreadedHTTPServer:
    """Subclass and implement ``_routes()``."""

    thread_name = "kft-web"

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._httpd: _HTTPServer | None = None
        self._thread: threading.Thread | None = None

    def _routes(self) -> list[tuple[str, str, Handler]]:  # pragma: no cover
        raise NotImplementedError

    def _dispatch(self, routes, method: str, raw_path: str,
                  body: bytes) -> tuple[int, Any]:
        path = urllib.parse.urlsplit(raw_path).path
        allowed = False
        for m, rx, fn in routes:
            match = rx.match(path)
            if match is None:
                continue
            if m != method:
                allowed = True
                continue
            info = {k: urllib.parse.unquote(v)
                    for k, v in match.groupdict().items()}
            return fn(Request(method, path, info, body))
        if allowed:
            return 405, {"error": f"method {method} not allowed"}
        return 404, {"error": f"no route for {path}"}

    def start(self):
        if self._thread is not None:
            return self
        server = self
        routes = [(m, _compile(t), fn) for m, t, fn in self._routes()]

        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet: no per-request stderr
                return

            def _serve(self, method):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                try:
                    status, payload = server._dispatch(routes, method,
                                                       self.path, body)
                except Exception as e:  # noqa: BLE001 — the server keeps serving
                    status = 500
                    payload = {"error": f"{type(e).__name__}: {e}"}
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

            def do_DELETE(self):
                self._serve("DELETE")

        try:
            self._httpd = _HTTPServer((self.host, self.port), RequestHandler)
        except OSError as e:
            raise RuntimeError(f"{self.thread_name} failed to start: {e}") from e
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name=self.thread_name
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
