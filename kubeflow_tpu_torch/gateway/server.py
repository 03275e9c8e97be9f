"""The L7 inference gateway: one front door over N ``ModelServer``
replicas. The port of ``kubeflow_tpu/gateway/server.py`` on the standard
library (``http.server.ThreadingHTTPServer`` in front, ``http.client``
to the replicas), since the card's host has no aiohttp. Every request
flows:

    client → policy (tenant rate/in-flight) → route table (host/path)
           → revision split (salted hash, edge-decided)
           → activator (park if scaled to zero)
           → backend pick (prefix/session affinity | least-outstanding)
           → proxy (retries within budget, optional hedging, SSE
             passthrough with mid-stream failover)

Routes: ``GET /gateway/healthz``, ``GET /gateway/state``, ``GET
/metrics`` (the process registry, Prometheus text), ``GET
/debug/traces`` (``limit`` 1–256, ``format=perfetto``), and every other
method and path proxied.

The behaviour a client sees is the reference's: the same statuses,
headers, retry and shed rules, spans and metric lines. Where one thread
a connection has to work differently from one event loop:

- a parked request blocks its thread on the activator's condition
  (``gateway/activator.py``), flushed in admission order;
- a hedge runs its two attempts on two threads; the first answer wins
  and returns at once: the winner's thread ends the loser's ``proxy``
  span ("cancelled") and shuts the loser's socket, and the loser's
  thread unwinds alone, however long its connect still takes;
- a client that walks away mid-stream is seen at the next frame the
  gateway writes to it (``BrokenPipeError``/``ConnectionResetError``),
  where the reference's event loop learns it at once; the current
  upstream is then shut down, so the replica cancels its row;
- a read from a replica's stream waits at most ``upstream_timeout_s``
  for its next bytes (the reference waits without bound), so a silent
  replica counts as a mid-stream death and the stream resumes on a
  peer; a non-streaming attempt's read is bounded by the smaller of
  ``upstream_timeout_s`` and the deadline left.

Upstream headers are sent with lower-case names: the JAX server reads
both spellings, and urllib's ``X-kft-...`` capitalisation is neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import http.client
import json
import queue
import socket
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable

from kubeflow_tpu_torch.gateway.activator import (
    ActivationTimeout,
    Activator,
    QueueOverflow,
)
from kubeflow_tpu_torch.gateway.backends import Backend, BackendPool, BreakerConfig
from kubeflow_tpu_torch.gateway.policy import (
    PolicyEngine,
    RateLimited,
    RetryBudget,
    TenantPolicy,
    TokenBucket,
    TooManyInFlight,
)
from kubeflow_tpu_torch.gateway.router import (
    HashRing,
    RouteTable,
    ServiceRoute,
    affinity_key_of,
)
from kubeflow_tpu_torch.gateway.sse import SSEFrameSplitter, sse_payload
from kubeflow_tpu_torch.obs import names, prom
from kubeflow_tpu_torch.obs.trace import TRACER, ctx_from_headers, debug_traces
from kubeflow_tpu_torch.serve.deadline import deadline_from_headers
from kubeflow_tpu_torch.serve.headers import (
    DEADLINE_ABS_HEADER,
    DEADLINE_HEADER,
    PREFILL_PEER_HEADER,
    PRIORITY_HEADER,
    RESUME_TOKENS_HEADER,
    SEED_HEADER,
    TENANT_HEADER,
    TRACE_HEADER,
)
from kubeflow_tpu_torch.serve.server import _HTTPServer

REQUESTS = prom.REGISTRY.counter(
    names.GATEWAY_REQUESTS_TOTAL,
    "requests answered at the edge, by status",
    ("service", "code"),
)
LATENCY = prom.REGISTRY.histogram(
    names.GATEWAY_LATENCY_SECONDS,
    "edge-observed request latency (activator queue time included)",
    ("service",),
)
SHED = prom.REGISTRY.counter(
    names.GATEWAY_SHED_TOTAL,
    "requests shed at the edge",
    ("service", "reason"),
)
RETRIES = prom.REGISTRY.counter(
    names.GATEWAY_RETRIES_TOTAL,
    "transparent re-dispatches after a backend failure",
    ("service",),
)
HEDGES = prom.REGISTRY.counter(
    names.GATEWAY_HEDGES_TOTAL,
    "hedged second requests dispatched",
    ("service",),
)
AFFINITY_ROUTED = prom.REGISTRY.counter(
    names.GATEWAY_AFFINITY_ROUTED_TOTAL,
    "requests routed by prefix/session affinity",
    ("service",),
)
STREAM_RESUMES = prom.REGISTRY.counter(
    names.GATEWAY_STREAM_RESUMES_TOTAL,
    "mid-stream failovers: SSE streams re-dispatched with a committed-"
    "token resume prefix, by outcome",
    ("service", "outcome"),
)

#: hop-by-hop headers never forwarded either direction
_HOP_HEADERS = {
    "host", "content-length", "transfer-encoding", "connection",
    "keep-alive", "upgrade", "proxy-authorization", "proxy-connection",
}

#: verbs safe to retry/hedge: reads, and the stateless inference verbs
_IDEMPOTENT_SUFFIXES = (":predict", "/infer")

#: upstream statuses that indicate backend (not request) trouble
_BACKEND_FAILURE_STATUSES = (502, 503, 504)

#: what a read from, or a write to, a dead socket raises
_WIRE_ERRORS = (OSError, http.client.HTTPException, ValueError)


def _edge_status(status: int, headers=None) -> str:
    """Span status for an edge response: coherent sheds (429, 503 with
    Retry-After) end the trace as ``shed`` — tail-sampled like errors —
    while other 5xx are ``error``."""
    if status == 429 or (
        status == 503 and headers is not None and "Retry-After" in headers
    ):
        return "shed"
    if status >= 500:
        return "error"
    return "ok"


class _UpstreamError(Exception):
    def __init__(self, backend: Backend, cause: BaseException):
        super().__init__(f"{backend.url}: {cause}")
        self.backend = backend
        self.cause = cause


class _EdgeError(Exception):
    """An answer the gateway makes itself (aiohttp's ``HTTPException``
    in the reference): ``"{status}: {reason}"`` as plain text."""

    def __init__(self, status: int, reason: str, headers: dict | None = None):
        super().__init__(reason)
        self.status, self.reason, self.headers = status, reason, headers or {}


class _ClientGone(Exception):
    """A write to the client failed: it walked away."""


@dataclasses.dataclass
class _Reply:
    """A whole (non-streamed) answer to the client."""

    status: int
    body: bytes
    headers: dict


class _Streamed:
    """The answer already went to the client as a chunked SSE stream."""

    status = 200
    headers: dict = {}


@dataclasses.dataclass
class GatewayConfig:
    name: str = "gateway"
    salt: str = "kft-canary"
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    failure_threshold: int = 3
    recovery_s: float = 5.0
    eject_threshold: int = 3
    queue_limit: int = 256
    activation_timeout_s: float = 30.0
    upstream_timeout_s: float = 120.0
    connect_timeout_s: float = 5.0
    retry_budget_ratio: float = 0.2
    retry_budget_floor: int = 3
    #: mid-stream failover: re-dispatch a dying SSE stream to a healthy
    #: peer with the committed-token prefix instead of surfacing a
    #: terminal error frame (bounded by maxAttempts + the retry budget)
    stream_resume: bool = True
    routes: list[ServiceRoute] = dataclasses.field(default_factory=list)
    #: (service, url, revision, role) tuples registered at startup;
    #: role is "both" | "prefill" | "decode" (disaggregated serving)
    backends: list[tuple[str, str, str, str]] = dataclasses.field(
        default_factory=list
    )
    #: tenant → {max_rps, burst, max_in_flight, priority}
    tenants: dict[str, dict] = dataclasses.field(default_factory=dict)
    #: service → raw ``autoscaling:`` manifest section (camelCase KPA
    #: policy + replicaCommand), kept for the autoscaler (ROADMAP queue 1
    #: item 7d); the gateway itself does not read it
    autoscaling: dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_manifest(cls, doc: dict) -> "GatewayConfig":
        """``kind: InferenceGateway`` manifest → config (KServe-style
        camelCase spec keys)."""
        if doc.get("kind", "InferenceGateway") != "InferenceGateway":
            raise ValueError(
                f"not an InferenceGateway manifest: {doc.get('kind')!r}"
            )
        spec = doc.get("spec", {})
        cfg = cls(name=doc.get("metadata", {}).get("name", "gateway"))
        for yaml_key, attr in (
            ("salt", "salt"),
            ("probeIntervalS", "probe_interval_s"),
            ("probeTimeoutS", "probe_timeout_s"),
            ("failureThreshold", "failure_threshold"),
            ("recoveryS", "recovery_s"),
            ("ejectThreshold", "eject_threshold"),
            ("queueLimit", "queue_limit"),
            ("activationTimeoutS", "activation_timeout_s"),
            ("upstreamTimeoutS", "upstream_timeout_s"),
            ("connectTimeoutS", "connect_timeout_s"),
            ("retryBudgetRatio", "retry_budget_ratio"),
            ("retryBudgetFloor", "retry_budget_floor"),
            ("streamResume", "stream_resume"),
        ):
            if yaml_key in spec:
                setattr(cfg, attr, type(getattr(cfg, attr))(spec[yaml_key]))
        for svc in spec.get("services", []):
            name = svc["name"]
            cfg.routes.append(
                ServiceRoute(
                    name=name,
                    hosts=tuple(svc.get("hosts", ())),
                    path_prefixes=tuple(svc.get("pathPrefixes", ())),
                    canary_percent=float(svc.get("canaryPercent", 0)),
                    affinity=svc.get("affinity", "none"),
                    affinity_prefix_tokens=int(
                        svc.get("affinityPrefixTokens", 16)
                    ),
                    hedge_ms=(
                        float(svc["hedgeMs"]) if "hedgeMs" in svc else None
                    ),
                    max_attempts=int(svc.get("maxAttempts", 3)),
                )
            )
            for be in svc.get("backends", []):
                if isinstance(be, str):
                    cfg.backends.append((name, be, "default", "both"))
                else:
                    cfg.backends.append(
                        (
                            name,
                            be["url"],
                            be.get("revision", "default"),
                            be.get("role", "both"),
                        )
                    )
            if "autoscaling" in svc:
                auto = dict(svc["autoscaling"])
                if not isinstance(auto.get("replicaCommand", []), list):
                    raise ValueError(
                        f"service {name!r}: autoscaling.replicaCommand "
                        "must be an argv list"
                    )
                cfg.autoscaling[name] = auto
        for tenant, pol in (spec.get("policy", {}).get("tenants", {})).items():
            cfg.tenants[tenant] = {
                "max_rps": pol.get("maxRps"),
                "burst": pol.get("burst"),
                "max_in_flight": pol.get("maxInFlight"),
                "priority": pol.get("priority", 0),
            }
        return cfg


def _hard_close(conn: http.client.HTTPConnection | None) -> None:
    """Close an upstream connection so the replica sees it at once (its
    next write fails and it cancels the row), and so a read blocked on it
    in another thread returns."""
    if conn is None:
        return
    sock = conn.sock
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    conn.close()


class _Cancelled(Exception):
    """A hedge's losing attempt, unwinding on its own thread."""


class _Attempt:
    """One racer of a hedge: its connection and ``proxy`` span, which the
    winner's thread closes. ``lock`` orders the cancel against the
    racer's own span opening, span ends and breaker records: after
    :meth:`cancel` the racer holds no open span and records nothing."""

    def __init__(self) -> None:
        self.conn: http.client.HTTPConnection | None = None
        self.span = None
        self.lock = threading.Lock()
        self.cancelled = threading.Event()

    def cancel(self) -> None:
        with self.lock:
            self.cancelled.set()
            if self.span and self.span.end_time is None:  # still racing
                self.span.set_attr("hedge_loser", True)
                self.span.end("cancelled")
        _hard_close(self.conn)


class InferenceGateway:
    """``http_port=0`` binds an ephemeral port; after :meth:`start` the
    bound port is ``self.http_port``. ``scale_up(service)`` is kicked
    once per cold episode when a request parks with no ready backend.
    ``controller`` (an ``InferenceServiceController``) feeds the route
    table (``RouteTable.update_from_controller``) here and on every
    probe pass; the backends stay the config's."""

    def __init__(
        self,
        config: GatewayConfig | None = None,
        *,
        http_port: int = 0,
        host: str = "127.0.0.1",
        controller: Any = None,
        scale_up: Callable[[str], None] | None = None,
        policy: PolicyEngine | None = None,
    ):
        self.config = config or GatewayConfig()
        self.host, self.http_port = host, http_port
        #: optional InferenceServiceController whose state feeds the route
        #: table (resynced on every probe pass)
        self.controller = controller
        self.activator = Activator(
            queue_limit=self.config.queue_limit,
            timeout_s=self.config.activation_timeout_s,
            scale_up=scale_up,
        )
        self.pool = BackendPool(
            breaker=BreakerConfig(
                failure_threshold=self.config.failure_threshold,
                recovery_s=self.config.recovery_s,
            ),
            probe_interval_s=self.config.probe_interval_s,
            probe_timeout_s=self.config.probe_timeout_s,
            eject_threshold=self.config.eject_threshold,
            on_ready=self.activator.notify,
        )
        self.table = RouteTable(salt=self.config.salt)
        for r in self.config.routes:
            self.table.upsert(r)
        for entry in self.config.backends:
            # 3-tuples (service, url, revision) mean role "both"
            service, url, revision = entry[0], entry[1], entry[2]
            role = entry[3] if len(entry) > 3 else "both"
            if self.table.get(service) is None:
                self.table.upsert(ServiceRoute(name=service))
            self.pool.add(service, url, revision=revision, role=role)
        if policy is not None:
            self.policy = policy
        else:
            self.policy = PolicyEngine()
            for tenant, p in self.config.tenants.items():
                self.policy.set(
                    tenant,
                    TenantPolicy(
                        bucket=(
                            TokenBucket(p["max_rps"], p.get("burst"))
                            if p.get("max_rps") is not None
                            else None
                        ),
                        max_in_flight=p.get("max_in_flight"),
                        priority=int(p.get("priority") or 0),
                    ),
                )
        self._budgets: dict[str, RetryBudget] = {}
        self._rings: dict[tuple[str, ...], HashRing] = {}
        self._httpd: _HTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._stopping = threading.Event()
        if self.controller is not None:
            self.table.update_from_controller(self.controller)

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> "InferenceGateway":
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet: no per-request stderr
                return

            def _serve(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                gw._handle(self, body)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _serve

        self._stopping.clear()
        self._httpd = _HTTPServer((self.host, self.http_port), Handler)
        self.http_port = self._httpd.server_address[1]
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="gateway-http", daemon=True),
            threading.Thread(target=self._probe_loop, name="gateway-probe",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Stop probing, close the listener. Requests in flight finish on
        their own threads."""
        self._stopping.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(self.config.probe_timeout_s + 5.0)
        self._threads = []

    def _probe_loop(self) -> None:
        while not self._stopping.wait(self.config.probe_interval_s):
            if self.controller is not None:
                self.table.update_from_controller(self.controller)
            self.pool.probe_all()

    # -- the edge's own routes --------------------------------------------- #

    def state_view(self) -> dict:
        routes = self.table.routes()
        return {
            "name": self.config.name,
            "services": [
                {
                    **r.view(),
                    "ready_backends": self.pool.ready_count(r.name),
                    "queue_depth": self.activator.depth(r.name),
                    "backends": [
                        b.view() for b in self.pool.backends_of(r.name)
                    ],
                }
                for r in routes
            ],
            "policy": self.policy.view(),
            "activator": self.activator.view(),
        }

    def _local(self, method: str, path: str) -> _Reply | None:
        """The gateway's own GET routes, or None to proxy."""
        if method != "GET":
            return None
        url = urllib.parse.urlsplit(path)
        if url.path == "/gateway/healthz":
            return self._json(200, {"ok": True, "name": self.config.name})
        if url.path == "/gateway/state":
            return self._json(200, self.state_view())
        if url.path == "/metrics":
            return _Reply(200, prom.REGISTRY.expose().encode(),
                          {"Content-Type": "text/plain; version=0.0.4"})
        if url.path == "/debug/traces":
            try:
                return self._json(200, debug_traces(url.query))
            except ValueError as e:
                raise _EdgeError(400, str(e)) from None
        return None

    @staticmethod
    def _json(status: int, doc) -> _Reply:
        return _Reply(status, json.dumps(doc).encode(),
                      {"Content-Type": "application/json"})

    # -- the request path ------------------------------------------------ #

    def _handle(self, handler: BaseHTTPRequestHandler, body: bytes) -> None:
        """Answer one client request: the edge's routes, else the proxy."""
        method = handler.command
        headers = {k.lower(): v for k, v in handler.headers.items()}
        try:
            reply = self._local(method, handler.path)
            if reply is None:
                reply = self._proxy(handler, method, headers, body)
        except _EdgeError as e:
            reply = _Reply(e.status, f"{e.status}: {e.reason}".encode(),
                           {"Content-Type": "text/plain; charset=utf-8",
                            **e.headers})
        except _ClientGone:
            handler.close_connection = True
            return
        except Exception as e:  # noqa: BLE001 — a 500, as aiohttp answers
            if getattr(handler, "_sse_started", False):
                handler.close_connection = True  # mid-stream: nothing to send
                return
            reply = _Reply(500, f"500: {type(e).__name__}: {e}".encode(),
                           {"Content-Type": "text/plain; charset=utf-8"})
        if isinstance(reply, _Streamed):
            return
        try:
            handler.send_response(reply.status)
            for k, v in reply.headers.items():
                handler.send_header(k, v)
            handler.send_header("Content-Length", str(len(reply.body)))
            handler.end_headers()
            if method != "HEAD":
                handler.wfile.write(reply.body)
        except (BrokenPipeError, ConnectionResetError):
            handler.close_connection = True

    def _proxy(self, handler, method: str, headers: dict, body: bytes):
        t0 = time.perf_counter()
        path = urllib.parse.urlsplit(handler.path).path
        resolved = self.table.resolve(headers.get("host"), path)
        if resolved is None:
            REQUESTS.labels(service="_unmatched", code="404").inc()
            raise _EdgeError(404, f"no service routes {path!r}")
        route, path = resolved
        service = route.name
        # root span for the whole edge decision: continues the client's
        # trace when a valid x-kft-trace rides in, mints one otherwise.
        # Every downstream hop (proxy attempt, dataplane, engine) parents
        # onto this id — ONE trace from edge to decode chunk.
        span = TRACER.span("route", ctx=ctx_from_headers(headers))
        if span:
            for k, v in route.trace_attrs().items():
                span.set_attr(k, v)
            span.set_attr("path", path)
            span.set_attr("method", method)
        tenant = headers.get(TENANT_HEADER, "default")
        try:
            self.policy.acquire(tenant)
        except RateLimited as e:
            SHED.labels(service=service, reason="rate_limit").inc()
            REQUESTS.labels(service=service, code="429").inc()
            if span:
                span.event("rate_limited", tenant=tenant)
                span.end("shed")
            raise _EdgeError(429, str(e), {"Retry-After": "1"}) from None
        except TooManyInFlight as e:
            SHED.labels(service=service, reason="inflight_cap").inc()
            REQUESTS.labels(service=service, code="429").inc()
            if span:
                span.event("inflight_cap", tenant=tenant)
                span.end("shed")
            raise _EdgeError(429, str(e)) from None
        try:
            resp = self._routed(handler, method, headers, body, route, path,
                                span)
            REQUESTS.labels(service=service, code=str(resp.status)).inc()
            if span:
                span.set_attr("status", resp.status)
                span.end(_edge_status(resp.status, resp.headers))
            return resp
        except _EdgeError as e:
            REQUESTS.labels(service=service, code=str(e.status)).inc()
            if span:
                span.set_attr("status", e.status)
                span.end(_edge_status(e.status, e.headers))
            raise
        except _ClientGone:
            if span:
                span.end("cancelled")
            raise
        except BaseException:
            if span:
                span.end("error")
            raise
        finally:
            self.policy.release(tenant)
            LATENCY.labels(service=service).observe(time.perf_counter() - t0)

    def _routed(self, handler, method: str, headers: dict, body: bytes,
                route: ServiceRoute, path: str, span=None):
        req_id = headers.get("x-request-id") or uuid.uuid4().hex
        revision = self.table.revision_for(route, req_id)
        affinity_key = None
        if route.affinity != "none":
            try:
                parsed = json.loads(body) if body else None
            except ValueError:
                parsed = None
            affinity_key = affinity_key_of(route, headers, parsed)
        fwd = {k: v for k, v in headers.items() if k not in _HOP_HEADERS}
        fwd["x-request-id"] = req_id
        # the absolute-deadline header is process-local (a monotonic
        # stamp): one arriving off the wire is meaningless-to-hostile —
        # never forward it, backends re-anchor from the ms budget
        fwd.pop(DEADLINE_ABS_HEADER, None)
        fwd.pop(DEADLINE_ABS_HEADER.title(), None)
        # never forward the client's raw trace header: each upstream
        # attempt stamps ITS OWN span id (see _attempt_once), so backend
        # spans parent onto the attempt that actually carried them
        fwd.pop(TRACE_HEADER, None)
        fwd.pop(TRACE_HEADER.title(), None)
        if span:
            fwd[TRACE_HEADER] = span.header()
        # the prefill-peer header is gateway-authoritative: a client (or
        # a compromised hop) must not be able to point a decode replica
        # at an arbitrary URL to pull KV from
        fwd.pop(PREFILL_PEER_HEADER, None)
        fwd.pop(PREFILL_PEER_HEADER.title(), None)
        # the resume header is gateway-authoritative: only the gateway may
        # assert a committed-token prefix (a client asserting one would
        # splice arbitrary tokens into its own billed budget)
        fwd.pop(RESUME_TOKENS_HEADER, None)
        fwd.pop(RESUME_TOKENS_HEADER.title(), None)
        if path.endswith("/generate") or path.endswith("/generate_stream"):
            # disaggregated dispatch: hand the decode replica its prefill
            # peer. None when the service runs colocated OR every prefill
            # replica is unhealthy — the decode replica then prefills
            # locally, so disagg degrades to colocated, never to an error.
            pb = self.pool.pick_prefill(route.name)
            if pb is not None:
                fwd[PREFILL_PEER_HEADER] = pb.url
                if span:
                    span.set_attr("prefill_peer", pb.url)
            # sampling seed, stamped deterministically from the request id
            # (client-supplied seeds are honored): every attempt — first
            # dispatch, retry, or mid-stream resume — carries the SAME
            # seed, so a temperature>0 stream resumed on another replica
            # draws the identical sampling stream
            seed = None
            raw_seed = headers.get(SEED_HEADER)
            if raw_seed is not None:
                try:
                    seed = int(raw_seed) & 0x7FFFFFFF
                except ValueError:
                    seed = None
            if seed is None:
                seed = int.from_bytes(
                    hashlib.sha256(req_id.encode()).digest()[:4], "big"
                ) & 0x7FFFFFFF
            fwd.pop(SEED_HEADER.title(), None)
            fwd[SEED_HEADER] = str(seed)
        #: the end-to-end budget, anchored at edge arrival: queue time in
        #: the activator and retry rounds are charged against it. Only
        #: the WIRE header counts (the absolute stamp was stripped above).
        deadline = deadline_from_headers(
            {DEADLINE_HEADER: headers[DEADLINE_HEADER]}
            if DEADLINE_HEADER in headers
            else None
        )
        # managed tenants get their policy priority stamped (gateway-
        # authoritative — a client cannot self-promote its shed order)
        tenant = headers.get(TENANT_HEADER, "default")
        prio = self.policy.priority_of(tenant)
        if prio is not None:
            fwd.pop(PRIORITY_HEADER.title(), None)
            fwd[PRIORITY_HEADER] = str(prio)
        is_stream = path.endswith("/generate_stream")
        idempotent = method == "GET" or any(
            path.endswith(s) for s in _IDEMPOTENT_SUFFIXES
        )
        budget = self._budgets.setdefault(route.name, RetryBudget(
            ratio=self.config.retry_budget_ratio,
            floor=self.config.retry_budget_floor,
        ))
        budget.on_request()

        parks = 0
        attempts = 0
        last_err: _UpstreamError | None = None
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # every hop downstream would shed it too — fail at the
                    # edge with the shed marker (503 + Retry-After), and
                    # never as a retryable backend failure
                    SHED.labels(service=route.name, reason="deadline").inc()
                    if span:
                        span.event("deadline_expired", stage="edge")
                    raise _EdgeError(
                        503, "request deadline expired at the gateway",
                        {"Retry-After": "1"},
                    )
                # rewrite the wire budget to what is LEFT: edge queue time
                # and earlier attempts are charged, so the backend's own
                # admission control sees the truth
                fwd[DEADLINE_HEADER] = str(max(1, int(remaining * 1e3)))
                fwd.pop(DEADLINE_HEADER.title(), None)
            backend = self._select(route, revision, affinity_key)
            if backend is None:
                parks += 1
                if parks > 8:
                    break  # repeated wake-ups without capacity: shed below
                # cold-start parking is often the dominant edge latency —
                # it gets its own span so traces show WHERE the time went
                pspan = (
                    TRACER.span("activator.park", parent=span)
                    if span
                    else None
                )
                try:
                    self.activator.wait(route.name, span=pspan)
                    if pspan:
                        pspan.end()
                except QueueOverflow as e:
                    if pspan:
                        pspan.end("shed")
                    SHED.labels(
                        service=route.name, reason="queue_full"
                    ).inc()
                    raise _EdgeError(429, str(e)) from None
                except ActivationTimeout as e:
                    if pspan:
                        pspan.end("shed")
                    SHED.labels(
                        service=route.name, reason="activation_timeout"
                    ).inc()
                    raise _EdgeError(503, str(e)) from None
                continue
            try:
                if is_stream:
                    # connect-level stream failures retry like any other
                    # attempt (no response bytes have committed yet);
                    # mid-stream failures resume inside _proxy_stream —
                    # re-dispatched with the committed-token prefix,
                    # charged against the same retry budget
                    return self._proxy_stream(
                        handler, route, backend, path, fwd, body,
                        parent=span, budget=budget, deadline=deadline,
                    )
                return self._attempt(
                    route, backend, method, path, fwd, body,
                    idempotent=idempotent, timeout_s=remaining, parent=span,
                )
            except _UpstreamError as e:
                last_err = e
                attempts += 1
                # streams only raise here on CONNECT failure (nothing has
                # committed to the client), so they are safe to re-dispatch
                if (
                    (idempotent or is_stream)
                    and attempts < route.max_attempts
                    and budget.try_spend()
                ):
                    RETRIES.labels(service=route.name).inc()
                    if span:
                        span.event(
                            "retry", attempt=attempts, backend=e.backend.url
                        )
                    continue
                break
        SHED.labels(service=route.name, reason="no_backend").inc()
        raise _EdgeError(
            503,
            f"no backend could serve {route.name!r}"
            + (f" (last error: {last_err})" if last_err else ""),
        )

    def _select(
        self, route: ServiceRoute, revision: str, affinity_key: str | None
    ) -> Backend | None:
        """Affinity first (closed-breaker replicas only), then
        least-outstanding; a canary decision with no live canary backends
        falls back to the default revision rather than shedding."""
        with self.pool.lock:
            rev = revision
            if rev == "canary" and not self.pool.selectable(route.name, "canary"):
                rev = "default"
            if affinity_key is not None:
                b = self._affine_pick(route, rev, affinity_key)
                if b is not None:
                    AFFINITY_ROUTED.labels(service=route.name).inc()
                    return b
            b = self.pool.pick(route.name, rev)
            if b is None:
                b = self.pool.pick(route.name, None)
            return b

    def _affine_pick(
        self, route: ServiceRoute, revision: str, key: str
    ) -> Backend | None:
        with self.pool.lock:
            cands = [
                b
                for b in self.pool.selectable(route.name, revision)
                if b.breaker.current_state() == "closed"
            ]
            if not cands:
                return None
            urls = tuple(sorted(b.url for b in cands))
            ring = self._rings.get(urls)
            if ring is None:
                if len(self._rings) > 128:  # membership churn: drop stale rings
                    self._rings.clear()
                ring = self._rings[urls] = HashRing(urls)
            url = ring.pick(key)
            b = next(b for b in cands if b.url == url)
            if (
                route.affinity_max_outstanding is not None
                and b.outstanding >= route.affinity_max_outstanding
            ):
                return None  # affine replica saturated: spill to the balancer
            return b

    # -- one upstream attempt (with optional hedging) -------------------- #

    def _open(self, backend: Backend, method: str, path: str, hdrs: dict,
              body: bytes, read_timeout_s: float | None,
              attempt: _Attempt | None = None) -> http.client.HTTPResponse:
        """Connect (bounded by ``connect_timeout_s``), send, and read the
        status line and headers; each later read waits at most
        ``read_timeout_s``."""
        u = urllib.parse.urlsplit(backend.url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80, timeout=self.config.connect_timeout_s)
        if attempt is not None:
            attempt.conn = conn
        try:
            conn.connect()
            if attempt is not None and attempt.cancelled.is_set():
                raise ConnectionAbortedError("attempt cancelled")
            conn.sock.settimeout(read_timeout_s)
            conn.request(method, u.path.rstrip("/") + path,
                         body=body if method not in ("GET", "HEAD") else None,
                         headers=hdrs)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        resp.conn = conn  # closed by the response's owner
        return resp

    def _attempt(
        self,
        route: ServiceRoute,
        backend: Backend,
        method: str,
        path: str,
        fwd: dict,
        body: bytes,
        *,
        idempotent: bool,
        timeout_s: float | None = None,
        parent=None,
    ) -> _Reply:
        if (
            route.hedge_ms is not None
            and idempotent
            and len(self.pool.selectable(route.name)) > 1
        ):
            return self._hedged(
                route, backend, method, path, fwd, body, timeout_s,
                parent=parent,
            )
        return self._attempt_once(
            route, backend, method, path, fwd, body, timeout_s,
            parent=parent,
        )

    def _hedged(
        self, route, primary, method, path, fwd, body, timeout_s=None,
        *, parent=None,
    ) -> _Reply:
        """Race a second attempt dispatched ``hedge_ms`` after the first;
        first success wins, the loser is cancelled (its socket shut down)
        and its span closed before this returns."""
        done: queue.Queue = queue.Queue()

        def race(backend, attempt, hedged):
            try:
                out = self._attempt_once(
                    route, backend, method, path, fwd, body, timeout_s,
                    parent=parent, hedged=hedged, attempt=attempt,
                )
                done.put((attempt, out, None))
            except BaseException as e:  # noqa: BLE001 — handed to the racer
                done.put((attempt, None, e))

        def launch(backend, hedged):
            attempt = _Attempt()
            threading.Thread(target=race, args=(backend, attempt, hedged),
                             name="gateway-hedge", daemon=True).start()
            return attempt

        first = launch(primary, False)
        try:
            a, out, err = done.get(timeout=route.hedge_ms / 1e3)
        except queue.Empty:
            pass
        else:
            if err is not None:
                raise err  # failed fast: the retry loop takes it
            return out
        second_backend = self.pool.pick(route.name)
        if second_backend is None or second_backend is primary:
            a, out, err = done.get()
            if err is not None:
                raise err
            return out
        HEDGES.labels(service=route.name).inc()
        second = launch(second_backend, True)
        err: BaseException | None = None
        for _ in range(2):
            a, out, e = done.get()
            if e is None:
                # ends the loser's span now, so the trace's root can
                # finalize; its thread is not waited for
                (second if a is first else first).cancel()
                return out
            err = e
        raise err

    def _attempt_once(
        self, route, backend: Backend, method, path, fwd, body,
        timeout_s: float | None = None, *, parent=None, hedged: bool = False,
        attempt: _Attempt | None = None,
    ) -> _Reply:
        lock = attempt.lock if attempt is not None else contextlib.nullcontext()
        with lock:
            if attempt is not None and attempt.cancelled.is_set():
                raise _Cancelled()  # lost before it started: no span
            span = TRACER.span("proxy", parent=parent) if parent else None
            if attempt is not None:
                attempt.span = span
        if span:
            span.set_attr("backend", backend.url)
            span.set_attr("revision", backend.revision)
            if hedged:
                span.set_attr("hedge", True)
            # copy before stamping: hedged/retried attempts share fwd, and
            # each must carry ITS OWN span id so the backend's spans parent
            # onto the attempt that actually reached it
            fwd = dict(fwd)
            fwd[TRACE_HEADER] = span.header()
        total = self.config.upstream_timeout_s
        if timeout_s is not None:
            # a deadline-bearing request never waits on a backend longer
            # than its remaining budget
            total = min(total, max(timeout_s, 0.001))
        self.pool.acquire(backend)
        upstream = None
        try:
            upstream = self._open(backend, method, path, fwd, body, total,
                                  attempt)
            payload = upstream.read()
            status = upstream.status
            ctype = upstream.getheader("Content-Type", "application/json")
            retry_after = upstream.getheader("Retry-After")
        except BaseException as e:
            with lock:
                if attempt is not None and attempt.cancelled.is_set():
                    # the hedge's loser, whatever its shut socket raised:
                    # the winner ended its span, and a cancel is no
                    # verdict on the backend
                    raise _Cancelled() from e
                if not isinstance(e, _WIRE_ERRORS):
                    raise
                self.pool.record(backend, ok=False)
                if span:
                    span.set_attr("error", str(e) or type(e).__name__)
                    span.end("error")
            raise _UpstreamError(backend, e) from e
        finally:
            self.pool.release(backend)
            if upstream is not None:
                upstream.conn.close()
        with lock:
            if attempt is not None and attempt.cancelled.is_set():
                raise _Cancelled()  # answered after losing: dropped
            return self._attempt_reply(route, backend, span, status, payload,
                                       ctype, retry_after)

    def _attempt_reply(self, route, backend: Backend, span, status: int,
                       payload: bytes, ctype: str,
                       retry_after: str | None) -> _Reply:
        """An attempt's answer: a shed passed through, a failure status
        raised for the retry loop, anything else returned."""
        if status == 503 and retry_after is not None:
            # coherent load shed (deadline-expired / admission-shed), NOT
            # backend death: pass it through with its Retry-After. No
            # retry (every replica would shed it identically — a retry
            # storm is how brownouts become blackouts) and no breaker
            # penalty (the replica answered rationally).
            self.pool.record(backend, ok=True)
            SHED.labels(service=route.name, reason="upstream_shed").inc()
            if span:
                span.set_attr("status", status)
                span.end("shed")
            return _Reply(status, payload,
                          {"Content-Type": ctype, "Retry-After": retry_after})
        if status in _BACKEND_FAILURE_STATUSES:
            self.pool.record(backend, ok=False)
            if span:
                span.set_attr("status", status)
                span.end("error")
            raise _UpstreamError(
                backend, RuntimeError(f"upstream returned {status}")
            )
        self.pool.record(backend, ok=True)
        if span:
            span.set_attr("status", status)
            span.end()
        return _Reply(status, payload, {"Content-Type": ctype})

    # -- SSE passthrough + mid-stream failover ---------------------------- #

    @staticmethod
    def _write_chunk(handler, data: bytes) -> None:
        """One chunk of the client's chunked response, flushed at once;
        a client that went away raises :class:`_ClientGone`."""
        try:
            handler.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError) as e:
            raise _ClientGone() from e

    def _pump_sse(
        self, upstream, handler, committed: list[int], *, rewrite: bool
    ) -> tuple[str, str | None]:
        """Forward one upstream's SSE stream to the client in WHOLE
        frames (one chunk a frame, flushed), tracking the generated-token
        prefix in ``committed``.

        Returns ``("done", None)`` after a terminal frame reached the
        client, or ``("died", reason)`` on mid-stream death — socket
        error, a read that waited past ``upstream_timeout_s``, EOF
        without a terminal frame, or the ModelServer's ``resumable``
        error frame (watchdog restart poison). ``rewrite`` fixes up the
        terminal done-frame's ``n_tokens`` after a resume (the final
        backend only counts its own segment); un-resumed streams are
        byte-identical passthrough."""
        split = SSEFrameSplitter()
        while True:
            try:
                chunk = upstream.read1(65536)
            except _WIRE_ERRORS as e:
                return "died", str(e) or type(e).__name__
            if not chunk:
                break
            for frame in split.feed(chunk):
                payload = sse_payload(frame)
                if payload is None:
                    self._write_chunk(handler, frame + b"\n\n")
                    continue
                if payload.get("resumable"):
                    # suppressed: the generation is continuable — the
                    # caller re-dispatches with the committed prefix
                    return "died", str(
                        payload.get("error", "resumable upstream error")
                    )
                if "token_ids" in payload:
                    committed.extend(int(t) for t in payload["token_ids"])
                    self._write_chunk(handler, frame + b"\n\n")
                    continue
                if payload.get("done") and rewrite:
                    payload["n_tokens"] = len(committed)
                    self._write_chunk(
                        handler, f"data: {json.dumps(payload)}\n\n".encode())
                    return "done", None
                # terminal done/error frames (and anything else) forward
                # verbatim; a non-resumable error frame is the backend's
                # own verdict on the request
                self._write_chunk(handler, frame + b"\n\n")
                if payload.get("done") or "error" in payload:
                    return "done", None
        # a torn trailing half-frame in split.pending is DROPPED, never
        # written — the resumed segment re-emits those tokens whole
        return "died", "upstream EOF before terminal frame"

    def _proxy_stream(
        self, handler, route: ServiceRoute, backend: Backend, path, fwd,
        body, *, parent=None, budget: RetryBudget | None = None,
        deadline: float | None = None,
    ):
        """Frame-aligned SSE proxy with transparent mid-stream failover.

        Upstream bytes are parsed into whole ``data:`` frames and the
        generated-token prefix the client has seen is tracked per stream.
        When the upstream dies mid-stream, the gateway re-dispatches the
        request to a healthy peer carrying the committed token ids
        (``x-kft-resume-tokens``) — the sampling seed was already stamped
        on the shared dispatch headers — and splices the continuation, so
        the client sees ONE unbroken stream with one ``done`` frame. A
        ``stream.resume`` span lands under the original trace id next to
        the failed proxy span.

        Resumes are bounded by the route's ``max_attempts`` and spend the
        SAME retry budget as pre-stream retries; exhaustion (or no
        healthy peer) falls back to one clean terminal error frame. A
        client disconnect at any point tears down the CURRENT upstream,
        first or resumed, so no engine row is orphaned on either
        replica."""
        span = TRACER.span("proxy", parent=parent) if parent else None
        if span:
            span.set_attr("backend", backend.url)
            span.set_attr("revision", backend.revision)
            span.set_attr("stream", True)
        hdrs = dict(fwd)
        if span:
            hdrs[TRACE_HEADER] = span.header()
        idle_s = self.config.upstream_timeout_s
        self.pool.acquire(backend)
        upstream = None
        try:
            try:
                upstream = self._open(backend, "POST", path, hdrs, body,
                                      idle_s)
            except _WIRE_ERRORS as e:
                self.pool.record(backend, ok=False)
                if span:
                    span.set_attr("error", str(e) or type(e).__name__)
                    span.end("error")
                # nothing has committed to the client: _routed's retry
                # loop re-dispatches like any failed attempt
                raise _UpstreamError(backend, e) from e
            if upstream.status != 200:
                # pre-stream refusal (429 overload, 400, 501, deadline
                # shed): pass through. A 503 carrying Retry-After is a
                # coherent shed, not backend trouble — no breaker penalty.
                try:
                    payload = upstream.read()
                except _WIRE_ERRORS:
                    payload = b""
                retry_after = upstream.getheader("Retry-After")
                shed_503 = upstream.status == 503 and retry_after is not None
                if shed_503:
                    SHED.labels(
                        service=route.name, reason="upstream_shed"
                    ).inc()
                self.pool.record(
                    backend,
                    ok=shed_503
                    or upstream.status not in _BACKEND_FAILURE_STATUSES,
                )
                out_hdrs = {
                    "Content-Type": upstream.getheader(
                        "Content-Type", "application/json"
                    )
                }
                if retry_after is not None:
                    out_hdrs["Retry-After"] = retry_after
                if span:
                    span.set_attr("status", upstream.status)
                    span.end(
                        "shed"
                        if shed_503
                        else (
                            "error"
                            if upstream.status in _BACKEND_FAILURE_STATUSES
                            else "ok"
                        )
                    )
                return _Reply(upstream.status, payload, out_hdrs)
            try:
                handler._sse_started = True
                handler.send_response(200)
                handler.send_header("Content-Type", "text/event-stream")
                handler.send_header("Cache-Control", "no-cache")
                handler.send_header("Transfer-Encoding", "chunked")
                handler.end_headers()
            except (BrokenPipeError, ConnectionResetError) as e:
                raise _ClientGone() from e
            committed: list[int] = []
            resumes = 0
            while True:
                outcome, err = self._pump_sse(
                    upstream, handler, committed, rewrite=resumes > 0
                )
                if outcome == "done":
                    self.pool.record(backend, ok=True)
                    if span:
                        span.set_attr("tokens", len(committed))
                        span.end()
                        span = None
                    if resumes:
                        STREAM_RESUMES.labels(
                            service=route.name, outcome="ok"
                        ).inc()
                    break
                # mid-stream death: the committed prefix is intact
                # (frame-aligned writes) — try to continue elsewhere
                self.pool.record(backend, ok=False)
                if span:
                    span.event("mid_stream_failure", error=err)
                    span.end("error")
                    span = None
                _hard_close(upstream.conn)
                upstream = None
                self.pool.release(backend)
                dead, backend = backend, None
                while True:  # resume-dispatch rounds, bounded below
                    fail_reason = None
                    if not self.config.stream_resume:
                        fail_reason = "disabled"
                    elif resumes + 1 >= route.max_attempts or not (
                        budget is None or budget.try_spend()
                    ):
                        fail_reason = "budget_exhausted"
                    elif deadline is not None and (
                        deadline - time.monotonic() <= 0
                    ):
                        fail_reason = "failed"
                    if fail_reason is None:
                        # prefer any peer over the replica that just
                        # died (pick falls back to it when it is the
                        # only one — the watchdog may be restarting it)
                        nxt = self.pool.pick(route.name, None, exclude=dead)
                        if nxt is None:
                            fail_reason = "no_backend"
                    if fail_reason is not None:
                        break
                    resumes += 1
                    RETRIES.labels(service=route.name).inc()
                    span = (
                        TRACER.span("stream.resume", parent=parent)
                        if parent
                        else None
                    )
                    if span:
                        span.set_attr("backend", nxt.url)
                        span.set_attr("revision", nxt.revision)
                        span.set_attr("stream", True)
                        span.set_attr("resume", resumes)
                        span.set_attr("committed_tokens", len(committed))
                    hdrs = dict(fwd)
                    if span:
                        hdrs[TRACE_HEADER] = span.header()
                    if committed:
                        hdrs[RESUME_TOKENS_HEADER] = ",".join(
                            str(t) for t in committed
                        )
                    if deadline is not None:
                        hdrs[DEADLINE_HEADER] = str(max(1, int(
                            (deadline - time.monotonic()) * 1e3
                        )))
                        hdrs.pop(DEADLINE_HEADER.title(), None)
                    self.pool.acquire(nxt)
                    backend = nxt
                    try:
                        upstream = self._open(nxt, "POST", path, hdrs, body,
                                              idle_s)
                        if upstream.status != 200:
                            status = upstream.status
                            upstream.conn.close()
                            upstream = None
                            raise RuntimeError(
                                f"resume dispatch returned {status}"
                            )
                    except (*_WIRE_ERRORS, RuntimeError) as e:
                        self.pool.record(nxt, ok=False)
                        if span:
                            span.set_attr("error", str(e) or type(e).__name__)
                            span.end("error")
                            span = None
                        if upstream is not None:
                            upstream.conn.close()
                            upstream = None
                        self.pool.release(nxt)
                        backend = None
                        STREAM_RESUMES.labels(
                            service=route.name, outcome="failed"
                        ).inc()
                        # another dispatch round: it charges the budget
                        # again, so the whole affair stays bounded by
                        # max_attempts even if every peer refuses
                        continue
                    break  # resumed upstream is live
                if upstream is not None:
                    continue  # next _pump_sse round on the new upstream
                # no resume possible: the pre-failover contract — one
                # clean terminal error frame, never a torn socket
                if fail_reason != "disabled":
                    STREAM_RESUMES.labels(
                        service=route.name, outcome=fail_reason
                    ).inc()
                frame = json.dumps(
                    {"error": f"upstream failed mid-stream: {err}"}
                )
                self._write_chunk(handler, f"data: {frame}\n\n".encode())
                break
            self._write_chunk(handler, b"")  # the terminating zero chunk
            if span:
                span.end()
            return _Streamed()
        finally:
            # after a resume there are N upstreams across the stream's
            # life — tear down the CURRENT one (a client disconnect during
            # failover must cancel the RESUMED replica's engine row, not
            # the dead replica's)
            if upstream is not None:
                _hard_close(upstream.conn)
            if backend is not None:
                self.pool.release(backend)
            if span is not None and span.end_time is None:
                # the client went away mid-write: close the span instead
                # of leaking the trace open
                span.end("cancelled")
