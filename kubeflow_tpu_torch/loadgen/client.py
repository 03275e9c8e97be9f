"""Open-loop HTTP/SSE client: fires the schedule at the REAL gateway. The
port of ``kubeflow_tpu/loadgen/client.py`` on threads and
``http.client``: one thread a request, and a semaphore of
``connector_limit`` in place of aiohttp's connector limit.

No mocked seams — requests go over the wire through the same
``/v2/models/{m}/generate_stream`` path production streams ride, and SSE
accounting (TTFT at the first whole ``token_ids`` frame, token counts,
terminal-frame detection) reuses the gateway's own frame splitter
(:mod:`kubeflow_tpu_torch.gateway.sse`), so torn-frame handling has
exactly one definition between the proxy and the harness measuring it.

Outcome taxonomy (client truth, scored against each request's SLO):

- ``completed_in_slo`` — terminal ``done`` frame, within ``slo_ms`` (or
  no SLO configured);
- ``completed_late`` — completed, but past the SLO (a *violation* in the
  Knative goodput sense: the work was done, the promise was not kept);
- ``shed`` — a coherent load-shed: 503 + ``Retry-After`` or 429. The
  platform chose not to take the work; sheds are goodput losses but NOT
  failures;
- ``error`` — anything else (5xx, torn stream without a terminal frame,
  transport error). The zero-client-visible-failures invariant binds HERE.

Being open-loop, request ``i`` fires at ``t0 + schedule[i]`` regardless of
how many are still in flight; the dispatch loop never waits on a
response. A request's clock starts on its own thread, before it waits
for a connection slot. ``dispatch_lag_s`` keeps, for the last run, how
late each request's thread started against its schedule: an open-loop
client that falls behind its schedule offers a different load.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import urllib.parse
from typing import Sequence

from kubeflow_tpu_torch.gateway.sse import SSEFrameSplitter, sse_payload
from kubeflow_tpu_torch.loadgen.workload import RequestSpec
from kubeflow_tpu_torch.obs import names, prom

__all__ = ["RequestResult", "LoadClient", "summarize_outcomes"]

CLIENT_REQUESTS = prom.REGISTRY.counter(
    names.LOADGEN_REQUESTS_TOTAL,
    "loadgen client-side request verdicts",
    ("tenant", "outcome"),
)


@dataclasses.dataclass
class RequestResult:
    """Client-side truth for one fired request."""

    index: int
    tenant: str
    priority: int | None
    offset_s: float          # scheduled arrival offset
    outcome: str             # completed_in_slo|completed_late|shed|error
    status: int = 0
    ttft_ms: float | None = None
    e2e_ms: float = 0.0
    tokens: int = 0
    slo_ms: float | None = None
    error: str | None = None

    @property
    def failed(self) -> bool:
        return self.outcome == "error"


def summarize_outcomes(results: Sequence[RequestResult]) -> dict[str, int]:
    out = {
        "completed_in_slo": 0, "completed_late": 0, "shed": 0, "error": 0,
    }
    for r in results:
        out[r.outcome] = out.get(r.outcome, 0) + 1
    return out


class LoadClient:
    """Drives one arrival schedule against one gateway service."""

    def __init__(
        self,
        base_url: str,
        model: str,
        *,
        stream: bool = True,
        request_timeout_s: float = 180.0,
        connector_limit: int = 256,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.stream = stream
        self.request_timeout_s = request_timeout_s
        self.connector_limit = connector_limit
        #: the last run's dispatch lag per request, in spec order: seconds
        #: from ``t0 + schedule[i]`` to the start of request i's thread
        self.dispatch_lag_s: list[float] = []

    def run(
        self,
        schedule: Sequence[float],
        specs: Sequence[RequestSpec],
        *,
        on_dispatch=None,
    ) -> list[RequestResult]:
        """Fire ``specs[i]`` at ``t0 + schedule[i]``; returns results in
        spec order once every stream settles. ``on_dispatch(i, t_rel)``
        (optional) observes each dispatch."""
        if len(schedule) != len(specs):
            raise ValueError(
                f"schedule ({len(schedule)}) and specs ({len(specs)}) "
                "must align"
            )
        slots = threading.BoundedSemaphore(self.connector_limit)
        results: list[RequestResult | None] = [None] * len(specs)
        lag = [0.0] * len(specs)
        threads = []
        t0 = time.monotonic()
        for pos, (offset, spec) in enumerate(zip(schedule, specs)):
            delay = t0 + offset - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if on_dispatch is not None:
                on_dispatch(spec.index, time.monotonic() - t0)
            t = threading.Thread(
                target=self._one,
                args=(slots, spec, t0, offset, results, lag, pos),
                name=f"loadgen-{spec.index}", daemon=True,
            )
            t.start()
            threads.append(t)
        # every request ends within its timeout: the slot wait and each
        # socket read are bounded by what is left of it
        for t in threads:
            t.join(self.request_timeout_s + 30.0)
        self.dispatch_lag_s = lag
        return [r for r in results if r is not None]

    # -- one request ------------------------------------------------------ #

    def _one(self, slots, spec: RequestSpec, t0: float, offset: float,
             results: list, lag: list, pos: int) -> None:
        start = time.monotonic()
        lag[pos] = start - (t0 + offset)
        res = RequestResult(
            index=spec.index, tenant=spec.tenant, priority=spec.priority,
            offset_s=offset, outcome="error", slo_ms=spec.slo_ms,
        )
        deadline = start + self.request_timeout_s
        try:
            if not slots.acquire(timeout=self.request_timeout_s):
                raise TimeoutError("no connection slot within the timeout")
            try:
                if self.stream:
                    self._stream_once(spec, res, start, deadline)
                else:
                    self._unary_once(spec, res, deadline)
            finally:
                slots.release()
        except Exception as e:  # noqa: BLE001 — client truth, not a crash
            res.outcome = "error"
            res.error = f"{type(e).__name__}: {e}"
        res.e2e_ms = (time.monotonic() - start) * 1e3
        if res.outcome.startswith("completed"):
            late = res.slo_ms is not None and res.e2e_ms > res.slo_ms
            res.outcome = "completed_late" if late else "completed_in_slo"
        CLIENT_REQUESTS.labels(tenant=res.tenant, outcome=res.outcome).inc()
        results[pos] = res

    def _body(self, spec: RequestSpec) -> bytes:
        return json.dumps({
            "input_ids": list(spec.prompt_ids),
            "max_new_tokens": spec.max_new_tokens,
        }).encode()

    def _post(self, route: str, spec: RequestSpec, deadline: float):
        """Open a connection and POST ``spec`` to ``route`` of the model;
        returns ``(conn, response)``; the caller closes ``conn``."""
        u = urllib.parse.urlsplit(self.base_url)
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"no time left of {self.request_timeout_s} s")
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=left)
        headers = dict(spec.headers)
        headers["x-request-id"] = f"loadgen-{spec.index}"
        try:
            conn.request(
                "POST", f"{u.path}/v2/models/{self.model}/{route}",
                body=self._body(spec), headers=headers,
            )
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    @staticmethod
    def _classify_refusal(res: RequestResult, status: int,
                          retry_after: str | None, body: str) -> None:
        if status == 429 or (status == 503 and retry_after is not None):
            # coherent shed: the platform declined rationally (rate
            # limit / overload / provably-late deadline)
            res.outcome = "shed"
        else:
            res.outcome = "error"
            res.error = f"HTTP {status}: {body[:200]}"

    def _stream_once(self, spec, res, start, deadline) -> None:
        conn, resp = self._post("generate_stream", spec, deadline)
        try:
            res.status = resp.status
            if resp.status != 200:
                self._classify_refusal(
                    res, resp.status, resp.getheader("Retry-After"),
                    resp.read().decode(errors="replace"),
                )
                return
            split = SSEFrameSplitter()
            terminal = False
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"stream outlived {self.request_timeout_s} s")
                if conn.sock is not None:  # None once the reply owns it
                    conn.sock.settimeout(left)
                chunk = resp.read1(65536)
                if not chunk:
                    break
                for frame in split.feed(chunk):
                    payload = sse_payload(frame)
                    if payload is None:
                        continue
                    if "token_ids" in payload:
                        if res.ttft_ms is None:
                            res.ttft_ms = (
                                (time.monotonic() - start) * 1e3
                            )
                        res.tokens += len(payload["token_ids"])
                        continue
                    if payload.get("done"):
                        res.outcome = "completed"
                        terminal = True
                        continue
                    if "error" in payload:
                        res.outcome = "error"
                        res.error = str(payload["error"])
                        terminal = True
            if not terminal:
                # EOF without a terminal frame — a torn stream IS a
                # client-visible failure; any torn half-frame bytes in
                # split.pending were never accounted
                res.outcome = "error"
                res.error = "stream EOF before terminal frame"
        finally:
            conn.close()

    def _unary_once(self, spec, res, deadline) -> None:
        conn, resp = self._post("generate", spec, deadline)
        try:
            res.status = resp.status
            body = resp.read()
            if resp.status != 200:
                self._classify_refusal(
                    res, resp.status, resp.getheader("Retry-After"),
                    body.decode(errors="replace"),
                )
                return
            try:
                res.tokens = len(json.loads(body).get("token_ids", ()))
            except ValueError:
                pass
            res.outcome = "completed"
        finally:
            conn.close()
