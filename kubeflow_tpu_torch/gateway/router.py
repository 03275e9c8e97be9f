"""Routing decisions: host/path → service, canary split, prefix affinity.
A copy of ``kubeflow_tpu/gateway/router.py``.

Reference analogs: Istio VirtualService weighted routing + KServe's
traffic-split annotations (SURVEY.md §2.2), plus the LM-aware divergence:
vLLM-ecosystem routers send repeated prompts to the replica whose prefix
cache already holds their KV (Kwon et al., PagedAttention) — a signal only
the edge can exploit, because single replicas never see each other's
prompts.

Everything here is pure computation: no I/O, no serve-plane imports, so
``serve/controller.py`` reuses ``canary_slot`` for its own per-request
split without an import cycle.

Determinism rules (enforced by design, not convention):

- the canary decision is a **salted hash of the request id**, never RNG:
  a retried request re-hashes to the same revision, so a retry cannot
  flap default↔canary mid-rollout, and the split is exactly pct in
  expectation over distinct ids;
- affinity is a **consistent-hash ring** (64 vnodes per backend): the
  same prompt prefix lands on the same replica, and membership churn
  remaps only the keys that hashed to the lost/new vnode arcs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from bisect import bisect_right
from typing import Any, Mapping


def _h64(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def canary_slot(request_id: str, salt: str = "kft-canary") -> float:
    """Deterministic slot in [0, 100) for a request id: take the canary
    iff ``slot < canary_percent``. Salted so operators can re-shuffle which
    ids land in the canary cohort without touching client ids."""
    return _h64(f"{salt}:{request_id}") / 2.0**64 * 100.0


def pick_revision(
    request_id: str, canary_percent: float, salt: str = "kft-canary"
) -> str:
    return (
        "canary"
        if canary_percent > 0 and canary_slot(request_id, salt) < canary_percent
        else "default"
    )


class HashRing:
    """Consistent hashing over backend URLs (vnode ring)."""

    VNODES = 64

    def __init__(self, urls: tuple[str, ...]):
        points: list[tuple[int, str]] = []
        for url in urls:
            for i in range(self.VNODES):
                points.append((_h64(f"{url}#{i}"), url))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._urls = [p[1] for p in points]

    def pick(self, key: str) -> str | None:
        if not self._urls:
            return None
        i = bisect_right(self._hashes, _h64(key)) % len(self._urls)
        return self._urls[i]


@dataclasses.dataclass
class ServiceRoute:
    """Edge routing policy for one service."""

    name: str
    hosts: tuple[str, ...] = ()
    path_prefixes: tuple[str, ...] = ()
    canary_percent: float = 0.0
    #: "none" | "prefix" (LM prefix-cache affinity) | "session"
    affinity: str = "none"
    #: how much of the prompt keys the affinity hash; 16 matches the
    #: engine's prefix-cache granularity (serve/engine.py stores 16-token
    #: multiples), so requests sharing a cached prefix share a replica
    affinity_prefix_tokens: int = 16
    #: spill to least-outstanding when the affine replica is this loaded
    #: (None = always honor affinity)
    affinity_max_outstanding: int | None = None
    #: dispatch a hedged second request after this long (idempotent only)
    hedge_ms: float | None = None
    max_attempts: int = 3

    def view(self) -> dict:
        return {
            "name": self.name,
            "hosts": list(self.hosts),
            "path_prefixes": list(self.path_prefixes),
            "canary_percent": self.canary_percent,
            "affinity": self.affinity,
            "hedge_ms": self.hedge_ms,
        }

    def trace_attrs(self) -> dict:
        """Span attributes for the edge ``route`` span — only the routing
        policy that shaped THIS decision, not the whole view."""
        attrs: dict = {"service": self.name, "affinity": self.affinity}
        if self.canary_percent:
            attrs["canary_percent"] = self.canary_percent
        if self.hedge_ms is not None:
            attrs["hedge_ms"] = self.hedge_ms
        return attrs


_MODEL_PATH = re.compile(r"^/v[12]/models/([^/:]+)")
_GENERATE_PATH = re.compile(r"^/v2/models/[^/:]+/(generate|generate_stream)$")

#: model formats whose replicas hold per-process prefix KV caches — the
#: controller-fed table turns prefix affinity on for these automatically
LM_ENGINE_FORMATS = ("causal-lm-engine", "vllm", "causal-lm", "llm")


class RouteTable:
    """host/path → ``ServiceRoute``.

    Resolution order (first match wins):

    1. exact ``Host`` header match (port stripped) against ``hosts``, or a
       Knative-style first-label match (``{service}.anything``);
    2. longest declared ``path_prefixes`` match — the prefix is stripped
       before forwarding, so ``/edge/echo/v1/models/...`` proxies to
       ``/v1/models/...``;
    3. the model name baked into v1/v2 inference paths, when it names a
       registered service — zero-config for the common one-model-per-
       service layout.
    """

    def __init__(self, *, salt: str = "kft-canary"):
        self.salt = salt
        self._routes: dict[str, ServiceRoute] = {}

    def upsert(self, route: ServiceRoute) -> ServiceRoute:
        self._routes[route.name] = route
        return route

    def get(self, name: str) -> ServiceRoute | None:
        return self._routes.get(name)

    def routes(self) -> list[ServiceRoute]:
        return [self._routes[k] for k in sorted(self._routes)]

    def resolve(
        self, host: str | None, path: str
    ) -> tuple[ServiceRoute, str] | None:
        """→ ``(route, upstream_path)`` or None when nothing matches."""
        hostname = (host or "").rsplit(":", 1)[0] if host else ""
        # a snapshot: the probe thread may add a controller's route meanwhile
        routes = list(self._routes.values())
        if hostname:
            for r in routes:
                if hostname in r.hosts:
                    return r, path
            first_label = hostname.split(".", 1)[0]
            r = self._routes.get(first_label)
            if r is not None and "." in hostname:
                return r, path
        best: tuple[ServiceRoute, str] | None = None
        best_len = -1
        for r in routes:
            for prefix in r.path_prefixes:
                p = prefix.rstrip("/")
                if (path == p or path.startswith(p + "/")) and len(p) > best_len:
                    best = (r, path[len(p):] or "/")
                    best_len = len(p)
        if best is not None:
            return best
        m = _MODEL_PATH.match(path)
        if m and m.group(1) in self._routes:
            return self._routes[m.group(1)], path
        return None

    def revision_for(self, route: ServiceRoute, request_id: str) -> str:
        return pick_revision(request_id, route.canary_percent, self.salt)

    # -- controller feed ------------------------------------------------- #

    def update_from_controller(self, controller: Any) -> None:
        """Refresh the table from ``InferenceServiceController`` state:
        one route per service, Knative-style ``{name}.{namespace}`` host,
        the live canary percent (0 unless a canary materialisation is
        actually serving), and prefix affinity switched on for LM-engine
        predictors. Duck-typed (no serve-plane import, no cycle); reads
        the controller's ``services()`` snapshot, since ``apply`` may run
        on another thread."""
        for key, st in controller.services():
            namespace, name = key.split("/", 1)
            pct = st.spec.predictor.canary_traffic_percent
            live_canary = st.canary_model is not None and 0 < pct < 100
            fmt = st.spec.predictor.model_format
            prev = self._routes.get(name)
            self.upsert(
                ServiceRoute(
                    name=name,
                    hosts=(f"{name}.{namespace}",),
                    path_prefixes=prev.path_prefixes if prev else (),
                    canary_percent=float(pct) if live_canary else 0.0,
                    affinity=(
                        "prefix" if fmt in LM_ENGINE_FORMATS else "none"
                    ),
                    hedge_ms=prev.hedge_ms if prev else None,
                )
            )


# -- affinity keys ------------------------------------------------------- #


def prefix_affinity_key(tokens, n: int = 16) -> str:
    """The ring key for a token-id prompt prefix: ONE definition, so every
    caller hashes an engine prefix-cache entry to the same replica."""

    def norm(t) -> str:
        try:  # "3", 3, 3.0 → "3"; non-numeric tokens key as themselves
            return str(int(t))
        except (TypeError, ValueError):
            return str(t)

    return "prefix:" + ",".join(norm(t) for t in list(tokens)[:n])


def affinity_key_of(
    route: ServiceRoute,
    headers: Mapping[str, str],
    body: Any,
) -> str | None:
    """The stickiness key for one request, or None to fall back to
    least-outstanding. Session affinity keys on ``x-session-id``; prefix
    affinity keys on the leading ``affinity_prefix_tokens`` tokens (or
    characters, for text prompts) of the first instance — the same
    granularity the engine's prefix cache stores, so sticky requests HIT
    the replica-local cache instead of re-prefilling elsewhere."""
    if route.affinity == "session":
        sid = headers.get("x-session-id")
        return f"session:{sid}" if sid else None
    if route.affinity != "prefix":
        return None
    sid = headers.get("x-session-id")
    if sid:
        return f"session:{sid}"
    row = body
    if isinstance(body, Mapping):
        insts = body.get("instances")
        row = insts[0] if isinstance(insts, (list, tuple)) and insts else body
    prefix: Any = None
    if isinstance(row, Mapping):
        for k in ("ids", "input_ids", "prompt", "text"):
            if row.get(k) is not None:
                prefix = row[k]
                break
    elif isinstance(row, (list, tuple, str)):
        prefix = row
    if prefix is None:
        return None
    n = route.affinity_prefix_tokens
    if isinstance(prefix, str):
        # ~chars per token, close enough for keying
        return "prefix:" + prefix[: n * 4]
    return prefix_affinity_key(prefix, n)
