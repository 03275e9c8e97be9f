"""Edge traffic policy: per-tenant rate limits, in-flight caps, retry budget.
A copy of ``kubeflow_tpu/gateway/policy.py``.

Reference analogs: Istio local rate limiting + Envoy's retry budgets as
KServe deploys them, and the Kubeflow profile controller's per-namespace
quota posture (SURVEY.md §2.5). A tenant here is a profile namespace —
``PolicyEngine.from_profiles`` reads the serving fields off
``platform/profiles.py`` ``ResourceQuota`` so the SAME object that caps a
namespace's training chips caps its serving traffic.

- ``TokenBucket`` — classic rate/burst, injectable clock (tests never
  sleep); exhaustion ⇒ ``RateLimited`` ⇒ 429 with Retry-After;
- max-in-flight — concurrent requests per tenant; breach ⇒
  ``TooManyInFlight`` ⇒ 429;
- ``RetryBudget`` — transparent retries are bounded to a fraction of
  observed traffic (plus a small floor so cold gateways can still retry),
  so a dying backend cannot double the fleet's load via retry storms.

The JAX gateway calls these from one event loop; the port's gateway
serves a thread a connection, so ``PolicyEngine.acquire``/``release``
(which hold a tenant's bucket while they run) and
``RetryBudget.on_request``/``try_spend`` take a lock. The arithmetic is
the reference's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable


class RateLimited(Exception):
    pass


class TooManyInFlight(Exception):
    pass


class TokenBucket:
    def __init__(
        self,
        rate: float,
        burst: float | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()

    def allow(self, n: float = 1.0) -> bool:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate
        )
        self._stamp = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


@dataclasses.dataclass
class TenantPolicy:
    bucket: TokenBucket | None = None
    max_in_flight: int | None = None
    in_flight: int = 0
    #: shed order under sustained overload (higher = shed LAST): the
    #: gateway stamps this as ``x-kft-priority`` and the engine's
    #: admission control evicts the lowest-priority queued request first
    priority: int = 0


class PolicyEngine:
    """Admission at the edge, keyed by the ``x-kft-tenant`` header value
    (profile namespace). Tenants without a policy are unmanaged."""

    def __init__(self, policies: dict[str, TenantPolicy] | None = None):
        self._policies: dict[str, TenantPolicy] = dict(policies or {})
        self._lock = threading.Lock()

    @classmethod
    def from_profiles(
        cls,
        profiles: Any,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> "PolicyEngine":
        """One tenant policy per profile, from its quota's serving fields
        (``max_rps``/``burst``/``max_concurrent_requests``/``priority``).
        Duck-typed: ``profiles.list()`` yields objects with ``name`` and
        ``quota``."""
        policies: dict[str, TenantPolicy] = {}
        for p in profiles.list():
            q = p.quota
            rps = getattr(q, "max_rps", None)
            cap = getattr(q, "max_concurrent_requests", None)
            if rps is None and cap is None:
                continue
            policies[p.name] = TenantPolicy(
                bucket=(
                    TokenBucket(rps, getattr(q, "burst", None), clock=clock)
                    if rps is not None
                    else None
                ),
                max_in_flight=cap,
                priority=int(getattr(q, "priority", 0) or 0),
            )
        return cls(policies)

    def set(self, tenant: str, policy: TenantPolicy) -> None:
        self._policies[tenant] = policy

    def priority_of(self, tenant: str) -> int | None:
        """The tenant's shed priority, or None when unmanaged (the
        gateway only overwrites ``x-kft-priority`` for managed tenants —
        it is authoritative for them, a client cannot self-promote)."""
        pol = self._policies.get(tenant)
        return pol.priority if pol is not None else None

    def acquire(self, tenant: str) -> None:
        pol = self._policies.get(tenant)
        if pol is None:
            return
        with self._lock:
            # cap before bucket: a request rejected on concurrency must not
            # also burn a rate token the client never got to use
            if (pol.max_in_flight is not None
                    and pol.in_flight >= pol.max_in_flight):
                raise TooManyInFlight(
                    f"tenant {tenant!r} at max in-flight ({pol.max_in_flight})"
                )
            if pol.bucket is not None and not pol.bucket.allow():
                raise RateLimited(f"tenant {tenant!r} over its request rate")
            pol.in_flight += 1

    def release(self, tenant: str) -> None:
        pol = self._policies.get(tenant)
        if pol is not None:
            with self._lock:
                pol.in_flight = max(0, pol.in_flight - 1)

    def view(self) -> dict:
        return {
            tenant: {
                "max_in_flight": pol.max_in_flight,
                "in_flight": pol.in_flight,
                "rate": pol.bucket.rate if pol.bucket else None,
                "priority": pol.priority,
            }
            for tenant, pol in sorted(self._policies.items())
        }


class RetryBudget:
    """Envoy-style retry budget: retries may be at most ``ratio`` of the
    requests seen so far, plus ``floor`` so the first failures are always
    retryable. Cumulative counters — cheap, deterministic, observable."""

    def __init__(self, *, ratio: float = 0.2, floor: int = 3):
        self.ratio = ratio
        self.floor = floor
        self.requests = 0
        self.retries = 0
        self._lock = threading.Lock()

    def on_request(self) -> None:
        with self._lock:
            self.requests += 1

    def try_spend(self) -> bool:
        with self._lock:
            if self.retries < self.floor + self.ratio * self.requests:
                self.retries += 1
                return True
            return False
