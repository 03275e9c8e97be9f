"""Workload mixtures: what each arrival actually asks the platform to do.
A copy of ``kubeflow_tpu/loadgen/workload.py`` (pure Python).

An arrival schedule says *when*; the mix says *what* — prompt length,
output budget, and the per-tenant wire headers (deadline, priority,
adapter) that drive the gateway's policy plane and the engine's
deadline-aware admission. Like the schedule, the whole plan is a value:
``WorkloadMix.plan(n)`` derives every draw from the mix seed alone, so a
re-run offers the identical request sequence and any goodput delta is the
platform's, not the generator's.

Tenants model the SLO shapes production mixes: an interactive tenant
with a tight deadline and high priority, a batch tenant with no deadline
riding standby capacity, each optionally pinned to a named adapter
(:data:`~kubeflow_tpu_torch.serve.headers.ADAPTER_HEADER`). ``slo_ms`` is the
*accounting* SLO the reporter scores goodput against; ``deadline_ms`` is
what gets stamped on the wire (and so what the platform may shed against)
— by default they coincide.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Sequence

from kubeflow_tpu_torch.serve.headers import (
    ADAPTER_HEADER,
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    TENANT_HEADER,
)

__all__ = ["TenantSpec", "RequestSpec", "WorkloadMix"]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class: selection weight, wire headers, accounting SLO."""

    name: str
    weight: float = 1.0
    priority: int | None = None
    deadline_ms: float | None = None
    adapter: str | None = None
    #: goodput SLO in ms (completed within → goodput); None falls back to
    #: ``deadline_ms``; both None → any completion counts
    slo_ms: float | None = None

    @property
    def effective_slo_ms(self) -> float | None:
        return self.slo_ms if self.slo_ms is not None else self.deadline_ms

    def headers(self) -> dict[str, str]:
        h = {TENANT_HEADER: self.name}
        if self.priority is not None:
            h[PRIORITY_HEADER] = str(self.priority)
        if self.deadline_ms is not None:
            h[DEADLINE_HEADER] = str(int(self.deadline_ms))
        if self.adapter is not None:
            h[ADAPTER_HEADER] = self.adapter
        return h


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One fully-drawn request: everything the client needs to fire it."""

    index: int
    tenant: str
    prompt_ids: tuple[int, ...]
    max_new_tokens: int
    headers: tuple[tuple[str, str], ...]
    slo_ms: float | None
    priority: int | None


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    """Weighted prompt/output-length mixture over a tenant population."""

    prompt_lens: tuple[int, ...] = (8, 16, 32)
    prompt_weights: tuple[float, ...] | None = None
    output_lens: tuple[int, ...] = (4, 8, 16)
    output_weights: tuple[float, ...] | None = None
    tenants: tuple[TenantSpec, ...] = (TenantSpec("default"),)
    #: prompt token ids are drawn uniformly from [2, 2+vocab) — id 0/1
    #: stay clear of pad/EOS conventions in the bench models
    vocab: int = 80
    seed: int = 0

    def tenant_named(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def plan(self, n: int) -> tuple[RequestSpec, ...]:
        """The first ``n`` requests of this mix — pure function of
        ``(mix, seed, n)``; a longer plan extends a shorter one."""
        rng = random.Random(f"{self.seed}:workload")
        weights = list(self.prompt_weights or [1.0] * len(self.prompt_lens))
        oweights = list(self.output_weights or [1.0] * len(self.output_lens))
        tweights = [t.weight for t in self.tenants]
        out: list[RequestSpec] = []
        for i in range(n):
            tenant = rng.choices(self.tenants, weights=tweights)[0]
            plen = rng.choices(self.prompt_lens, weights=weights)[0]
            out_len = rng.choices(self.output_lens, weights=oweights)[0]
            prompt = tuple(
                rng.randrange(2, 2 + self.vocab) for _ in range(plen)
            )
            out.append(RequestSpec(
                index=i,
                tenant=tenant.name,
                prompt_ids=prompt,
                max_new_tokens=out_len,
                headers=tuple(sorted(tenant.headers().items())),
                slo_ms=tenant.effective_slo_ms,
                priority=tenant.priority,
            ))
        return tuple(out)

    def plan_for_replay(
        self, requests: Sequence, *, cap_new_tokens: int | None = None
    ) -> tuple[RequestSpec, ...]:
        """Request specs shaped by a replay dump: prompt length and output
        budget come from each :class:`~.arrivals.ReplayRequest` (token IDS
        are re-drawn from the seed — a trace dump records lengths, not
        content), tenant headers still draw from this mix."""
        rng = random.Random(f"{self.seed}:replay")
        tweights = [t.weight for t in self.tenants]
        out: list[RequestSpec] = []
        for i, r in enumerate(requests):
            tenant = rng.choices(self.tenants, weights=tweights)[0]
            new = r.max_new_tokens or self.output_lens[0]
            if cap_new_tokens is not None:
                new = min(new, cap_new_tokens)
            prompt = tuple(
                rng.randrange(2, 2 + self.vocab)
                for _ in range(max(1, r.prompt_tokens))
            )
            out.append(RequestSpec(
                index=i,
                tenant=tenant.name,
                prompt_ids=prompt,
                max_new_tokens=new,
                headers=tuple(sorted(tenant.headers().items())),
                slo_ms=tenant.effective_slo_ms,
                priority=tenant.priority,
            ))
        return tuple(out)
