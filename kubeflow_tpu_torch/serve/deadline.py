"""End-to-end request deadlines and admission shedding: the port of
``kubeflow_tpu/serve/deadline.py``.

A request carries ONE budget from the edge to the card, and every hop
charges its queue and service time against it (``serve/headers.py``
names the headers). The error taxonomy, which a gateway's retry
classifier keys off:

- :class:`DeadlineExceeded`: the budget ran out (at admission, while
  queued, mid-decode, or at the caller's wait). 503 + ``Retry-After``:
  every replica would shed it alike.
- :class:`AdmissionShed`: admission control proved the deadline
  unmeetable, or a higher-priority request took the queue slot, before
  the request cost a decode slot. 503 + ``Retry-After`` with a
  backlog-drain estimate.

Both carry ``Retry-After``, the marker of a coherent load shed, against a
bare 503 (the replica broke: retry elsewhere).
"""

from __future__ import annotations

import time
from typing import Callable, Mapping

from kubeflow_tpu_torch.obs import names, prom
from kubeflow_tpu_torch.serve.headers import (  # noqa: F401 — re-export
    DEADLINE_ABS_HEADER,
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    RESUME_TOKENS_HEADER,
    SEED_HEADER,
    header_get,
)

DEADLINE_EXPIRED = prom.REGISTRY.counter(
    names.ENGINE_DEADLINE_EXPIRED_TOTAL,
    "requests retired because their end-to-end deadline expired",
    ("stage",),
)
ADMISSION_SHED = prom.REGISTRY.counter(
    names.ENGINE_ADMISSION_SHED_TOTAL,
    "requests shed by deadline-aware admission control",
    ("reason",),
)


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end budget ran out. Subclasses TimeoutError so
    ``except TimeoutError`` callers keep working.

    ``stage`` names where the budget died: ``admission`` (already expired
    on arrival), ``queued`` (retired from the admission queue before
    costing a decode slot), ``decoding`` (cancelled at an epoch
    boundary), ``wait`` (the caller's own wait)."""

    def __init__(self, message: str, *, stage: str = "wait"):
        super().__init__(message)
        self.stage = stage
        self.retry_after_s = 1.0


class AdmissionShed(RuntimeError):
    """Shed at admission, before any decode slot was consumed.

    ``reason``: ``deadline_unmeetable`` (estimated queue wait + decode
    time exceeds the remaining budget) or ``priority_evict`` (a
    higher-priority request took this one's queue slot under overload).
    ``retry_after_s`` (at least 1) estimates when the backlog drains: the
    503's ``Retry-After``."""

    def __init__(self, message: str, *, reason: str = "deadline_unmeetable",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = max(1.0, float(retry_after_s))


def deadline_from_headers(
    headers: Mapping[str, str] | None, *,
    clock: Callable[[], float] = time.monotonic,
) -> float | None:
    """Absolute monotonic deadline carried by ``headers``: the stamped
    absolute header wins, else the relative ms budget is anchored at
    ``clock()``. Absent or unparseable headers mean no deadline."""
    absolute = header_get(headers, DEADLINE_ABS_HEADER)
    if absolute is not None:
        try:
            return float(absolute)
        except ValueError:
            return None
    raw = header_get(headers, DEADLINE_HEADER)
    if raw is None:
        return None
    try:
        budget_ms = float(raw)
    except ValueError:
        return None
    return clock() + budget_ms / 1e3


def priority_from_headers(headers: Mapping[str, str] | None) -> int:
    """Tenant priority (``x-kft-priority``); 0 when absent or malformed."""
    raw = header_get(headers, PRIORITY_HEADER)
    if raw is None:
        return 0
    try:
        return int(raw)
    except ValueError:
        return 0


def remaining_s(deadline: float | None, *,
                clock: Callable[[], float] = time.monotonic) -> float | None:
    """Seconds of budget left (may be negative); None when no deadline."""
    if deadline is None:
        return None
    return deadline - clock()


def resume_from_headers(headers: Mapping[str, str] | None) -> list[int] | None:
    """Committed token ids of a resume dispatch (``x-kft-resume-tokens``,
    comma-separated ints), or None. A malformed header is no resume, not
    half a prefix: resuming from a wrong prefix would splice garbage into
    the client's stream."""
    raw = header_get(headers, RESUME_TOKENS_HEADER)
    if raw is None:
        return None
    try:
        toks = [int(t) for t in raw.split(",") if t.strip()]
    except ValueError:
        return None
    return toks or None


def seed_from_headers(headers: Mapping[str, str] | None) -> int | None:
    """Per-request sampling seed (``x-kft-seed``), or None when unseeded
    (the engine generator's draws). A malformed value is unseeded."""
    raw = header_get(headers, SEED_HEADER)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None
