"""The ``x-kft-*`` request headers of the serving contract, copies of the
JAX package's ``obs/headers.py`` names.

- ``x-kft-deadline-ms``: the remaining end-to-end budget in
  milliseconds, client- or gateway-set (``serve/deadline.py``).
- ``x-kft-deadline-abs``: this process's absolute ``time.monotonic()``
  deadline, stamped once by the server at admission; a client's copy is
  stripped, since it never crosses a process.
- ``x-kft-priority``: integer tenant priority, higher is shed last.
- ``x-kft-trace``: W3C ``traceparent``-shaped trace context. The port
  accepts and ignores it (request tracing is ROADMAP queue 1 item 12).
- ``x-kft-prefill-peer``: the URL of a prefill replica; the decode
  replica pulls each row's finished KV span from it (``kv_span:prefill``)
  and runs no prefill, or prefills locally when the ship fails.
- ``x-kft-session``: the session id that keys the host KV tier.
- ``x-kft-resume-tokens``: comma-separated generated ids already
  committed to the client; the engine continues after them.
- ``x-kft-seed``: per-request sampling seed, token t drawn from
  ``fold_in(PRNGKey(seed), position of t)`` (``serve/threefry.py``).

Header maps may carry the lower-case name or its ``.title()`` spelling;
:func:`header_get` probes both.
"""

from __future__ import annotations

from typing import Mapping

DEADLINE_HEADER = "x-kft-deadline-ms"
DEADLINE_ABS_HEADER = "x-kft-deadline-abs"
PRIORITY_HEADER = "x-kft-priority"
TRACE_HEADER = "x-kft-trace"
PREFILL_PEER_HEADER = "x-kft-prefill-peer"
SESSION_HEADER = "x-kft-session"
RESUME_TOKENS_HEADER = "x-kft-resume-tokens"
SEED_HEADER = "x-kft-seed"


def header_get(headers: Mapping[str, str] | None, name: str) -> str | None:
    """One header's value by its lower-case name or ``.title()``
    spelling, or None."""
    if not headers:
        return None
    val = headers.get(name)
    if val is None:
        val = headers.get(name.title())
    return val
