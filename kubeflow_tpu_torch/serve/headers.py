"""Request headers the port's serving path reads — copies of the JAX
package's ``obs/headers.py`` names and ``serve/deadline.py`` parsers."""

from __future__ import annotations

from typing import Mapping

#: per-request sampling seed: token t is drawn from
#: ``fold_in(PRNGKey(seed), position of t)`` (``serve/threefry.py``)
SEED_HEADER = "x-kft-seed"


def seed_from_headers(headers: Mapping[str, str] | None) -> int | None:
    """Per-request sampling seed (``x-kft-seed``), or None when unseeded
    (the engine generator's draws). A malformed value is unseeded."""
    if not headers:
        return None
    raw = headers.get(SEED_HEADER) or headers.get(SEED_HEADER.title())
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None
