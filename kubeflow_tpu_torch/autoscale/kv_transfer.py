"""Cross-replica prefix-KV transfer planning and execution. A copy of
``kubeflow_tpu/autoscale/kv_transfer.py`` on the port's hash ring, with
the pulls on ``http.client``.

The gateway's consistent-hash ring pins a prompt prefix to one replica
(gateway/router.py), and that replica's engine holds the prefix's KV.
When membership changes — a cold replica scales up, or a replica drains
away — the ring remaps some prefixes to replicas that never prefilled
them. Without transfer, every remapped prompt pays a full re-prefill on
its new owner; with it, the new owner PULLS the stored entries it now
owns from the replica that has them (the previous owner), over the
ModelServer peer routes (``/v2/models/{m}/prefix_cache*``).

``plan_rebalance`` is pure:

- entries whose owner did not change are never moved (consistent hashing
  keeps remap volume ~K/N);
- an entry resident on several replicas transfers at most once, and not
  at all when the new owner already holds it;
- each transfer's SOURCE is a replica that actually holds the entry —
  the previous owner — so the pull needs no third party.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
from typing import Mapping, Sequence

from kubeflow_tpu_torch.autoscale.signals import http_call
from kubeflow_tpu_torch.gateway.router import HashRing, prefix_affinity_key


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One pull: ``dest`` fetches ``keys`` from ``source``."""

    dest: str
    source: str
    keys: tuple[tuple[int, ...], ...]


def owner_of(
    key: Sequence[int], ring: HashRing, *, prefix_tokens: int = 16
) -> str | None:
    """The replica a stored prefix entry belongs to under ``ring`` — the
    SAME hash the gateway's prefix affinity routes live traffic by."""
    return ring.pick(prefix_affinity_key(key, prefix_tokens))


def plan_rebalance(
    index_by_url: Mapping[str, Sequence[Sequence[int]]],
    urls: Sequence[str],
    *,
    prefix_tokens: int = 16,
) -> list[Transfer]:
    """Plan the pulls that move every stored entry to its ring owner.

    ``index_by_url`` maps each replica (including ones leaving the set)
    to the prefix keys it currently holds; ``urls`` is the POST-remap
    membership the ring is built over. Deterministic: iteration orders
    are sorted, so the same cluster state always yields the same plan.
    """
    if not urls:
        return []
    ring = HashRing(tuple(sorted(set(urls))))
    have: dict[str, set[tuple[int, ...]]] = {u: set() for u in urls}
    for url, keys in index_by_url.items():
        have.setdefault(url, set()).update(tuple(k) for k in keys)
    pulls: dict[tuple[str, str], list[tuple[int, ...]]] = {}
    for url in sorted(index_by_url):
        for key in sorted(tuple(k) for k in index_by_url[url]):
            owner = owner_of(key, ring, prefix_tokens=prefix_tokens)
            if owner is None or owner == url:
                continue  # unmoved: consistent hashing's whole point
            if key in have[owner]:
                continue  # the owner already holds it (or a pull is planned)
            have[owner].add(key)
            pulls.setdefault((owner, url), []).append(key)
    return [
        Transfer(dest=dest, source=source, keys=tuple(keys))
        for (dest, source), keys in sorted(pulls.items())
    ]


def fetch_index(url: str, model: str, *,
                timeout_s: float = 10.0) -> list[tuple[int, ...]]:
    """One replica's prefix-cache index (empty on any failure — a replica
    that cannot answer simply contributes nothing to the plan)."""
    try:
        status, body = http_call(f"{url}/v2/models/{model}/prefix_cache",
                                 timeout_s=timeout_s)
        if status != 200:
            return []
        return [tuple(int(t) for t in k)
                for k in json.loads(body).get("keys", [])]
    except (OSError, http.client.HTTPException, ValueError):
        return []


def run_transfers(
    model: str,
    transfers: Sequence[Transfer],
    *,
    timeout_s: float = 60.0,
) -> int:
    """Execute a plan: tell each dest to pull its keys from its source.
    Returns the number of entries actually imported. Failures are
    skipped — a missed transfer costs one re-prefill, never correctness."""
    imported = 0
    for t in transfers:
        try:
            status, body = http_call(
                f"{t.dest}/v2/models/{model}/prefix_cache:pull",
                body=json.dumps({"peer": t.source,
                                 "keys": [list(k) for k in t.keys]}).encode(),
                headers={"content-type": "application/json"},
                timeout_s=timeout_s,
            )
            if status == 200:
                imported += int(json.loads(body).get("imported", 0))
        except (OSError, http.client.HTTPException, ValueError):
            continue
    return imported


def rebalance(
    model: str,
    urls: Sequence[str],
    *,
    index_urls: Sequence[str] | None = None,
    prefix_tokens: int = 16,
    timeout_s: float = 60.0,
) -> int:
    """Full cycle: index every replica, plan, pull. ``index_urls`` may
    include replicas about to leave (scale-down evacuation: their entries
    move to the survivors that now own them). Returns entries moved."""
    sources = list(index_urls) if index_urls is not None else list(urls)
    index_by_url = {
        url: fetch_index(url, model, timeout_s=timeout_s) for url in sources
    }
    plan = plan_rebalance(index_by_url, urls, prefix_tokens=prefix_tokens)
    if not plan:
        return 0
    return run_transfers(model, plan, timeout_s=timeout_s)
