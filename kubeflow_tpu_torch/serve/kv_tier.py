"""Host-RAM KV tier below the paged pool — the port's copy of the JAX
package's ``serve/kv_tier.py`` (``HostKVTier``, unchanged).

The pool bounds how many sessions stay resident on the card, not how
many stay warm. When a sessioned request finishes, the engine extracts
the row's KV span, encodes it through the codec that ships spans between
replicas (``serve/kv_codec.py``) and parks the bytes here: a bounded,
LRU-evicted host pool keyed by session id. The session's next turn finds
the stored span, checks that its tokens are a prefix of the new prompt,
and implants it back, byte for byte, so the continuation decodes as if
the row had never left the card.

- **Encoded bytes, not arrays**: the byte budget is the host memory the
  blobs really take (an int8 span is about half a bf16 one), and a
  swap-in runs the same decode path as a cross-replica ship.
- **Thread-safe, clock-free**: ``put`` and ``take`` run on the engine's
  offload and scheduler threads; eviction is LRU by access order.
- **Swap-in consumes the entry** (``take``): the implanted row is the
  live copy, and a stale host copy must never come back after further
  decode extends the session.
- A resumed stream (``x-kft-resume-tokens``) admits prompt + committed
  tokens as one prompt; a parked span whose key those extend implants
  in place of the prefill.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class HostKVTier:
    """Bounded host-RAM pool of encoded KV spans, keyed by session id.

    ``max_bytes`` caps the sum of stored blob sizes; inserting past it
    LRU-evicts (least recently stored/probed first). One entry per
    session: a newer turn's span replaces the older one in place.
    """

    def __init__(self, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0; got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        #: session → (tokens_tuple, blob); OrderedDict order = LRU→MRU
        self._entries: "OrderedDict[str, tuple[tuple, bytes]]" = OrderedDict()
        self._bytes = 0
        self.stats = {"puts": 0, "hits": 0, "misses": 0, "evictions": 0}

    def put(self, session: str, tokens, blob: bytes) -> bool:
        """Store ``blob`` (an encoded KV span whose entry key is
        ``tokens``) for ``session``. A blob alone larger than the whole
        pool is refused (never evict everything for one row). Returns
        True when stored."""
        if len(blob) > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(session, None)
            if old is not None:
                self._bytes -= len(old[1])
            self._entries[session] = (tuple(int(t) for t in tokens), blob)
            self._bytes += len(blob)
            self.stats["puts"] += 1
            while self._bytes > self.max_bytes:
                _, (_, old_blob) = self._entries.popitem(last=False)
                self._bytes -= len(old_blob)
                self.stats["evictions"] += 1
        return True

    def take(self, session: str, prompt_ids) -> bytes | None:
        """Consume the stored span for ``session`` IF its tokens are a
        proper prefix of ``prompt_ids`` (at least one token must remain
        to prefill — same rule as the prefix cache). A session whose new
        prompt diverged from the stored context drops the entry: its KV
        can never be valid again."""
        with self._lock:
            entry = self._entries.get(session)
            if entry is None:
                self.stats["misses"] += 1
                return None
            tokens, blob = entry
            n = len(tokens)
            if n >= len(prompt_ids) or tuple(
                int(t) for t in prompt_ids[:n]
            ) != tokens:
                del self._entries[session]
                self._bytes -= len(blob)
                self.stats["misses"] += 1
                return None
            del self._entries[session]
            self._bytes -= len(blob)
            self.stats["hits"] += 1
            return blob

    def resident(self) -> dict:
        """Live occupancy for /metrics (kft_engine_kv_offload_*)."""
        with self._lock:
            return {"bytes": self._bytes, "rows": len(self._entries)}
