"""SSE wire framing: ONE definition of whole-frame splitting, a copy of
``kubeflow_tpu/gateway/sse.py``.

The gateway's mid-stream failover made frame alignment a correctness
property: forwarding a torn half-frame to a client poisons its SSE
parser for every later frame, and committing tokens from a torn frame
desynchronizes the resume prefix. A load harness accounting TTFT and
token counts from the same frames shares this splitter, so torn-frame
handling has exactly one definition.
"""

from __future__ import annotations

import json

__all__ = ["SSEFrameSplitter", "sse_payload"]


class SSEFrameSplitter:
    """Incremental ``\\n\\n``-delimited whole-frame splitter.

    ``feed(chunk)`` returns the WHOLE frames completed by that chunk
    (delimiter stripped); bytes after the last delimiter stay buffered in
    ``pending`` — the torn trailing half-frame a dying upstream leaves,
    which callers must drop, never forward or account.
    """

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf += chunk
        *frames, self._buf = self._buf.split(b"\n\n")
        return frames

    @property
    def pending(self) -> bytes:
        return self._buf


def sse_payload(frame: bytes) -> dict | None:
    """The ``data:``-JSON payload of one whole SSE frame, or None for
    anything else (comments, other event types, unparseable JSON — all
    forwarded verbatim by the proxy, never interpreted)."""
    if not frame.startswith(b"data:"):
        return None
    try:
        payload = json.loads(frame[5:].strip())
    except ValueError:
        return None
    return payload if isinstance(payload, dict) else None
