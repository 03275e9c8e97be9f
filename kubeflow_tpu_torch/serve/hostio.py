"""Host↔device transfers of the engine's scheduler that never stall the
card's stream.

The pipelined loop queues decode chunk N+1 behind chunk N on one CUDA
stream and drains N while N+1 runs. Two kinds of copy would break that:

- a blocking ``.cpu()`` of chunk N's outputs waits for everything queued
  on the stream, N+1 included. :class:`OutputRing` instead copies each
  chunk's outputs at dispatch, ``non_blocking``, into a pinned host
  buffer of its own (one per chunk in flight) and records an event
  after the copy; the drain waits on that event alone.
- an H2D copy from pageable memory (``torch.tensor(np, device=cuda)``)
  synchronizes the stream. :class:`Uploader` stages every upload
  through a pinned snapshot copied ``non_blocking`` and keeps the
  snapshot alive until the copy's event has passed, so the snapshot can
  neither be freed nor reused while the card still reads it.

On a CPU engine (``device="cpu"``, the tests) there is nothing to pin and
no stream: an upload is a snapshot copy of the host array (a view would
alias the mirrors the host edits while a chunk "runs"), and a chunk's
packed outputs are already host memory. The slot bookkeeping is the
same on both devices.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


class Uploader:
    """``upload(np_array) -> device tensor`` without a stream sync."""

    def __init__(self, device: torch.device):
        self.device = device
        #: (event, pinned snapshot) of copies the card may still be reading
        self._inflight: deque[tuple[torch.cuda.Event, torch.Tensor]] = deque()

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(arr, copy=True, order="C"))
        self._reap()
        # pin_memory() copies: the snapshot is taken here, on the host
        pinned = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
        dev = pinned.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._inflight.append((event, pinned))
        return dev

    def _reap(self) -> None:
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    @property
    def held(self) -> int:
        """Pinned snapshots still held for copies not known to be done."""
        self._reap()
        return len(self._inflight)


class OutputRing:
    """Per-chunk D2H staging: ``slots`` pinned buffers, one per chunk in
    flight, used round-robin. :meth:`stage` packs a chunk's output
    tensors into one int64 ``(B, N)`` device tensor, queues its copy into
    the next free slot and records an event; :meth:`fetch` waits on that
    event and unpacks numpy arrays of the original shapes and dtypes.
    Staging into a slot whose chunk was not fetched yet is a scheduler
    bug and raises."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._bufs: list[torch.Tensor | None] = [None] * slots
        self._busy = [False] * slots
        self._next = 0
        #: chunks staged (one D2H copy each)
        self.staged = 0

    def stage(self, named: dict[str, torch.Tensor]) -> dict:
        slot = self._next
        if self._busy[slot]:
            raise RuntimeError(f"output slot {slot} reused before its drain")
        self._next = (slot + 1) % len(self._bufs)
        B = next(iter(named.values())).shape[0]
        layout = [(k, tuple(t.shape), t.dtype) for k, t in named.items()]
        packed = torch.cat(
            [t.reshape(B, -1).to(torch.int64) for t in named.values()], dim=1
        )
        event = None
        if self.device.type == "cuda":
            buf = self._bufs[slot]
            if buf is None or buf.shape != packed.shape:
                buf = self._bufs[slot] = torch.empty(
                    packed.shape, dtype=torch.int64, pin_memory=True
                )
            buf.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            buf = packed
        self._busy[slot] = True
        self.staged += 1
        return {"slot": slot, "buf": buf, "event": event, "layout": layout}

    def fetch(self, staged: dict) -> dict[str, np.ndarray]:
        if staged["event"] is not None:
            staged["event"].synchronize()
        flat = staged["buf"].numpy().copy()
        self._busy[staged["slot"]] = False
        out, col = {}, 0
        for name, shape, dtype in staged["layout"]:
            n = int(np.prod(shape[1:], dtype=np.int64))
            part = flat[:, col:col + n].reshape(shape)
            out[name] = part.astype(bool) if dtype == torch.bool else part
            col += n
        return out
