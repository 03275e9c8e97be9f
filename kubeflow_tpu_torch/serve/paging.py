"""Paged KV-cache allocator: the vLLM block-table analog.

A copy of ``kubeflow_tpu/serve/paging.py:PageAllocator`` (host-side numpy
bookkeeping) whose device mirror is a torch tensor. The pool is ONE flat
token axis per layer — ``(kv_heads, pool_tokens, head_dim)`` — and a
row's logical token ``j`` lives at pool token ``table[row, j // P] * P +
j % P``. Pages are allocated at admission for the request's whole worst
case (prompt + max_new_tokens), so a row never runs out mid-decode. Page
0 is a scratch page: writes that must go nowhere (pad positions, dead
rows still stepping in the batch) land there and nothing reads it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class PageAllocator:
    """Host-side page bookkeeping + the block table device operand.

    ``table`` maps (row, page ordinal) → pool page; unallocated entries
    point at the scratch page 0. ``upload`` turns a host array into its
    device copy (the engine's ``Uploader.upload``: a snapshot, staged so
    it never stalls a chunk in flight).
    """

    def __init__(
        self, *, pool_tokens: int, page_size: int, max_batch: int,
        max_pages_per_row: int, upload: Callable[[np.ndarray], torch.Tensor],
    ):
        if page_size < 16 or page_size % 16:
            raise ValueError(f"page_size must be a 16-multiple, got {page_size}")
        if pool_tokens % page_size:
            raise ValueError(
                f"pool_tokens {pool_tokens} must be a multiple of "
                f"page_size {page_size}"
            )
        self.page_size = page_size
        self.num_pages = pool_tokens // page_size
        if self.num_pages < 2:
            raise ValueError("pool must hold at least 2 pages (1 is scratch)")
        self.max_pages_per_row = max_pages_per_row
        self._upload = upload
        #: pages 1..N-1 allocatable; 0 is the scratch page
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}  # row → pages
        self.table = np.zeros((max_batch, max_pages_per_row), np.int32)
        #: ``version`` bumps on every alloc/free; ``device_table`` keeps one
        #: upload per (version, width)
        self.version = 0
        self._dev: dict[int, tuple[int, torch.Tensor]] = {}

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def can_alloc(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def alloc(self, row: int, n_pages: int) -> None:
        if row in self._owned:
            raise RuntimeError(f"row {row} already holds pages")
        if n_pages > self.max_pages_per_row:
            raise ValueError(
                f"{n_pages} pages exceeds max_pages_per_row "
                f"{self.max_pages_per_row}"
            )
        if n_pages > len(self._free):
            raise RuntimeError(
                f"pool exhausted: need {n_pages}, have {len(self._free)}"
            )
        pages = [self._free.pop() for _ in range(n_pages)]
        self._owned[row] = pages
        self.table[row, :] = 0
        self.table[row, : len(pages)] = pages
        self.version += 1

    def free(self, row: int) -> None:
        pages = self._owned.pop(row, None)
        if pages:
            self._free.extend(pages)
            self.table[row, :] = 0
            self.version += 1

    def device_table(self, width: int) -> torch.Tensor:
        """Device ``table[:, :width]`` (int32), uploaded again only when the
        host table changed since the last upload at this width. It is a
        SNAPSHOT: a later alloc/free must not rewrite what an in-flight
        step reads."""
        ver, arr = self._dev.get(width, (-1, None))
        if ver != self.version or arr is None:
            self._dev = {
                w: va for w, va in self._dev.items() if va[0] == self.version
            }
            arr = self._upload(self.table[:, :width])
            self._dev[width] = (self.version, arr)
        return arr

    def device_row(self, row: int, width: int | None = None) -> torch.Tensor:
        """Device snapshot of one row's table, ``(1, width)`` (all of it
        when ``width`` is None) — a prefill piece's or a prefix copy's."""
        w = self.max_pages_per_row if width is None else width
        return self._upload(self.table[row: row + 1, :w])

    def stats(self) -> dict:
        """Pool pressure, exported on ``/metrics`` as
        ``kubeflow_tpu_engine_kv_<key>``."""
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages - 1,
            "pages_used": self.used_pages,
            "rows_resident": len(self._owned),
        }
