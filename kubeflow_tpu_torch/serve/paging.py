"""Paged KV-cache allocator: the vLLM block-table analog.

A copy of ``kubeflow_tpu/serve/paging.py:PageAllocator``'s host-side
numpy bookkeeping; the engine uploads the table slices its device
programs read (each a snapshot). The pool is ONE flat
token axis per layer — ``(kv_heads, pool_tokens, head_dim)`` — and a
row's logical token ``j`` lives at pool token ``table[row, j // P] * P +
j % P``. Pages are allocated at admission for the request's whole worst
case (prompt + max_new_tokens), so a row never runs out mid-decode. Page
0 is a scratch page: writes that must go nowhere (pad positions, dead
rows still stepping in the batch) land there and nothing reads it.
"""

from __future__ import annotations

import numpy as np


class PageAllocator:
    """Host-side page bookkeeping: ``table`` maps (row, page ordinal) →
    pool page; unallocated entries point at the scratch page 0."""

    def __init__(
        self, *, pool_tokens: int, page_size: int, max_batch: int,
        max_pages_per_row: int,
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
        #: pages 1..N-1 allocatable; 0 is the scratch page
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}  # row → pages
        self.table = np.zeros((max_batch, max_pages_per_row), np.int32)

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

    def free(self, row: int) -> None:
        pages = self._owned.pop(row, None)
        if pages:
            self._free.extend(pages)
            self.table[row, :] = 0

    def stats(self) -> dict:
        """Pool pressure, exported on ``/metrics`` as
        ``kubeflow_tpu_engine_kv_<key>``."""
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages - 1,
            "pages_used": self.used_pages,
            "rows_resident": len(self._owned),
        }
