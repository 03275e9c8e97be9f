"""Deterministic synthetic LM data: a numpy copy of the JAX package's
``data/synthetic.py`` ``TokenLMDataset`` and ``local_shard_iterator``.

The same arguments give bit-equal batches in both packages (the same
``np.random.RandomState`` draws in the same order), so the port and the
JAX trainer can be held against each other step by step. Batches are
host numpy arrays; the trainer's fetcher places them on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenLMDataset:
    """Language-model surrogate: an order-1 Markov token stream with
    ``branching`` successors per token, so an LM's loss falls below the
    uniform entropy without any corpus."""

    vocab_size: int = 512
    seq_len: int = 128
    seed: int = 0
    branching: int = 4

    def _table(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed + 7)
        return rng.randint(
            0, self.vocab_size, size=(self.vocab_size, self.branching)
        )

    def batch(self, batch_size: int, *, step: int, offset: int = 0) -> dict:
        """``{"inputs", "targets"}`` int32 ``(batch_size, seq_len)`` for
        ``(step, offset)``; targets are inputs shifted by one."""
        rng = np.random.RandomState(
            (self.seed * 999_983 + step * 1009 + offset * 13) % (2**31 - 1)
        )
        table = self._table()
        toks = np.empty((batch_size, self.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.randint(0, self.vocab_size, size=batch_size)
        choices = rng.randint(0, self.branching, size=(batch_size, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = table[toks[:, t], choices[:, t]]
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def local_shard_iterator(
    dataset,
    global_batch: int,
    *,
    process_index: int = 0,
    process_count: int = 1,
    start_step: int = 0,
    host_cost_ms: float = 0.0,
) -> Iterator:
    """Process ``process_index`` of ``process_count`` draws only its shard
    (``offset=process_index``) of each global batch, which ``step``
    defines. The port runs one process until the distributed slice lands,
    hence the defaults. ``host_cost_ms`` adds a fixed per-batch host delay
    that emulates decode/augment cost."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by {process_count} hosts"
        )
    local = global_batch // process_count
    step = start_step
    while True:
        if host_cost_ms > 0:
            time.sleep(host_cost_ms / 1e3)
        yield dataset.batch(local, step=step, offset=process_index)
        step += 1
