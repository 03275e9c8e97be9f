"""Continuous-batching LM engine over a paged KV pool — the port of
``kubeflow_tpu/serve/engine.py:LMEngine`` (paged mode, ``pipeline_depth=0``).

Requests join and leave a running decode batch of ``max_batch`` rows:

- **Admission** claims a free row and the request's whole page budget
  (prompt + max_new_tokens) from the pool; when the pool is short the
  request is HELD (FIFO: nothing admits past it) until completions free
  pages. The prompt, padded to its prefill bucket, is prefilled in one
  forward that writes its K/V through the block table and samples the
  first token.
- **Decode runs in chunks** of ``chunk_steps`` steps for all rows (dead
  rows step too and write to the scratch page). The per-row arrays go to
  the device once per chunk and the tokens come back once per chunk; the
  host credits them, retires rows on EOS or budget and recycles them.
- A row's token space is contiguous, so position == token index and the
  model's paged branch derives causal and window masks from positions.

Greedy token streams are identical to the JAX engine's on the same
weights (pinned by ``tests/test_torch_engine.py``). The settings of the
JAX ``LMEngineConfig`` that this port does not implement yet raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_paged_kv_cache,
    init_weights,
)
from kubeflow_tpu_torch.serve.generate import sample_logits
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.paging import PageAllocator

#: idle park bound — every waker (submit, cancel, stop) sets ``_work``, so
#: this timeout is only a belt-and-braces sweep, not a poll
_IDLE_PARK_S = 5.0


@dataclass
class LMEngineConfig:
    """Engine knobs, with the JAX ``LMEngineConfig``'s names and defaults
    except ``pipeline_depth`` (0 until the pipelined loop is ported).
    Every field can also be given to ``LMEngine(...)`` as a keyword."""

    max_batch: int = 8
    max_seq: int = 256
    chunk_steps: int = 8
    prefill_buckets: tuple[int, ...] = (32, 128)
    eos_id: int = 1
    pad_id: int = 0
    seed: int = 0
    max_queue: int = 64
    prefix_cache_entries: int = 0
    prefix_cache_tokens: int | None = None
    prefill_chunk: int | None = None
    mesh: Any = None
    rules: Any = None
    kv_pool_tokens: int | None = None
    page_size: int | None = 64
    pipeline_depth: int = 0
    spec_draft_tokens: int = 0
    spec_ngram: int = 3
    paged_attn_impl: str = "gather"
    kv_quant: str = "none"
    host_kv_bytes: int = 0


def _reject_unported(c: LMEngineConfig) -> None:
    """Settings of the JAX engine this slice does not implement raise."""
    unported = [
        (c.kv_pool_tokens is None,
         "dense KV mode (kv_pool_tokens=None)", "queue 1 item 3"),
        (c.pipeline_depth == 1,
         "the pipelined loop (pipeline_depth=1)", "queue 1 item 6c"),
        (c.spec_draft_tokens > 0,
         "speculative decoding (spec_draft_tokens>0)", "queue 1 items 5, 6d"),
        (c.prefix_cache_entries > 0 or c.prefix_cache_tokens is not None,
         "the prefix cache", "queue 1 item 6f"),
        (c.prefill_chunk is not None,
         "chunked prefill (prefill_chunk)", "queue 1 item 6f"),
        (c.host_kv_bytes > 0,
         "the host KV tier (host_kv_bytes>0)", "queue 1 item 6f"),
        (c.mesh is not None or c.rules is not None,
         "tensor-parallel serving (mesh/rules)", "queue 1 item 10"),
        (c.page_size is None,
         "the measured page-size table (page_size=None)", "queue 2 item 5"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})"
            )
    if c.pipeline_depth not in (0, 1):
        raise ValueError(f"pipeline_depth must be 0 or 1; got {c.pipeline_depth}")
    if c.spec_draft_tokens < 0:
        raise ValueError(
            f"spec_draft_tokens must be >= 0; got {c.spec_draft_tokens}"
        )
    if c.paged_attn_impl not in ("gather", "kernel"):
        raise ValueError(
            f"paged_attn_impl must be 'gather' or 'kernel'; "
            f"got {c.paged_attn_impl!r}"
        )
    if c.kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant must be 'none' or 'int8'; got {c.kv_quant!r}")


def _reject_per_request(seed, resume_tokens) -> None:
    if seed is not None or resume_tokens:
        raise NotImplementedError(
            "per-request seed / resume is not ported yet (ROADMAP queue 1 "
            "item 6f)"
        )


class EngineOverloaded(RuntimeError):
    """Admission queue full — callers should shed load (HTTP 429)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed; ``stage`` says where."""

    def __init__(self, msg: str, *, stage: str):
        super().__init__(msg)
        self.stage = stage


@dataclass
class _Request:
    ids: list[int]
    max_new_tokens: int
    temperature: float
    done: threading.Event = field(default_factory=threading.Event)
    tokens: list[int] = field(default_factory=list)
    error: Exception | None = None
    # streaming consumers get every appended token incrementally
    live: "queue.Queue[list[int] | None] | None" = None
    # consumer walked away: free the row at the next chunk boundary
    cancelled: threading.Event = field(default_factory=threading.Event)
    # end-to-end deadline (absolute time.monotonic())
    deadline: float | None = None
    t_enqueue: float = 0.0
    t_first: float = 0.0

    def push(self, toks: list[int]) -> None:
        if toks and not self.tokens:
            self.t_first = time.monotonic()
        self.tokens.extend(toks)
        if self.live is not None and toks:
            self.live.put(list(toks))

    def finish(self) -> None:
        if self.live is not None:
            self.live.put(None)  # stream sentinel
        self.done.set()


@dataclass
class _Chunk:
    """One dispatched decode chunk: device outputs plus the slot snapshot
    at dispatch, so the drain credits tokens to the right requests."""

    toks: torch.Tensor       # (B, T) tokens (pad where not valid)
    valid: torch.Tensor      # (B, T)
    last_tok: torch.Tensor   # (B,) post-chunk carry token
    gen_count: torch.Tensor  # (B,) post-chunk generation counts
    active_out: torch.Tensor  # (B,) post-chunk liveness
    active_in: np.ndarray    # (B,) liveness at dispatch
    slots: list


class LMEngine:
    """Continuous-batching engine over a ``TransformerLM`` (weights loaded,
    on its device). ``submit()`` is thread-safe and blocks until the
    completion is ready; concurrent submitters share decode chunks."""

    def __init__(
        self,
        model: TransformerLM,
        *,
        config: LMEngineConfig | None = None,
        **overrides,
    ):
        config = config or LMEngineConfig()
        if overrides:
            config = _dc_replace(config, **overrides)
        _reject_unported(config)
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError("LMEngine needs a causal TransformerConfig")
        self.model = model
        self.device = model.device
        self.max_batch, self.max_seq = config.max_batch, config.max_seq
        self.chunk_steps = config.chunk_steps
        self.prefill_buckets = tuple(sorted(config.prefill_buckets))
        self.eos_id, self.pad_id = config.eos_id, config.pad_id
        self.max_queue = config.max_queue
        self.page_size = config.page_size
        self.paged_attn_impl = config.paged_attn_impl
        self.kv_quant = config.kv_quant
        self.pager = PageAllocator(
            pool_tokens=config.kv_pool_tokens,
            page_size=config.page_size,
            max_batch=config.max_batch,
            max_pages_per_row=-(-config.max_seq // config.page_size),
            device=self.device,
        )
        self.cache = init_paged_kv_cache(
            cfg, config.kv_pool_tokens, kv_quant=self.kv_quant,
            device=self.device,
        )
        #: sampling noise for temperature > 0 rows (threefry's stream is
        #: not reproducible here; greedy rows never read it)
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)

        B = config.max_batch
        # per-row host mirrors; they ride to the device once per chunk
        self.real_len = np.zeros((B,), np.int64)   # prompt length
        self.gen_count = np.zeros((B,), np.int64)  # tokens so far
        self.budget = np.zeros((B,), np.int64)     # max_new_tokens
        self.last_tok = np.zeros((B,), np.int64)
        self.active = np.zeros((B,), bool)
        self.temp = np.zeros((B,), np.float32)
        self._slots: list[_Request | None] = [None] * B
        #: a request held back by page backpressure (FIFO preserved)
        self._held: _Request | None = None

        self._pending: queue.Queue[_Request] = queue.Queue()
        self._fatal: Exception | None = None
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {
            "admitted": 0, "completed": 0, "chunks": 0, "max_concurrent": 0,
            "prefill_pieces": 0, "idle_wakes": 0, "page_holds": 0,
            "kv_pages_used_peak": 0,
            "deadline_expired_queued": 0, "deadline_expired_decoding": 0,
        }
        #: time to first token of recent completions, milliseconds
        #: (enqueue → first token on the host)
        self.ttft_ms: deque[float] = deque(maxlen=1024)

    # -- device programs ---------------------------------------------------- #

    def _pages_w(self, tokens: int) -> int:
        """Read-window width in pages: pow2-rounded (as the JAX engine, so
        both read the same windows), capped at the per-row maximum."""
        need = -(-tokens // self.page_size)
        w = 1
        while w < need:
            w *= 2
        return min(w, self.pager.max_pages_per_row)

    def _suffix_prefill(self, piece, slen, table, temperature):
        """One row's prefill piece writes tokens [0, S) through its block
        table (pad positions >= slen go to the scratch page) and samples
        the token after the last real one."""
        S = piece.shape[1]
        ar = torch.arange(S, device=self.device)
        logits, _ = self.model(
            piece, cache=self.cache, positions=ar[None, :],
            page_table=table, page_size=self.page_size,
            page_write_ok=(ar < slen)[None, :],
            paged_attn_impl=self.paged_attn_impl, kv_quant=self.kv_quant,
        )
        tok = sample_logits(logits[:, slen - 1], temperature, self._gen)[0]
        return tok, tok != self.eos_id

    def _chunk_paged(self, c: dict):
        """``chunk_steps`` decode steps for all rows (a Python loop where
        the JAX engine scans). Dead rows still step, but their writes go
        to the scratch page — their pages may belong to another row."""
        tok, gen_count, active = c["last_tok"], c["gen_count"], c["active"]
        real_len, budget = c["real_len"], c["budget"]
        toks, valids = [], []
        for _ in range(self.chunk_steps):
            live = active & (gen_count < budget)
            cur = real_len + gen_count - 1                    # token index
            lg, _ = self.model(
                tok[:, None], cache=self.cache, positions=cur[:, None],
                page_table=c["table"], page_size=self.page_size,
                page_write_ok=live[:, None],
                paged_attn_impl=self.paged_attn_impl, kv_quant=self.kv_quant,
            )
            nxt = sample_logits(lg[:, 0], c["temp"], self._gen)
            valid = live & (nxt != self.eos_id)
            out = torch.where(valid, nxt, self.pad_id)
            gen_count = torch.where(live, gen_count + 1, gen_count)
            tok = torch.where(valid, out, tok)
            active = valid
            toks.append(out)
            valids.append(valid)
        return tok, gen_count, active, torch.stack(toks, 1), torch.stack(valids, 1)

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "LMEngine":
        self._thread = threading.Thread(
            target=self._loop, name="lm-engine", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(30)
        # anything still queued or mid-generation must not hang its caller
        self._fail_all(RuntimeError("LM engine stopped"))

    def _fail_all(self, err: Exception) -> None:
        for row in range(self.max_batch):
            req = self._slots[row]
            if req is not None:
                self._slots[row] = None
                req.error = err
                req.finish()
        if self._held is not None:
            self._held.error = err
            self._held.finish()
            self._held = None
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            req.error = err
            req.finish()

    # -- admission ---------------------------------------------------------- #

    def _enqueue(self, ids, max_new_tokens, temperature, *, live: bool,
                 deadline: float) -> _Request:
        if not ids:
            raise ValueError("empty prompt")
        if self._fatal is not None:
            raise RuntimeError("LM engine is dead") from self._fatal
        if self._stop.is_set():
            raise RuntimeError("LM engine stopped")
        if deadline - time.monotonic() <= 0:
            raise DeadlineExceeded(
                "deadline already expired at admission", stage="admission"
            )
        # bounded admission: rows decoding + queue beyond max_batch +
        # max_queue is shed — an unbounded tail would outwait any client
        occupied = sum(s is not None for s in self._slots)
        held = 1 if self._held is not None else 0
        if self._pending.qsize() + occupied + held >= self.max_batch + self.max_queue:
            raise EngineOverloaded(
                f"engine at capacity ({occupied} decoding, "
                f"{self._pending.qsize() + held} queued, "
                f"max_queue={self.max_queue})"
            )
        # max_seq first: a request over the per-row bound must say so
        if len(ids) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt layout {len(ids)} + max_new_tokens {max_new_tokens} "
                f"exceeds engine max_seq {self.max_seq}"
            )
        need = self.pager.pages_for(len(ids) + max_new_tokens)
        if need > self.pager.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages; pool has "
                f"{self.pager.num_pages - 1} — raise kv_pool_tokens"
            )
        self._bucket(len(ids))  # reject over-bucket prompts now
        req = _Request(
            list(ids), max_new_tokens, temperature,
            live=queue.Queue() if live else None, deadline=deadline,
            t_enqueue=time.monotonic(),
        )
        self._pending.put(req)
        self._work.set()
        if (self._stop.is_set() or self._fatal is not None) and not req.done.is_set():
            # raced stop()'s or the crash handler's drain: fail it here
            req.error = RuntimeError("LM engine stopped")
            req.finish()
        return req

    def submit(
        self, ids: list[int], *, max_new_tokens: int = 32,
        temperature: float = 0.0, timeout_s: float = 300.0,
        deadline: float | None = None, seed: int | None = None,
        resume_tokens: list[int] | None = None,
    ) -> list[int]:
        """Generate up to ``max_new_tokens`` after ``ids``; blocks until
        done. ``deadline`` (absolute ``time.monotonic()``) bounds queue
        wait and decode; ``timeout_s`` becomes it when none is given."""
        _reject_per_request(seed, resume_tokens)
        if deadline is None:
            deadline = time.monotonic() + timeout_s
        req = self._enqueue(ids, max_new_tokens, temperature, live=False,
                            deadline=deadline)
        if not req.done.wait(max(0.0, deadline - time.monotonic())):
            # hand the row back: nobody will read its tokens
            req.cancelled.set()
            self._work.set()
            raise DeadlineExceeded("generation timed out", stage="wait")
        if req.error is not None:
            raise req.error
        return req.tokens

    def stream(
        self, ids: list[int], *, max_new_tokens: int = 32,
        temperature: float = 0.0, timeout_s: float = 300.0,
        deadline: float | None = None, seed: int | None = None,
        resume_tokens: list[int] | None = None,
    ):
        """Yields lists of new tokens as prefill and decode chunks
        complete; every wait is charged against one deadline."""
        _reject_per_request(seed, resume_tokens)
        if deadline is None:
            deadline = time.monotonic() + timeout_s
        req = self._enqueue(ids, max_new_tokens, temperature, live=True,
                            deadline=deadline)
        try:
            while True:
                remaining = deadline - time.monotonic()
                try:
                    if remaining <= 0:
                        raise queue.Empty
                    item = req.live.get(timeout=remaining)
                except queue.Empty:
                    raise DeadlineExceeded(
                        "generation timed out", stage="wait"
                    ) from None
                if item is None:
                    break
                yield item
            if req.error is not None:
                raise req.error
        finally:
            # generator closed early (client disconnect) → release the row
            if not req.done.is_set():
                req.cancelled.set()
                self._work.set()

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    def _admit_all(self) -> None:
        # cancelled and deadline-expired rows free up before admission
        # looks for space
        now = time.monotonic()
        for row in range(self.max_batch):
            req = self._slots[row]
            if req is None:
                continue
            if req.deadline is not None and now > req.deadline:
                self.stats["deadline_expired_decoding"] += 1
                req.error = DeadlineExceeded(
                    "deadline expired mid-decode", stage="decoding"
                )
                self._finish(row)
            elif req.cancelled.is_set():
                self._finish(row)
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            if self._held is not None:
                req, self._held = self._held, None
            else:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    return
            if req.done.is_set():
                continue
            if req.deadline is not None and time.monotonic() > req.deadline:
                self.stats["deadline_expired_queued"] += 1
                req.error = DeadlineExceeded(
                    "deadline expired while queued", stage="queued"
                )
                req.finish()
                continue
            if req.cancelled.is_set():
                req.finish()  # consumer already gone: never admit
                continue
            need = self.pager.pages_for(len(req.ids) + req.max_new_tokens)
            if not self.pager.can_alloc(need):
                # page backpressure: hold THIS request (FIFO — nothing
                # admits past it) until completions free pages
                self._held = req
                self.stats["page_holds"] += 1
                return
            try:
                self._admit(req, free[0])
            except ValueError as e:  # bad request: fail it, keep serving
                req.error = e
                req.finish()

    def _admit(self, req: _Request, row: int) -> None:
        """Claim a row and its pages and prefill the prompt."""
        self.pager.alloc(
            row, self.pager.pages_for(len(req.ids) + req.max_new_tokens)
        )
        C = self._bucket(len(req.ids))
        self._slots[row] = req
        self.real_len[row] = len(req.ids)
        self.gen_count[row] = 0
        self.budget[row] = req.max_new_tokens
        self.temp[row] = req.temperature
        self.stats["admitted"] += 1
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"], sum(s is not None for s in self._slots)
        )
        self.stats["kv_pages_used_peak"] = max(
            self.stats["kv_pages_used_peak"], self.pager.used_pages
        )
        self._prefill(req, row, C)

    def _prefill(self, req: _Request, row: int, C: int) -> None:
        """Prefill the prompt, padded to its bucket ``C``, in one piece and
        activate (or finish) the request with its first token. Without
        chunked prefill (ROADMAP queue 1 item 6f) a prompt is never longer
        than its bucket, so the JAX engine's piece loop runs once."""
        piece = np.full((1, C), self.pad_id, np.int64)
        piece[0, : len(req.ids)] = req.ids
        tok, valid = self._suffix_prefill(
            torch.tensor(piece, device=self.device),
            len(req.ids),
            torch.tensor(self.pager.table[row: row + 1, : self._pages_w(C)].copy(),
                         device=self.device),
            torch.tensor([req.temperature], device=self.device),
        )
        self.stats["prefill_pieces"] += 1
        tok, valid = int(tok), bool(valid)  # prefill is synchronous by design
        if valid:
            req.push([tok])
        self.last_tok[row] = tok
        if not valid or req.max_new_tokens <= 1:
            self._finish(row)
        else:
            self.active[row] = True
            self.gen_count[row] = 1

    def _finish(self, row: int) -> None:
        req = self._slots[row]
        self._slots[row] = None
        self.active[row] = False
        self.pager.free(row)
        if req is not None:
            if req.t_first:
                self.ttft_ms.append((req.t_first - req.t_enqueue) * 1e3)
            # count BEFORE done.set(): callers may read stats at once
            self.stats["completed"] += 1
            req.finish()

    # -- scheduler loop ----------------------------------------------------- #

    def _loop(self) -> None:
        try:
            # inference mode is thread-local: the loop thread enters it
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._loop_inner()
        except Exception as e:  # noqa: BLE001 — the loop must not die silently
            self._fatal = e
            self._fail_all(e)

    def _loop_inner(self) -> None:
        while not self._stop.is_set():
            self._admit_all()
            if not self.active.any():
                # idle: park until submit/cancel/stop sets _work
                self.stats["idle_wakes"] += 1
                self._work.wait(_IDLE_PARK_S)
                self._work.clear()
                continue
            self._drain_chunk(self._dispatch_chunk(self._upload_carry()))

    def _upload_carry(self) -> dict:
        """The per-row arrays for one chunk, uploaded from SNAPSHOTS of the
        host mirrors (``torch.tensor`` copies; ``from_numpy`` would alias
        mirrors the host edits while the chunk runs). The table is as wide
        as the furthest token any active row can reach in this chunk."""
        act = self.active
        h0 = int((self.real_len + self.gen_count)[act].max())
        hcap = int((self.real_len + self.budget)[act].max())
        w = self._pages_w(max(min(h0 + self.chunk_steps, hcap), 1))
        dev = self.device
        return {
            "last_tok": torch.tensor(self.last_tok, device=dev),
            "gen_count": torch.tensor(self.gen_count, device=dev),
            "active": torch.tensor(self.active, device=dev),
            "real_len": torch.tensor(self.real_len, device=dev),
            "budget": torch.tensor(self.budget, device=dev),
            "temp": torch.tensor(self.temp, device=dev),
            "table": self.pager.device_table(w),
        }

    def _dispatch_chunk(self, carry: dict) -> _Chunk:
        active_in = self.active.copy()
        tok, gen_count, active, toks, valid = self._chunk_paged(carry)
        self.stats["chunks"] += 1
        return _Chunk(
            toks=toks, valid=valid, last_tok=tok, gen_count=gen_count,
            active_out=active, active_in=active_in, slots=list(self._slots),
        )

    def _drain_chunk(self, p: _Chunk) -> None:
        """Bring one chunk's tokens to the host (the one D2H of a chunk),
        credit them to the requests resident at dispatch, refresh the host
        mirrors, and retire rows that hit EOS or their budget."""
        toks, valid, last, genc, act_out = (
            t.cpu().numpy()
            for t in (p.toks, p.valid, p.last_tok, p.gen_count, p.active_out)
        )
        for row in range(self.max_batch):
            req = p.slots[row]
            if req is None or not p.active_in[row] or self._slots[row] is not req:
                continue
            hit_eos = False
            fresh: list[int] = []
            for j in range(self.chunk_steps):
                if len(req.tokens) + len(fresh) >= req.max_new_tokens:
                    break
                if not valid[row, j]:
                    hit_eos = True
                    break
                fresh.append(int(toks[row, j]))
            req.push(fresh)
            self.last_tok[row] = last[row]
            self.gen_count[row] = genc[row]
            self.active[row] = bool(act_out[row])
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._finish(row)


class LMEngineModel(Model):
    """Engine-backed serving model: rows from concurrent requests share
    one decode batch. Request rows are ``{"input_ids": [...],
    "max_new_tokens": n, "temperature": t}`` (or a bare id list);
    responses are ``{"token_ids": [...]}``.

    ``load()`` builds the ``TransformerLM`` on ``device`` (``None`` = the
    CUDA card) with ``state_dict`` when given (e.g. bridged JAX params)
    or random weights from ``seed``, then starts the engine.
    """

    def __init__(
        self, name: str, *, config: TransformerConfig,
        state_dict: Mapping[str, torch.Tensor] | None = None, seed: int = 0,
        device=None, max_new_tokens: int = 32, eos_id: int = 1,
        prefill_buckets: tuple[int, ...] = (32, 128), max_batch: int = 8,
        max_seq: int | None = None, **engine_kwargs,
    ):
        super().__init__(name)
        if not config.causal:
            raise ValueError("LMEngineModel needs a causal TransformerConfig")
        self.config = config
        self.max_new_tokens = max_new_tokens
        self._state_dict = state_dict
        self._seed = seed
        self._device = device
        self._engine_config = LMEngineConfig(
            max_batch=max_batch,
            max_seq=max_seq or max(prefill_buckets) + max_new_tokens,
            prefill_buckets=tuple(prefill_buckets), eos_id=eos_id, seed=seed,
            **engine_kwargs,
        )
        _reject_unported(self._engine_config)
        self.engine: LMEngine | None = None
        self._executor: cf.ThreadPoolExecutor | None = None
        # admission control on the caller's thread: the private executor
        # is sized max_batch, so excess rows would otherwise queue unseen
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def load(self) -> bool:
        model = TransformerLM(self.config, device=self._device)
        if self._state_dict is not None:
            model.load_state_dict(self._state_dict)
        else:
            init_weights(model, self._seed)
        model.eval().requires_grad_(False)
        self._executor = cf.ThreadPoolExecutor(
            max_workers=self._engine_config.max_batch,
            thread_name_prefix=f"lm-engine-{self.name}",
        )
        self.engine = LMEngine(model, config=self._engine_config).start()
        self.ready = True
        return True

    def unload(self) -> None:
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
        super().unload()

    def preprocess(self, payload: Any, headers=None) -> list[dict]:
        if isinstance(payload, Mapping) and "instances" in payload:
            payload = payload["instances"]
        rows = []
        for inst in payload:
            temperature, budget = 0.0, None
            if isinstance(inst, str) or (
                isinstance(inst, Mapping) and "input_ids" not in inst
            ):
                raise NotImplementedError(
                    "text prompts need the tokenizer, which is not ported "
                    "yet; send input_ids"
                )
            if isinstance(inst, Mapping):
                temperature = float(inst.get("temperature", 0.0))
                if inst.get("max_new_tokens") is not None:
                    budget = int(inst["max_new_tokens"])
                    if budget < 1:
                        raise ValueError(
                            f"max_new_tokens must be >= 1, got {budget}"
                        )
                ids = list(inst["input_ids"])
            else:
                ids = list(inst)
            ids = [int(t) % self.config.vocab_size for t in ids]
            if not ids:
                raise ValueError("empty prompt")
            rows.append({
                "ids": ids, "temperature": temperature,
                "max_new_tokens": budget,
            })
        if not rows:
            raise ValueError("empty request")
        return rows

    def _row_budget(self, row) -> int:
        """The row's ``max_new_tokens`` clamped to the model cap."""
        req = row.get("max_new_tokens")
        if req is None:
            return self.max_new_tokens
        return max(1, min(int(req), self.max_new_tokens))

    def _submit_row(self, eng: LMEngine, row) -> dict:
        toks = eng.submit(
            row["ids"], max_new_tokens=self._row_budget(row),
            temperature=row["temperature"],
        )
        return {"token_ids": toks}

    def predict(self, rows, headers=None) -> list[dict]:
        eng = self.engine  # snapshot: unload() may clear it concurrently
        if eng is None:
            raise RuntimeError(f"model {self.name!r} is unloaded")
        cap = self._engine_config.max_batch + eng.max_queue
        with self._inflight_lock:
            if self._inflight + len(rows) > cap:
                raise EngineOverloaded(
                    f"{self._inflight} rows in flight (capacity {cap})"
                )
            self._inflight += len(rows)
        try:
            futs = [self._executor.submit(self._submit_row, eng, r) for r in rows]
            cf.wait(futs)
        finally:
            with self._inflight_lock:
                self._inflight -= len(rows)
        return [f.result() for f in futs]

    def postprocess(self, outputs, headers=None) -> Any:
        return {"predictions": outputs}
