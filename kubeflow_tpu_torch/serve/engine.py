"""Continuous-batching LM engine — the port of
``kubeflow_tpu/serve/engine.py:LMEngine``, in both of its KV layouts:

- **paged** (``kv_pool_tokens`` set): one pool of pages shared by every
  row through a block table; a row's token space is contiguous, so
  position == token index and the model's paged branch derives causal
  and window masks from positions;
- **dense** (``kv_pool_tokens=None``, the JAX default): a ``(max_batch,
  kv_heads, max_seq, head_dim)`` cache, one row a request. A row is laid
  out ``[prompt | gap | gen]``: the prompt's prefill pieces pad it to
  ``gen_start`` (its bucket, or a multiple of ``prefill_chunk``), and
  decode writes generated tokens from there; ``decode_kv_mask`` (and
  ``decode_span_kv_mask`` for a speculative span) keeps the gap out of
  every attention. It reads by torch ops, as the JAX branch reads by XLA
  einsums: no kernel, so ``paged_attn_impl="kernel"`` and
  ``kv_quant="int8"`` need a pool, as in JAX.

Requests join and leave a running decode batch of ``max_batch`` rows:

- **Admission** claims a free row (paged: and the request's whole page
  budget, prompt + max_new_tokens, from the pool; when the pool is short
  the request is HELD, FIFO: nothing admits past it, until completions
  free pages). A stored prompt prefix (the prefix cache) is copied into
  the row, and the rest of the prompt is prefilled — in one piece, or
  with ``prefill_chunk`` in pieces interleaved with decode chunks, one
  piece per loop iteration. The final piece samples the first token.
- **Decode runs in chunks** of ``chunk_steps`` steps for all rows (dead
  rows step too and write to the scratch page). With
  ``spec_draft_tokens=K`` each step drafts up to K tokens by prompt
  lookup and verifies them in one (K+1)-position forward
  (``serve/speculative.py``), emitting up to K+1 tokens a step.
- **Pipelined dispatch** (``pipeline_depth=1``, the default): the per-row
  arrays live on the card as a *carry* threaded from one chunk into the
  next, and chunk N+1 is queued before chunk N is drained, so the host's
  drain of N overlaps N+1 on the card. Host edits (admission, prefill
  activation, cancellation) are *epochs*: they dirty the carry, the
  in-flight chunk is drained first, and the carry is uploaded once.
  Each chunk's outputs are copied at dispatch into a pinned buffer of its
  own and the drain waits on that copy's event; every upload is staged
  through pinned memory (``serve/hostio.py``), so nothing the host does
  between chunks stalls the card's stream. ``pipeline_depth=0`` keeps the
  synchronous loop (upload, dispatch, drain) for parity and debugging.
- **Seeded requests** (``seed=``) draw the token at position p from
  ``fold_in(PRNGKey(seed), p)`` (``serve/threefry.py``), identically to
  the JAX engine, so a stream resumed with ``resume_tokens`` on any
  replica continues exactly; unseeded temperature draws come from the
  engine's ``torch.Generator``.
- **The request contract** (``serve/deadline.py``): one end-to-end
  deadline bounds queue wait and decode; admission sheds a request whose
  deadline the decode-gap EWMA proves unmeetable (``AdmissionShed``) and,
  at capacity, evicts the lowest-priority *queued* request for a
  higher-priority one. The loop stamps a heartbeat each iteration and
  ``poison`` fails all work without joining a wedged thread, for the
  watchdog (``serve/watchdog.py``).
- **KV movement between replicas** (disaggregated serving): a prefill
  replica runs only a request's prefill (:meth:`LMEngine.prefill_span`)
  and ships the finished KV span through the npz codec
  (``serve/kv_codec.py``); a decode replica implants it
  (:meth:`LMEngine.prepare_kv_span`, ``submit(kv_span=...)``) and never
  runs a prefill piece for the request. Any failed ship falls back to a
  local prefill (:func:`fetch_kv_span`). Prefix-cache entries move
  between replicas the same way (:meth:`LMEngine.export_prefix_entries`,
  :meth:`LMEngine.import_prefix_entries`). With ``host_kv_bytes`` the
  finished rows of a session (``session=``) swap their span out to the
  host tier (``serve/kv_tier.py``) on an offload thread, and the
  session's next turn swaps it back in place of the prefill.

- **Tensor-parallel serving** (``mesh``, a ``MeshSpec`` over the default
  process group, one rank a process; ``rules`` default
  ``transformer_rules(fsdp=False)``, the JAX default): every rank builds
  the same engine from the same arguments and keeps its shard of each
  weight and ``kv_heads / model`` heads of the cache (dense and paged,
  int8 scales too). Rank 0, the leader, owns the queue, the scheduler,
  the sampler's results and the HTTP side; before each device program
  (a prefill piece, a carry upload or table widening, a decode chunk, a
  prefix-cache store or implant) it broadcasts one small record of that
  program's host inputs (ids, positions, block tables, write masks, row
  flags) on a gloo group, and every follower (``start()`` runs the
  follower loop in the calling thread) runs the same program on its
  shards; the model's sums over ``model`` keep the ranks in step, and
  each rank samples the same whole logits. Replicas over ``data``
  compute the same step. Every rank's generator is seeded alike and
  every program draws from it unconditionally, so the ranks draw the
  same noise in the same order: the tokens a follower emits, and writes
  KV for, are the leader's. Speculative decoding runs its drafter and
  verify inside the chunk program on every rank, from the token history
  the carry holds; an MoE block routes each rank's whole batch as one
  token group (``parallel/expert.py``), its expert FFN split over
  ``model``. A follower that dies or wedges fails the leader's next
  collective within the group's timeout, through the fatal path.
  KV-span and prefix-entry movement, the host KV tier and the
  watchdog's rebuild raise ``NotImplementedError`` under a mesh
  (ROADMAP queue 1 item 14).

Greedy token streams, and seeded sampled ones, are identical to the JAX
engine's on the same weights (``tests/test_torch_engine*.py``,
``tests/test_torch_spec.py``). The settings of the JAX
``LMEngineConfig`` this port does not implement raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.core.mesh import Axis, mesh_context
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
    init_paged_kv_cache,
)
from kubeflow_tpu_torch.obs import names, prom
from kubeflow_tpu_torch.obs.trace import (  # noqa: F401 — TTFT/TPOT re-exported
    TPOT_MS,
    TRACER,
    TTFT_MS,
    ctx_from_headers,
    observe_request_latency,
)
from kubeflow_tpu_torch.serve.deadline import (
    ADMISSION_SHED,
    DEADLINE_EXPIRED,
    AdmissionShed,
    DeadlineExceeded,
    deadline_from_headers,
    priority_from_headers,
    resume_from_headers,
    seed_from_headers,
)
from kubeflow_tpu_torch.serve.generate import (
    LMRuntimeModel,
    decode_kv_mask,
    decode_span_kv_mask,
    sample_logits,
)
from kubeflow_tpu_torch.serve.headers import (
    PREFILL_PEER_HEADER,
    SESSION_HEADER,
    TRACE_HEADER,
    header_get,
)
from kubeflow_tpu_torch.serve.hostio import OutputRing, Uploader
from kubeflow_tpu_torch.serve.kv_codec import (
    decode_kv_entries,
    encode_kv_entries,
    numpy_to_pool,
    plane_dtype_reject,
    tree_to_numpy,
)
from kubeflow_tpu_torch.serve.kv_tier import HostKVTier
from kubeflow_tpu_torch.serve.model import BucketSpec
from kubeflow_tpu_torch.serve.paging import PageAllocator
from kubeflow_tpu_torch.serve.speculative import propose_draft, spec_accept
from kubeflow_tpu_torch.serve.threefry import seeded_sample

#: idle park bound — every waker (submit, cancel, stop) sets ``_work``, so
#: this timeout is only a belt-and-braces sweep, not a poll
_IDLE_PARK_S = 5.0
_INT32 = np.iinfo(np.int32)

#: disaggregated serving on the wire: span bytes by leg (``export`` on the
#: prefill replica, ``import`` on the decode replica) and one ship's time
KV_SHIP_BYTES = prom.REGISTRY.counter(
    names.ENGINE_KV_SHIP_BYTES_TOTAL,
    "bytes of per-request KV spans shipped between replicas",
    labels=("model", "direction"),
)
KV_SHIP_MS = prom.REGISTRY.histogram(
    names.ENGINE_KV_SHIP_MS,
    "one KV-span ship leg (fetch + decode + validate), milliseconds",
)


@dataclass
class LMEngineConfig:
    """Engine knobs, with the JAX ``LMEngineConfig``'s names and defaults.
    Every field can also be given to ``LMEngine(...)`` as a keyword.

    ``pipeline_depth``: 1 (default) the pipelined one-chunk-ahead loop, 0
    the synchronous one. ``spec_draft_tokens`` (K > 0): speculative
    decoding, matching on ``spec_ngram`` tokens. ``prefix_cache_entries``
    (> 0): completed prompt prefills donate their KV, keyed by the prompt
    rounded down to 16 tokens, LRU-bounded by entries and, when set,
    ``prefix_cache_tokens``. ``prefill_chunk`` (a multiple of 16):
    prompts prefill in pieces of that many tokens, interleaved with
    decode, and are no longer bound by the largest prefill bucket.
    ``host_kv_bytes`` (> 0): the byte budget of the host-RAM KV tier that
    sessioned rows swap out to when they finish. ``kv_pool_tokens``
    (None: the dense cache) sizes the paged pool, ``page_size`` its
    pages. ``mesh`` (a ``MeshSpec`` or a built ``core.mesh.Mesh``) and
    ``rules`` (``parallel/sharding.py`` rules) serve tensor-parallel."""

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
    pipeline_depth: int = 1
    spec_draft_tokens: int = 0
    spec_ngram: int = 3
    paged_attn_impl: str = "gather"
    kv_quant: str = "none"
    host_kv_bytes: int = 0


def _reject_unported(c: LMEngineConfig) -> None:
    """Settings of the JAX engine this port does not implement raise;
    the JAX constructor's own checks run after them."""
    unported = [
        (c.page_size is None,
         "the measured page-size table (page_size=None)", "queue 2 item 5"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})"
            )
    if c.pipeline_depth not in (0, 1):
        raise ValueError(
            "pipeline_depth must be 0 (inline) or 1 (one-chunk-ahead); "
            f"got {c.pipeline_depth}"
        )
    if c.spec_draft_tokens < 0:
        raise ValueError(
            f"spec_draft_tokens must be >= 0 (0 disables speculative "
            f"decoding); got {c.spec_draft_tokens}"
        )
    if c.spec_draft_tokens and c.spec_ngram < 1:
        raise ValueError(
            f"spec_ngram must be >= 1 when speculative decoding is on; "
            f"got {c.spec_ngram}"
        )
    if c.paged_attn_impl not in ("gather", "kernel"):
        raise ValueError(
            f"paged_attn_impl must be 'gather' or 'kernel'; "
            f"got {c.paged_attn_impl!r}"
        )
    if c.kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant must be 'none' or 'int8'; got {c.kv_quant!r}")
    if c.kv_pool_tokens is None and (
        c.paged_attn_impl != "gather" or c.kv_quant != "none"
    ):
        raise ValueError(
            "paged_attn_impl='kernel' / kv_quant='int8' require paged "
            "mode (set kv_pool_tokens)"
        )
    if c.prefill_chunk is not None and (
        c.prefill_chunk < 16 or c.prefill_chunk % 16
    ):
        raise ValueError("prefill_chunk must be a multiple of 16")
    if c.mesh is not None:
        if c.host_kv_bytes > 0:
            raise NotImplementedError(
                "the host KV tier (host_kv_bytes) under a tensor-parallel "
                f"mesh is not ported yet (ROADMAP {TP_UNPORTED})"
            )
    elif c.rules is not None:
        raise ValueError("rules lay the weights out over a mesh: pass mesh= too")


#: the ROADMAP item of the engine features a tensor-parallel mesh refuses
TP_UNPORTED = "queue 1 item 14"


def _tensor_parallel(model: TransformerLM, c: LMEngineConfig):
    """Lay ``model`` out for tensor-parallel serving over ``c.mesh`` (a
    ``MeshSpec``, built over the default process group, or a built
    ``Mesh``): the JAX engine's checks, then this rank keeps its shard of
    every weight by ``c.rules`` (``transformer_rules(fsdp=False)`` by
    default; an MoE block's expert FFN splits over ``model``, its expert
    dim over ``expert``). The cut is made in place: a copy would hold the
    full weights twice. A model cut before is served as it is when it was
    cut by these rules for this mesh and rank (an earlier engine's), and
    refused otherwise. Returns the rank's mesh; its groups exist on
    return."""
    from kubeflow_tpu_torch.core.mesh import Mesh, build_mesh
    from kubeflow_tpu_torch.parallel.sharding import (
        P, param_shapes, shard_module, split_parameters, transformer_rules)

    mesh = c.mesh if isinstance(c.mesh, Mesh) else build_mesh(
        c.mesh, device=model.device)
    cfg = model.cfg
    if mesh.size(Axis.SEQ) > 1 or mesh.size(Axis.PIPE) > 1:
        raise NotImplementedError(
            "tensor-parallel serving splits heads over 'model' and "
            "replicates over the other axes; 'seq' and 'pipe' must be 1")
    rules = c.rules or transformer_rules(fsdp=False)
    split = split_parameters(model)
    if not split:
        rules.validate_divisibility(param_shapes(model), mesh.shape)
    # the KV cache shards its head axis over 'model'; the rules see only
    # the weights, so a GQA config must be checked here
    model_size = mesh.shape.get("model", 1)
    if cfg.kv_heads % model_size:
        raise ValueError(
            f"TP serving shards the KV cache over kv_heads: "
            f"kv_heads {cfg.kv_heads} must be divisible by the "
            f"mesh 'model' axis size {model_size}"
        )
    specs = rules(model)
    if not split:
        shard_module(model, specs, mesh)
    else:
        for name, p in model.named_parameters():
            if (getattr(p, "kft_spec", None)
                    != P(*specs.get(name, P())).padded(p.dim())
                    or getattr(p, "kft_mesh", None) != (mesh.spec, mesh.rank)):
                raise ValueError(
                    f"the model's weights are cut for another layout "
                    f"({name}: {getattr(p, 'kft_spec', None)} over "
                    f"{getattr(p, 'kft_mesh', None)}): pass whole weights")
    # every group the forward uses, created now in the same order on
    # every rank (a group's creation is itself a collective)
    mesh.group(Axis.MODEL)
    return mesh


class EngineOverloaded(RuntimeError):
    """Admission queue full — callers should shed load (HTTP 429)."""


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
    # tenant priority (higher = shed last): at capacity the lowest-priority
    # queued request is evicted first
    priority: int = 0
    # per-request sampling seed (None: the engine generator's draws)
    seed: int | None = None
    # disaggregated prefill (prefill replica): run only the prefill, and
    # hand the finished span back in kv_span / kv_span_meta instead of
    # activating the row; the first token rides the meta, never pushed
    want_kv_span: bool = False
    kv_span: Any = None
    kv_span_meta: dict | None = None
    # disaggregated decode (decode replica): a peer-prefilled span, admitted
    # by implant; this engine runs no prefill piece for the request
    kv_inject: "PreparedKVSpan | None" = None
    # host KV tier: finished rows swap their span out under this key, and
    # the session's next turn swaps it back in
    session: str | None = None
    # request tracing (obs/trace.py): only a request whose submit carried
    # a trace context has spans; warmup and untraced callers pay nothing.
    # ``espan`` is the engine-stage span, qspan / pspan its queue.wait /
    # prefill children; finish() closes them all from whatever terminal
    # state the request reached, and records TTFT/TPOT under ``model``
    model: str = "engine"
    espan: Any = None
    qspan: Any = None
    pspan: Any = None
    t_enqueue: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0

    def push(self, toks: list[int]) -> None:
        if self.done.is_set():
            return  # failed already (a poisoned engine's late drain)
        if toks:
            # first / latest token on the host, when a client could see it
            self.t_last = time.monotonic()
            if not self.tokens:
                self.t_first = self.t_last
        self.tokens.extend(toks)
        if self.live is not None and toks:
            self.live.put(list(toks))

    def finish(self) -> None:
        self._end_trace()
        if self.live is not None:
            self.live.put(None)  # stream sentinel
        self.done.set()

    def _end_trace(self) -> None:
        """Close the engine-stage spans from the request's terminal state
        and record its TTFT/TPOT — only under a span, as the JAX engine
        does. Idempotent (finish can race between the enqueue path and
        the drain): the espan handle is taken once."""
        span, self.espan = self.espan, None
        if span is None:
            return
        err = self.error
        if err is None:
            status = "cancelled" if self.cancelled.is_set() else "ok"
        elif isinstance(err, DeadlineExceeded):
            status = "deadline"
            span.event("deadline_expired", stage=err.stage)
        elif isinstance(err, AdmissionShed):
            status = "shed"
            span.event("admission_shed", reason=err.reason)
        elif type(err).__name__ == "EngineRestarting":
            # the watchdog poisoned this engine mid-flight; the failure is
            # retryable on a fresh engine or a peer replica
            status = "poisoned"
            span.event("watchdog_poisoned", retryable=True)
        else:
            status = "error"
            span.set_attr("error", f"{type(err).__name__}: {err}")
        for sub in (self.qspan, self.pspan):
            if sub is not None:
                sub.end(status if status != "ok" else None)
        self.qspan = self.pspan = None
        n = len(self.tokens)
        span.set_attr("tokens_emitted", n)
        if self.t_first:
            ttft_ms = (self.t_first - self.t_enqueue) * 1e3
            tpot_ms = None
            if n >= 2 and self.t_last > self.t_first:
                tpot_ms = (self.t_last - self.t_first) / (n - 1) * 1e3
            span.set_attr("ttft_ms", round(ttft_ms, 3))
            if tpot_ms is not None:
                span.set_attr("tpot_ms", round(tpot_ms, 3))
            observe_request_latency(self.model, ttft_ms=ttft_ms, tpot_ms=tpot_ms)
        span.end(status)


class _TokenStream:
    """Iterator over one admitted request's token chunks (``stream``).
    Every wait is charged against the request's one deadline; ``close``
    (a consumer walking away) releases the row at the next chunk
    boundary, also when the stream is closed before its first chunk."""

    def __init__(self, engine: "LMEngine", req: _Request, deadline: float):
        self._engine, self._req, self._deadline = engine, req, deadline
        self._closed = False

    def __iter__(self) -> "_TokenStream":
        return self

    def __next__(self) -> list[int]:
        if self._closed:
            raise StopIteration
        req = self._req
        remaining = self._deadline - time.monotonic()
        try:
            if remaining <= 0:
                raise queue.Empty
            item = req.live.get(timeout=remaining)
        except queue.Empty:
            self.close()
            DEADLINE_EXPIRED.labels(stage="wait").inc()
            raise DeadlineExceeded("generation timed out", stage="wait") from None
        if item is None:
            self._closed = True
            if req.error is not None:
                raise req.error
            raise StopIteration
        return item

    def close(self) -> None:
        self._closed = True
        if not self._req.done.is_set():
            self._req.cancelled.set()
            self._engine._work.set()


@dataclass(frozen=True)
class PreparedKVSpan:
    """A shipped per-request KV span validated against one engine
    (:meth:`LMEngine.prepare_kv_span`) and on its device, ready for
    ``submit(kv_span=...)``: the per-layer tree, the ship meta
    (``real_len``, ``first_tok``, ``valid``) and the ceil-16 window
    width the tree covers."""

    tree: Any
    meta: dict
    n16: int


@dataclass
class _PendingChunk:
    """One dispatched, undrained decode chunk: its outputs staged for the
    host (``OutputRing.stage``: toks and valid ``(B, T)``, or ``(B, T,
    K+1)`` planes with eos/prop/acc ``(B, T)`` under speculation; the
    post-chunk carry; liveness at dispatch) plus the slot snapshot at
    dispatch, so the drain can mask rows retired while it was in flight."""

    staged: dict
    slots: list
    # dispatch stamp (time.monotonic): the drain records one
    # ``decode.chunk`` span per traced resident row from it
    t_dispatch: float = 0.0


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
        #: tensor-parallel serving (``config.mesh``): this rank's mesh; rank
        #: 0 leads (the queue, the scheduler, the sampler's results, the
        #: HTTP side) and every other rank follows its device programs
        if config.mesh is None:
            from kubeflow_tpu_torch.parallel.sharding import split_parameters

            split = split_parameters(model)
            if split:
                raise ValueError(
                    f"the model's weights are cut over a mesh ({split[0]}, "
                    f"...): serve it with mesh=, or pass whole weights")
        self.mesh = None if config.mesh is None else _tensor_parallel(
            model, config)
        self.is_leader = self.mesh is None or self.mesh.rank == 0
        kv_heads = cfg.kv_heads // (
            1 if self.mesh is None else self.mesh.size(Axis.MODEL))
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
        self.pipeline_depth = config.pipeline_depth
        #: speculative decode: K draft tokens verified per forward (0 = off)
        self.spec_k = config.spec_draft_tokens
        self.spec_ngram = config.spec_ngram
        self.prefill_chunk = config.prefill_chunk
        #: every host→device copy of the scheduler (pinned on the card)
        self.uploader = Uploader(self.device)
        #: one pinned output buffer per chunk in flight
        self._outputs = OutputRing(self.device, slots=self.pipeline_depth + 1)
        #: paged KV mode: a page pool shared through a block table; dense
        #: mode: one (max_seq)-slot cache row per batch row
        self.paged = config.kv_pool_tokens is not None
        if self.paged:
            self.pager: PageAllocator | None = PageAllocator(
                pool_tokens=config.kv_pool_tokens,
                page_size=config.page_size,
                max_batch=config.max_batch,
                max_pages_per_row=-(-config.max_seq // config.page_size),
            )
            self.cache = init_paged_kv_cache(
                cfg, config.kv_pool_tokens, kv_quant=self.kv_quant,
                device=self.device, kv_heads=kv_heads,
            )
        else:
            self.pager = None
            self.cache = init_kv_cache(cfg, config.max_batch, config.max_seq,
                                       device=self.device, kv_heads=kv_heads)
            #: cache slot indices, the key axis of the dense decode masks
            self._kpos = torch.arange(config.max_seq, device=self.device)
        #: noise for unseeded temperature > 0 rows (threefry's engine-key
        #: stream is not reproduced; greedy and seeded rows never read it)
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        #: the decode chunk program (tests may wrap it to inject faults)
        self._chunk = self._chunk_spec if self.spec_k else self._chunk_plain
        #: the followers' channel: the leader broadcasts one record a device
        #: program on a gloo group of every rank (``_program``)
        self._ctl = None
        if self.mesh is not None and self.mesh.spec.total_devices > 1:
            import torch.distributed as dist

            from kubeflow_tpu_torch.core.distributed import group_timeout

            self._ctl = dist.new_group(backend="gloo", timeout=group_timeout())
        #: programs that threads other than the loop queue for every rank
        #: (``_queue_program``)
        self._tp_outbox: deque = deque()
        #: records broadcast (leader) or followed (follower)
        self.tp_records = 0

        B = config.max_batch
        # per-row host mirrors; they ride to the device once per epoch
        self.real_len = np.zeros((B,), np.int64)   # prompt length
        # dense rows: the first generated token's slot (paged: real_len)
        self.gen_start = np.zeros((B,), np.int64)
        self.gen_count = np.zeros((B,), np.int64)  # tokens so far
        self.budget = np.zeros((B,), np.int64)     # max_new_tokens
        self.last_tok = np.zeros((B,), np.int64)
        self.active = np.zeros((B,), bool)
        self.temp = np.zeros((B,), np.float32)
        #: per-row sampling seed (-1 = unseeded)
        self.seeds = np.full((B,), -1, np.int32)
        #: host twin of the carry's seeds: picks the seeded chunk variant
        #: at dispatch without a device sync
        self._carry_seeded = False
        #: speculation: the host mirror of each row's token history
        #: (prompt + generated, by position); the device copy rides the
        #: carry and is rewritten in-graph each step. Width max_seq + K + 1
        #: leaves the (K+1)-wide span write at hist_len room to never clip.
        self.hist_host = (
            np.zeros((B, config.max_seq + self.spec_k + 1), np.int64)
            if self.spec_k else None
        )
        self._slots: list[_Request | None] = [None] * B
        #: rows mid-prefill: row → piece state (``_admit``)
        self._prefilling: dict[int, dict] = {}
        #: a request held back by page backpressure (FIFO preserved)
        self._held: _Request | None = None

        self._pending: queue.Queue[_Request] = queue.Queue()
        self._fatal: Exception | None = None
        #: set (with the retryable error) while the watchdog tears this
        #: instance down: submits racing the swap fail fast with it
        self._poisoned: Exception | None = None
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: scheduler-loop heartbeat (monotonic), stamped at the top of
        #: every iteration: stale while work exists means a wedged loop
        self._beat = time.monotonic()
        #: fault seam: a "pre_chunk" hook runs on the scheduler thread
        #: before each chunk dispatch (tests wedge or slow the loop here)
        self._fault_hooks: dict[str, Any] = {}
        #: the serving model's name, set by ``LMEngineModel``: engine
        #: spans and the TTFT/TPOT histograms label by it
        self.model_name = "engine"
        self.stats = {
            "admitted": 0, "completed": 0, "chunks": 0, "max_concurrent": 0,
            "prefix_hits": 0, "prefix_tokens_reused": 0,
            "prefill_pieces": 0, "idle_wakes": 0,
            "spec_proposed": 0, "spec_accepted": 0,
            "deadline_expired_queued": 0, "deadline_expired_decoding": 0,
            "shed_deadline": 0, "shed_priority": 0,
            "resume_admits": 0,
            # cross-replica prefix-KV transfer
            "prefix_imported": 0, "prefix_exported": 0,
            # disaggregated serving: spans exported (prefill replica),
            # spans injected without a local prefill (decode replica), ship
            # bytes pulled, and failed ships turned into a local prefill
            "kv_spans_exported": 0, "kv_injected": 0,
            "kv_ship_bytes": 0, "kv_ship_fallbacks": 0,
            # host KV tier: sessions swapped out on finish / back in
            "kv_offload_out": 0, "kv_offload_in": 0,
        }
        if self.paged:
            # pre-initialized: /metrics iterates this dict from another
            # thread, so a first-admission key insert would race it
            self.stats.update(page_holds=0, kv_pages_used_peak=0)
        #: guards the counters that HTTP threads bump (ship and transfer)
        self._stats_lock = threading.Lock()
        #: time to first token of recent completions, milliseconds
        #: (enqueue → first token on the host)
        self.ttft_ms: deque[float] = deque(maxlen=1024)

        # the pipelined loop's device-resident carry, its dirtiness (host
        # edits pending an epoch) and the page-horizon bookkeeping that
        # widens the table across chunks within an epoch
        self._carry: dict[str, Any] | None = None
        self._carry_dirty = True
        self._carry_chunks = 0   # chunks dispatched since the last upload
        self._carry_h0 = 0       # paged: max(real_len + gen_count) at upload
        self._carry_hcap = 0     # paged: max(real_len + budget) at upload
        self._carry_pages_w = 0  # paged: uploaded table width (pages)
        self._last_dispatch: float | None = None
        self.overlap = {
            "decode_gap_ms": 0.0,    # EWMA host time between dispatches
            "d2h_drain_ms": 0.0,     # EWMA wait + unpack of a chunk's outputs
            "carry_uploads": 0,      # epoch uploads and table widenings
            "slot_occupancy": 0.0,   # EWMA occupied-row share at dispatch
            "spec_acceptance": 0.0,  # EWMA accepted / proposed drafts
        }
        if self.kv_quant == "int8":
            # EWMA of the mean-abs relative KV quantization error, measured
            # by the prefill pieces (pre-initialized: /metrics reads this
            # dict from another thread)
            self.overlap["kv_quant_error"] = 0.0

        #: host-RAM KV tier: finished sessioned rows swap their span out
        #: here; the D2H and the encode run on the ``kv-offload`` thread,
        #: never the scheduler's
        self.host_kv_tier = (
            HostKVTier(config.host_kv_bytes) if config.host_kv_bytes > 0
            else None
        )
        self._offload_q: "queue.Queue | None" = (
            queue.Queue() if self.host_kv_tier is not None else None
        )
        self._offload_thread: threading.Thread | None = None

        # prefix cache: completed prompt prefills donate their KV, keyed by
        # the prompt ids rounded DOWN to a 16-token multiple
        self._prefix_cache: "OrderedDict[tuple, dict] | None" = (
            OrderedDict() if config.prefix_cache_entries > 0 else None
        )
        #: guards the prefix maps: the scheduler stores and looks up, other
        #: threads index and drop
        self._prefix_lock = threading.Lock()
        self._prefix_cache_entries = config.prefix_cache_entries
        self._prefix_cache_tokens = config.prefix_cache_tokens
        self._prefix_lens: dict[int, int] = {}  # stored length → count
        #: descending stored lengths, memoized (store/evict invalidate)
        self._prefix_lens_sorted: list[int] | None = None
        self._prefix_tokens_stored = 0

    # -- device programs ---------------------------------------------------- #

    def _pages_w(self, tokens: int) -> int:
        """Read-window width in pages: pow2-rounded (as the JAX engine, so
        both read the same windows), capped at the per-row maximum."""
        need = -(-tokens // self.page_size)
        w = 1
        while w < need:
            w *= 2
        return min(w, self.pager.max_pages_per_row)

    def _forward(self, x, positions, table, write_ok, quant_stats=None):
        logits, _ = self.model(
            x, cache=self.cache, positions=positions, page_table=table,
            page_size=self.page_size, page_write_ok=write_ok,
            paged_attn_impl=self.paged_attn_impl, kv_quant=self.kv_quant,
            quant_stats=quant_stats,
        )
        return logits

    # -- the followers' channel -------------------------------------------- #

    def _program(self, op: str, local: dict | None = None, **kw):
        """Run device program ``op`` (``_run_<op>``) on host inputs ``kw``.
        Under a mesh the leader first broadcasts ``(op, kw)`` to every
        follower, which runs the same program on its shards (``local``:
        leader-only arguments that never travel)."""
        if self._ctl is not None:
            self._broadcast(op, kw)
        return getattr(self, f"_run_{op}")(**kw, **(local or {}))

    def _broadcast(self, op: str, kw: dict) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([(op, kw)], src=0, group=self._ctl)
        self.tp_records += 1

    def _run_queued(self) -> None:
        """Run the programs that other threads queued (``_queue_program``),
        in order, on every rank. The loop calls this at the top of an
        iteration, where no prefix lookup waits for its implant: a drop
        never lands between a hit and the implant that reads it."""
        while self._tp_outbox:
            op, kw = self._tp_outbox.popleft()
            self._program(op, **kw)

    def _follow(self) -> None:
        """A follower's loop: receive each record of the leader and run its
        program, until the leader's ``stop`` record. A ``follower_op``
        fault hook runs before each program (tests kill a follower
        there)."""
        import torch.distributed as dist

        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._ctl)
            op, kw = box[0]
            self.tp_records += 1
            self._beat = time.monotonic()
            if op == "stop":
                return
            hook = self._fault_hooks.get("follower_op")
            if hook is not None:
                hook(self, op)
            getattr(self, f"_run_{op}")(**kw)

    def _run_noop(self) -> None:
        """The idle leader's keep-alive: a follower's receive must not
        outwait the group's timeout."""

    def _run_prefix_drop(self, keys) -> None:
        """Drop stored prefix entries, on every rank at the same point of
        the program stream: ``keys``, the leader's LRU evictions (already
        gone from its own cache); ``None``, all of them
        (``drop_prefix_cache``)."""
        with self._prefix_lock:
            if keys is None:
                self._clear_prefix_locked()
            for key in keys or ():
                self._prefix_cache.pop(key, None)

    def _run_prefix_store(self, key: tuple, row: int, n16: int, idx):
        """Copy row ``row``'s first n16 KV tokens out as prefix ``key``: the
        leader's entry is returned for its LRU, a follower keeps its shard
        under the same key."""
        entry = self._extract_prefix(row, n16, idx)
        if not self.is_leader:
            self._prefix_cache[key] = entry
        return entry

    def _run_implant(self, key: tuple, row: int, n16: int, idx,
                     stored: dict | None = None) -> None:
        """Implant prefix ``key`` (the leader passes its entry) into row
        ``row``."""
        self._implant(self._prefix_cache[key] if stored is None else stored,
                      row, n16, idx)

    def _run_prefill(self, piece, slen: int, offset: int, row: int,
                     temperature: float, seed: int, pos: int, *,
                     seeded: bool, table):
        """One prefill piece of row ``row`` writes tokens [offset, offset
        + S) and samples the token after the last real one — by the
        seeded draw at absolute position ``pos`` when ``seeded``. Paged,
        the piece goes through the row's block table (pad positions >=
        slen to the scratch page); dense, through the row's slice of the
        cache at ``cache_index=offset`` (the default causal mask over
        absolute slots: bit for bit the tail of a full prefill). Returns
        ``(token, qerr)``: under ``kv_quant="int8"`` qerr is the layers'
        summed ``[quantization error, magnitude]`` of the piece's K and V
        (the only program that measures it: decode chunks stay free of
        telemetry; under a mesh summed over the ranks' heads), else None.
        ``piece`` and ``table`` (the row's block table, paged) are host
        arrays."""
        S = piece.shape[1]
        dev = self.device
        piece = self.uploader.upload(piece)
        qs: list | None = [] if self.kv_quant == "int8" else None
        if self.paged:
            ar = torch.arange(S, device=dev)
            logits = self._forward(piece, (offset + ar)[None, :],
                                   self.uploader.upload(table),
                                   (ar < slen)[None, :], quant_stats=qs)
        else:
            row_cache = {name: {which: arr[row:row + 1]
                                for which, arr in lc.items()}
                         for name, lc in self.cache.items()}
            logits, _ = self.model(piece, cache=row_cache, cache_index=offset)
        last = logits[:, slen - 1]
        temp = torch.full((1,), temperature, dtype=torch.float32, device=dev)
        tok = sample_logits(last, temp, self._gen)
        if seeded:
            tok = seeded_sample(
                last, torch.full((1,), seed, dtype=torch.int64, device=dev),
                torch.full((1,), pos, dtype=torch.int64, device=dev), temp, tok,
            )
        qerr = torch.stack(qs).sum(0) if qs else None
        if qerr is not None and self.mesh is not None:
            from kubeflow_tpu_torch.core import collectives as coll

            qerr = coll.psum(qerr, Axis.MODEL, mesh=self.mesh)
        return tok[0], qerr

    def _step_logits(self, c: dict, x, positions, gen_count, write_ok):
        """One decode step's forward of ``x (B, S)`` at ``positions``:
        S=1 the carry token, S=K+1 a speculative span. Paged, through the
        block table (positions where ``write_ok`` is False write to the
        scratch page). Dense, at each row's slot ``gen_start + gen_count
        - 1`` under ``decode_kv_mask`` (``decode_span_kv_mask`` for a
        span); a dead row writes at its frozen slot, which the row's next
        owner overwrites before reading, and a speculative span's
        rejected drafts land past the accepted slot, overwritten before
        they are attended."""
        if self.paged:
            return self._forward(x, positions, c["table"], write_ok)
        S = x.shape[1]
        real_len, gen_start = c["real_len"], c["gen_start"]
        slot0 = gen_start + gen_count - 1
        window = self.model.cfg.attn_window
        if S == 1:
            kv_mask = decode_kv_mask(self._kpos, real_len, gen_start, slot0,
                                     window)
        else:
            kv_mask = decode_span_kv_mask(self._kpos, real_len, gen_start,
                                          slot0, S, window)
        logits, _ = self.model(x, cache=self.cache, cache_index=slot0,
                               positions=positions, kv_mask=kv_mask)
        return logits

    def _chunk_plain(self, c: dict, *, seeded: bool):
        """``chunk_steps`` decode steps for all rows (a Python loop where
        the JAX engine scans; nothing in it waits for the card). Dead
        rows still step, but never advance: paged, their writes go to the
        scratch page (their pages may belong to another row)."""
        tok, gen_count, active = c["last_tok"], c["gen_count"], c["active"]
        real_len, budget, temp = c["real_len"], c["budget"], c["temp"]
        toks, valids = [], []
        for _ in range(self.chunk_steps):
            live = active & (gen_count < budget)
            cur = real_len + gen_count - 1                    # token index
            lg = self._step_logits(c, tok[:, None], cur[:, None], gen_count,
                                   live[:, None])
            nxt = sample_logits(lg[:, 0], temp, self._gen)
            if seeded:
                # the new token's absolute position is real_len + gen_count
                nxt = seeded_sample(lg[:, 0], c["seed"], real_len + gen_count,
                                    temp, nxt)
            valid = live & (nxt != self.eos_id)
            out = torch.where(valid, nxt, self.pad_id)
            gen_count = torch.where(live, gen_count + 1, gen_count)
            tok = torch.where(valid, out, tok)
            active = valid
            toks.append(out)
            valids.append(valid)
        return {"last_tok": tok, "gen_count": gen_count, "active": active,
                "toks": torch.stack(toks, 1), "valid": torch.stack(valids, 1)}

    def _spec_emit(self, emitted, n_emit, draft_len, n_acc, tok, gen_count,
                   active, budget):
        """Post-verify gating of one speculative step: the one-token
        step's liveness, budget and EOS rules applied to the span. Span
        position i is live iff the row was live, i was emitted, the
        budget admits it and no live EOS came earlier; an EOS position is
        live but not valid (budget charged, token not emitted)."""
        K1 = self.spec_k + 1
        i = torch.arange(K1, device=emitted.device)[None, :]
        live0 = active & (gen_count < budget)
        cand = (live0[:, None] & (i < n_emit[:, None])
                & (gen_count[:, None] + i < budget[:, None]))
        is_eos = emitted == self.eos_id
        eos_here = (cand & is_eos).long()
        no_eos_before = torch.cat(
            [torch.ones_like(eos_here[:, :1]),
             torch.cumprod(1 - eos_here, dim=1)[:, :-1]], dim=1,
        ).bool()
        live_i = cand & no_eos_before
        valid_i = live_i & ~is_eos
        out = torch.where(valid_i, emitted, self.pad_id)
        adv = live_i.sum(dim=1)
        eos_step = (live_i & is_eos).any(dim=1)
        # carry token: the last VALID emitted token (frozen through EOS)
        last_idx = (adv - 1).clamp(0, K1 - 1)[:, None]
        last_out = torch.gather(out, 1, last_idx)[:, 0]
        last_ok = torch.gather(valid_i, 1, last_idx)[:, 0]
        new_tok = torch.where((adv > 0) & last_ok, last_out, tok)
        # telemetry, gated to live rows
        prop = torch.where(live0, draft_len, 0)
        acc = torch.where(live0, torch.minimum(n_acc, adv), 0)
        return (out, valid_i, live_i, eos_step, new_tok, gen_count + adv,
                active & ~eos_step, prop, acc)

    def _spec_hist_update(self, hist, hist_len, emitted, live_i):
        """Write the span's live tokens into each row's history at
        positions [hist_len, hist_len + K] (the buffer is wide enough that
        the window never clips)."""
        K1 = self.spec_k + 1
        idx = hist_len[:, None] + torch.arange(K1, device=hist.device)[None, :]
        win = torch.gather(hist, 1, idx)
        return hist.scatter(1, idx, torch.where(live_i, emitted, win))

    def _chunk_spec(self, c: dict, *, seeded: bool):
        """Speculative twin of :meth:`_chunk_plain`: each step drafts up
        to K tokens from the row's device history and verifies them in ONE
        (K+1)-position forward at positions ``L-1 .. L-1+K`` (through the
        paged kernel under ``paged_attn_impl="kernel"``, ``S = K+1`` with
        each row's own ``pos0``). Paged, span positions past the row's
        budgeted region write to the scratch page; dense rows hold K slots
        of headroom for them (``_enqueue``). Rows with no match draft 0
        tokens and take the one-token step."""
        K = self.spec_k
        tok, gen_count, active = c["last_tok"], c["gen_count"], c["active"]
        real_len, budget, temp, hist = (
            c["real_len"], c["budget"], c["temp"], c["hist"])
        span = torch.arange(K + 1, device=tok.device)[None, :]
        outs: dict[str, list] = {k: [] for k in ("toks", "valid", "eos",
                                                  "prop", "acc")}
        for _ in range(self.chunk_steps):
            live0 = active & (gen_count < budget)
            L = real_len + gen_count                      # history length
            draft, draft_len = propose_draft(hist, L, ngram=self.spec_ngram,
                                             k=K)
            if seeded:
                # seeded temperature rows do not speculate: the accept and
                # resample draws would tie their stream to the batch's
                # generator state; they take the one-token seeded draw
                draft_len = torch.where((c["seed"] >= 0) & (temp > 0.0), 0,
                                        draft_len)
            x = torch.cat([tok[:, None], draft], dim=1)
            positions = (L - 1)[:, None] + span
            write_ok = live0[:, None] & (positions < (real_len + budget)[:, None])
            lg = self._step_logits(c, x, positions, gen_count, write_ok)
            emitted, n_emit, n_acc = spec_accept(lg, draft, draft_len,
                                                 self._gen, temp)
            if seeded:
                # span position 0's absolute position is L
                emitted = torch.cat([
                    seeded_sample(lg[:, 0], c["seed"], L, temp,
                                  emitted[:, 0])[:, None],
                    emitted[:, 1:]], dim=1)
            (out, valid_i, live_i, eos_step, tok, gen_count, active, prop,
             acc) = self._spec_emit(emitted, n_emit, draft_len, n_acc, tok,
                                    gen_count, active, budget)
            hist = self._spec_hist_update(hist, L, emitted, live_i)
            for k, v in zip(outs, (out, valid_i, eos_step, prop, acc)):
                outs[k].append(v)
        res = {k: torch.stack(v, 1) for k, v in outs.items()}
        res.update(last_tok=tok, gen_count=gen_count, active=active, hist=hist)
        return res

    def _extract_prefix(self, row: int, n16: int, idx=None) -> dict:
        """Copy row ``row``'s first n16 KV tokens out (paged: through its
        block table, or the pool tokens ``idx`` when given; dense: a slice
        of its cache row) as new tensors: ``(1, kv_heads, n16, D)`` per
        layer, plus ``(1, kv_heads, n16)`` scales for an int8 pool (the
        JAX entry format, the same in both layouts)."""
        if not self.paged:
            return {name: {which: arr[row:row + 1, :, :n16].clone()
                           for which, arr in lc.items()}
                    for name, lc in self.cache.items()}
        idx = self.uploader.upload(
            self._token_index(row, n16) if idx is None else idx)
        out = {}
        for name, lc in self.cache.items():
            out[name] = {which: arr[:, idx][None] for which, arr in lc.items()}
        return out

    def _implant(self, stored: dict, row: int, n16: int, idx=None) -> None:
        """Copy a stored prefix into row ``row`` at token indices [0,
        n16): paged, scattered into its pages (or the pool tokens
        ``idx``); dense, into the front of its cache row."""
        if not self.paged:
            for name, lc in self.cache.items():
                for which, arr in lc.items():
                    arr[row:row + 1, :, :n16] = stored[name][which].to(arr.dtype)
            return
        idx = self.uploader.upload(
            self._token_index(row, n16) if idx is None else idx)
        for name, lc in self.cache.items():
            for which, arr in lc.items():
                arr[:, idx] = stored[name][which][0].to(arr.dtype)

    def _token_index(self, row: int, n: int) -> np.ndarray | None:
        """Pool token of each of row ``row``'s first n tokens (host; None
        for the dense cache)."""
        if not self.paged:
            return None
        j = np.arange(n)
        P = self.page_size
        return self.pager.table[row, j // P].astype(np.int64) * P + j % P

    def _queue_program(self, op: str, **kw) -> None:
        """Queue program ``op`` from any thread; the loop runs it on every
        rank at the top of its next iteration (``_run_queued``)."""
        self._tp_outbox.append((op, kw))
        self._work.set()

    def _refuse_under_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} under a tensor-parallel mesh is not ported yet "
                f"(ROADMAP {TP_UNPORTED})")

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "LMEngine":
        """Start the scheduler thread. On a follower rank, run the leader's
        device programs in the calling thread until the leader stops (or
        the group fails, which raises here)."""
        if not self.is_leader:
            try:
                with torch.inference_mode(), mesh_context(self.mesh):
                    if self.device.type == "cuda":
                        torch.cuda.set_device(self.device)
                    self._follow()
            except Exception as e:  # noqa: BLE001 — recorded, then raised
                self._fatal = e
                raise
            return self
        if self.host_kv_tier is not None and self._offload_thread is None:
            self._offload_thread = threading.Thread(
                target=self._offload_loop, name="kv-offload", daemon=True
            )
            self._offload_thread.start()
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
        self._stop_offload()
        # anything still queued or mid-generation must not hang its caller
        self._fail_all(RuntimeError("LM engine stopped"))

    def _stop_offload(self) -> None:
        """Drain the offload queue, then end its thread."""
        if self._offload_thread is not None:
            self._offload_q.put(None)  # drain-then-exit sentinel
            self._offload_thread.join(10)
            self._offload_thread = None

    def _count(self, key: str, n: int = 1) -> None:
        """Bump a counter that threads other than the scheduler write."""
        with self._stats_lock:
            self.stats[key] += n

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

    # -- the request contract: liveness, poisoning, admission estimate ----- #

    def heartbeat(self) -> float:
        """Monotonic stamp of the scheduler loop's last iteration start."""
        return self._beat

    def busy(self) -> bool:
        """True when the engine has work a wedged loop would be stalling:
        active decode rows, queued admissions, prefills in flight, or a
        page-held request."""
        return bool(
            self.active.any() or self._pending.qsize() or self._prefilling
            or self._held is not None
        )

    def poison(self, err: Exception) -> None:
        """Fail every in-flight and queued request with ``err`` now and
        stop accepting work, WITHOUT joining the scheduler thread: it may
        be wedged, and exits on its own at ``_stop`` once it returns. The
        emptied slots mask every row out of a chunk it still drains."""
        self._poisoned = err
        self._stop.set()
        self._work.set()
        self._fail_all(err)
        if self._offload_q is not None:
            # the offload thread is never wedged: it drains and exits
            self._offload_q.put(None)

    def estimate_admission(
        self, max_new_tokens: int
    ) -> tuple[float, float] | None:
        """``(queue_wait_s, decode_s)`` for a request admitted now, from
        the decode-gap EWMA; None while it is cold (no evidence, so never
        shed on a guess). ``decode_s`` counts chunks of the chunk *span*
        (an upper bound on a row's tokens a chunk, so the estimate errs
        toward admitting). ``queue_wait_s`` drains the requests queued
        ahead ``max_batch`` at a time, each wave lasting the active rows'
        mean remaining decode."""
        gap_s = self.overlap["decode_gap_ms"] / 1e3
        if gap_s <= 0.0:
            return None
        span = self._chunk_span
        decode_s = -(-max_new_tokens // span) * gap_s
        queued = self._pending.qsize() + (1 if self._held is not None else 0)
        free = sum(s is None for s in self._slots)
        if queued < free:
            return 0.0, decode_s
        act = self.active
        if act.any():
            mean_remaining = float((self.budget - self.gen_count)[act].mean())
        else:
            mean_remaining = float(max_new_tokens)
        wave_s = max(1.0, mean_remaining / span) * gap_s
        waves = -(-(queued + 1 - free) // self.max_batch)
        return waves * wave_s, decode_s

    # -- admission ---------------------------------------------------------- #

    def _enqueue(self, ids, max_new_tokens, temperature, *, live: bool,
                 deadline: float, priority: int = 0, resume: int = 0,
                 seed: int | None = None, trace: Any = None,
                 want_kv_span: bool = False,
                 kv_inject: PreparedKVSpan | None = None,
                 session: str | None = None) -> _Request:
        if not ids:
            raise ValueError("empty prompt")
        if not self.is_leader:
            raise RuntimeError(
                f"rank {self.mesh.rank} follows the leader's engine: submit "
                "on rank 0")
        if self._poisoned is not None:
            raise self._poisoned
        if self._fatal is not None:
            raise RuntimeError("LM engine is dead") from self._fatal
        if self._stop.is_set():
            raise RuntimeError("LM engine stopped")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            DEADLINE_EXPIRED.labels(stage="admission").inc()
            raise DeadlineExceeded(
                "deadline already expired at admission", stage="admission"
            )
        est = self.estimate_admission(max_new_tokens)
        if est is not None and est[0] + est[1] > remaining:
            # shed BEFORE the request costs a decode slot: by the evidence
            # in hand it cannot finish inside its budget
            queue_wait_s, decode_s = est
            self.stats["shed_deadline"] += 1
            ADMISSION_SHED.labels(reason="deadline_unmeetable").inc()
            raise AdmissionShed(
                f"deadline unmeetable: ~{queue_wait_s:.1f}s queue + "
                f"~{decode_s:.1f}s decode > {remaining:.1f}s remaining",
                reason="deadline_unmeetable", retry_after_s=queue_wait_s,
            )
        if seed is not None and not _INT32.min <= seed <= _INT32.max:
            raise ValueError(f"seed must be a 32-bit integer; got {seed}")
        # bounded admission: rows decoding + queue beyond max_batch +
        # max_queue is shed — an unbounded tail would outwait any client
        occupied = sum(s is not None for s in self._slots)
        held = 1 if self._held is not None else 0
        if (self._pending.qsize() + occupied + held
                >= self.max_batch + self.max_queue
                and not self._evict_lower_priority(priority)):
            raise EngineOverloaded(
                f"engine at capacity ({occupied} decoding, "
                f"{self._pending.qsize() + held} queued, "
                f"max_queue={self.max_queue})"
            )
        if self.paged:
            # the token space is contiguous: the layout is the prompt itself
            layout = len(ids)
        elif kv_inject is not None:
            # an injected span occupies its ceil-16 window; no prefill runs
            layout = kv_inject.n16
        elif self.prefill_chunk is not None:
            # chunked prefill frees prompts from the bucket bound: the only
            # limit is the piece layout fitting max_seq
            C = self.prefill_chunk
            layout = -(-len(ids) // C) * C
        else:
            layout = self._bucket(len(ids))
        # max_seq first: a request over the per-row bound must say so
        if layout + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt layout {layout} + max_new_tokens {max_new_tokens} "
                f"exceeds engine max_seq {self.max_seq}"
            )
        if self.spec_k and not self.paged and (
            layout + max_new_tokens + self.spec_k > self.max_seq
        ):
            # dense speculative decode writes rejected-draft KV up to K
            # slots past the row's budgeted region (overwritten, never
            # attended): the row must hold that headroom
            raise ValueError(
                f"prompt layout {layout} + max_new_tokens {max_new_tokens} "
                f"+ spec_draft_tokens {self.spec_k} exceeds engine "
                f"max_seq {self.max_seq} (speculative decode reserves K "
                f"scratch slots per row)"
            )
        if self.paged:
            need = self.pager.pages_for(len(ids) + max_new_tokens)
            if need > self.pager.num_pages - 1:
                raise ValueError(
                    f"request needs {need} pages; pool has "
                    f"{self.pager.num_pages - 1} — raise kv_pool_tokens"
                )
            if self.prefill_chunk is None and kv_inject is None:
                self._bucket(len(ids))  # reject over-bucket prompts now
        req = _Request(
            list(ids), max_new_tokens, temperature,
            live=queue.Queue() if live else None, deadline=deadline,
            priority=priority, seed=seed, t_enqueue=time.monotonic(),
            want_kv_span=want_kv_span, kv_inject=kv_inject, session=session,
        )
        if resume:  # committed tokens of a mid-stream failover joined ids
            self.stats["resume_admits"] += 1
        if trace is not None:
            # engine-stage span under the caller's wire context (a Span or
            # a parsed TraceContext — both carry trace_id/span_id); its
            # queue.wait child covers admission-queue time, closed at admit
            espan = TRACER.span("engine", parent=trace)
            if espan:
                espan.set_attr("model", self.model_name)
                espan.set_attr("prompt_tokens", len(req.ids))
                espan.set_attr("max_new_tokens", max_new_tokens)
                if priority:
                    espan.set_attr("priority", priority)
                if resume:
                    espan.set_attr("resume_tokens", resume)
                req.model = self.model_name
                req.espan = espan
                req.qspan = TRACER.span("queue.wait", parent=espan)
        self._pending.put(req)
        self._work.set()
        if (self._stop.is_set() or self._fatal is not None) and not req.done.is_set():
            # raced stop()'s, poison()'s or the crash handler's drain
            req.error = self._poisoned or RuntimeError("LM engine stopped")
            if self._fatal is not None:
                req.error = RuntimeError("LM engine is dead")
                req.error.__cause__ = self._fatal
            req.finish()
        return req

    def _evict_lower_priority(self, priority: int) -> bool:
        """At capacity, shed the lowest-priority QUEUED request whose
        priority is strictly below the newcomer's; True when a slot was
        freed. Active rows, prefilling rows and the page-held request are
        never victims: evicting them would waste work already done."""
        with self._pending.mutex:  # the scheduler's get_nowait holds it too
            victim = None
            for cand in self._pending.queue:
                if cand.done.is_set() or cand.cancelled.is_set():
                    continue
                if cand.priority < priority and (
                    victim is None or cand.priority < victim.priority
                ):
                    victim = cand
            if victim is None:
                return False
            self._pending.queue.remove(victim)
        self.stats["shed_priority"] += 1
        ADMISSION_SHED.labels(reason="priority_evict").inc()
        victim.error = AdmissionShed(
            f"shed by a priority-{priority} request under overload "
            f"(this request: priority {victim.priority})",
            reason="priority_evict",
        )
        victim.finish()
        return True

    def _resume_args(self, ids, max_new_tokens: int, resume_tokens):
        """Fold a mid-stream-failover resume prefix into the admission
        arguments: the committed tokens join the prompt and the budget
        shrinks by them, so the stream's total length is what the original
        request asked for. Returns ``(ids, max_new_tokens, resume)``."""
        if not resume_tokens:
            return list(ids), max_new_tokens, 0
        resume = len(resume_tokens)
        if max_new_tokens - resume < 1:
            raise ValueError(
                f"resume prefix ({resume} tokens) leaves no generation "
                f"budget (max_new_tokens={max_new_tokens})"
            )
        if self.eos_id in resume_tokens:
            raise ValueError(
                "resume prefix contains EOS — the stream already finished"
            )
        return (list(ids) + [int(t) for t in resume_tokens],
                max_new_tokens - resume, resume)

    def submit(
        self, ids: list[int], *, max_new_tokens: int = 32,
        temperature: float = 0.0, timeout_s: float = 300.0,
        deadline: float | None = None, priority: int = 0,
        seed: int | None = None, resume_tokens: list[int] | None = None,
        trace: Any = None, kv_span: PreparedKVSpan | None = None,
        session: str | None = None,
    ) -> list[int]:
        """Generate up to ``max_new_tokens`` after ``ids``; blocks until
        done. ``deadline`` (absolute ``time.monotonic()``) bounds queue
        wait and decode; ``timeout_s`` becomes it when none is given.
        ``priority``: higher is shed last at capacity. ``seed`` pins
        position-folded sampling (``serve/threefry.py``);
        ``resume_tokens`` (already-committed generated tokens) extend the
        prompt and shrink the budget — only the tokens past them return.
        ``trace`` (a ``Span`` or a parsed ``TraceContext``) parents the
        engine-stage spans, and only a traced request records its TTFT
        and TPOT; None (warmup, direct callers) records nothing.
        ``kv_span`` (a :meth:`prepare_kv_span` result for these exact
        ids, resume tokens included) admits by implanting the
        peer-prefilled span: no prefill piece runs here. ``session`` keys
        the host KV tier when it is on."""
        if deadline is None:
            deadline = time.monotonic() + timeout_s
        ids, max_new_tokens, resume = self._resume_args(
            ids, max_new_tokens, resume_tokens)
        req = self._enqueue(ids, max_new_tokens, temperature, live=False,
                            deadline=deadline, priority=priority,
                            resume=resume, seed=seed, trace=trace,
                            kv_inject=kv_span, session=session)
        if not req.done.wait(max(0.0, deadline - time.monotonic())):
            # hand the row back: nobody will read its tokens
            req.cancelled.set()
            self._work.set()
            DEADLINE_EXPIRED.labels(stage="wait").inc()
            raise DeadlineExceeded("generation timed out", stage="wait")
        if req.error is not None:
            raise req.error
        return req.tokens

    def stream(
        self, ids: list[int], *, max_new_tokens: int = 32,
        temperature: float = 0.0, timeout_s: float = 300.0,
        deadline: float | None = None, priority: int = 0,
        seed: int | None = None, resume_tokens: list[int] | None = None,
        trace: Any = None, kv_span: PreparedKVSpan | None = None,
        session: str | None = None,
    ) -> _TokenStream:
        """Admit now (so a shed or overload raises here, before a caller
        commits to a response) and return an iterator of the new tokens
        as prefill and decode chunks complete; every wait is charged
        against one deadline, and closing it releases the row. Arguments
        as in :meth:`submit`."""
        if deadline is None:
            deadline = time.monotonic() + timeout_s
        ids, max_new_tokens, resume = self._resume_args(
            ids, max_new_tokens, resume_tokens)
        req = self._enqueue(ids, max_new_tokens, temperature, live=True,
                            deadline=deadline, priority=priority,
                            resume=resume, seed=seed, trace=trace,
                            kv_inject=kv_span, session=session)
        return _TokenStream(self, req, deadline)

    def prefill_span(
        self, ids: list[int], *, temperature: float = 0.0,
        timeout_s: float = 120.0, deadline: float | None = None,
        seed: int | None = None, trace: Any = None,
    ) -> tuple[dict, dict]:
        """The prefill replica's half of disaggregated serving: run ONLY
        the (chunked) prefill of ``ids`` and return ``(tree, meta)``: the
        finished KV span as host arrays in the prefix-entry format
        (ceil-16 window; positions past the prompt hold junk the decode
        side overwrites before any query reaches them) and the meta the
        decode replica needs (``real_len``, ``first_tok``, ``valid``).
        The row retires when the span is extracted; no decode chunk runs
        for it. The device-to-host copy runs here, on the caller's
        thread. ``trace`` (the decode replica's ``kv.ship`` context off the
        wire) parents this engine's spans under the same trace id."""
        self._refuse_under_mesh("KV-span export (prefill_span)")
        n16 = -(-len(ids) // 16) * 16
        # the budget only reserves pages: the whole ceil-16 extract window
        # must be backed by the row's own pages. A dense row is max_seq
        # wide whatever its bucket, so 1 keeps small bucket + max_seq
        # configurations admissible
        budget = max(1, n16 - len(ids) + 1) if self.paged else 1
        if deadline is None:
            deadline = time.monotonic() + timeout_s
        req = self._enqueue(list(ids), budget, temperature, live=False,
                            deadline=deadline, seed=seed, trace=trace,
                            want_kv_span=True)
        if not req.done.wait(max(0.0, deadline - time.monotonic())):
            req.cancelled.set()
            self._work.set()
            DEADLINE_EXPIRED.labels(stage="wait").inc()
            raise DeadlineExceeded("prefill-span timed out", stage="wait")
        if req.error is not None:
            raise req.error
        if req.kv_span is None:
            raise RuntimeError("prefill-span request retired before extract")
        return tree_to_numpy(req.kv_span), dict(req.kv_span_meta)

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
        # looks for space: _finish dirties the carry, so the in-flight
        # chunk drains with the row masked out before one re-upload
        now = time.monotonic()
        for row in range(self.max_batch):
            req = self._slots[row]
            if req is None:
                continue
            # deadline before cancellation: a timed-out caller sets both,
            # and the retirement is the deadline's
            if req.deadline is not None and now > req.deadline:
                self.stats["deadline_expired_decoding"] += 1
                DEADLINE_EXPIRED.labels(stage="decoding").inc()
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
                continue  # priority-evicted while queued: already failed
            if req.deadline is not None and time.monotonic() > req.deadline:
                # retired from the queue before costing a decode slot
                self.stats["deadline_expired_queued"] += 1
                DEADLINE_EXPIRED.labels(stage="queued").inc()
                req.error = DeadlineExceeded(
                    "deadline expired while queued", stage="queued"
                )
                req.finish()
                continue
            if req.cancelled.is_set():
                req.finish()  # consumer already gone: never admit
                continue
            if self.paged and not self.pager.can_alloc(
                self.pager.pages_for(len(req.ids) + req.max_new_tokens)
            ):
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

    # -- prefix cache ------------------------------------------------------- #

    def _lookup_prefix(self, ids: list[int]):
        """Longest stored prefix strictly shorter than the prompt (one
        token must remain to prefill for the first-token logits). Keys are
        exact 16-multiples: only stored lengths are probed, longest first."""
        if self._prefix_cache is None:
            return None
        top = (len(ids) - 1) // 16 * 16
        with self._prefix_lock:
            if self._prefix_lens_sorted is None:
                self._prefix_lens_sorted = sorted(self._prefix_lens, reverse=True)
            for n16 in self._prefix_lens_sorted:
                if n16 > top:
                    continue
                key = tuple(ids[:n16])
                entry = self._prefix_cache.get(key)
                if entry is not None:
                    self._prefix_cache.move_to_end(key)
                    return key, entry
        return None

    def _store_prefix(self, ids: list[int], row: int) -> None:
        """Donate row ``row``'s KV for ids[:n16] (its first n16 tokens are
        real prompt tokens once its prefill completed)."""
        n16 = (len(ids) // 16) * 16
        if n16 < 16 or (
            self._prefix_cache_tokens is not None
            and n16 > self._prefix_cache_tokens
        ):
            return
        key = tuple(ids[:n16])
        with self._prefix_lock:
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                return
            entry = self._program("prefix_store", key=key, row=row, n16=n16,
                                  idx=self._token_index(row, n16))
            evicted = self._insert_prefix_locked(key, entry)
        if evicted and self._ctl is not None:
            self._program("prefix_drop", keys=evicted)

    def _insert_prefix_locked(self, key: tuple, entry: dict) -> list[tuple]:
        """Insert one entry and LRU-evict to both bounds (entries, and
        stored tokens when set); returns the evicted keys. Caller holds
        ``_prefix_lock``."""
        evicted = []
        n16 = len(key)
        self._prefix_cache[key] = entry
        if n16 not in self._prefix_lens:
            self._prefix_lens_sorted = None
        self._prefix_lens[n16] = self._prefix_lens.get(n16, 0) + 1
        self._prefix_tokens_stored += n16
        while len(self._prefix_cache) > self._prefix_cache_entries or (
            self._prefix_cache_tokens is not None
            and self._prefix_tokens_stored > self._prefix_cache_tokens
            and len(self._prefix_cache) > 1
        ):
            old_key, _ = self._prefix_cache.popitem(last=False)
            evicted.append(old_key)
            n = len(old_key)
            self._prefix_tokens_stored -= n
            self._prefix_lens[n] -= 1
            if not self._prefix_lens[n]:
                del self._prefix_lens[n]
                self._prefix_lens_sorted = None
        return evicted

    @property
    def prefix_cache_enabled(self) -> bool:
        return self._prefix_cache is not None

    def prefix_cache_stats(self) -> dict:
        """Prefix-cache counters: cumulative hits and tokens reused, live
        entries and stored tokens, and the entries imported from and
        exported to peer replicas."""
        return {
            "hits": self.stats["prefix_hits"],
            "tokens_reused": self.stats["prefix_tokens_reused"],
            "entries": len(self._prefix_cache or ()),
            "tokens_stored": self._prefix_tokens_stored,
            "imported": self.stats["prefix_imported"],
            "exported": self.stats["prefix_exported"],
        }

    def prefix_index(self) -> list[tuple[int, ...]]:
        """The stored prefix keys, LRU → MRU: what a peer needs to decide
        which entries the hash ring now assigns to it."""
        with self._prefix_lock:
            return list(self._prefix_cache or ())

    # -- KV movement between replicas --------------------------------------- #

    def export_prefix_entries(self, keys=None, *, limit: int | None = None):
        """Host copies of stored entries for the wire: ``[(key, {layer:
        {plane: np}}), ...]``. ``keys=None`` exports all (MRU last);
        ``limit`` keeps the most recently used. The device-to-host copy
        runs outside the lock: an export must not stall admissions."""
        self._refuse_under_mesh("prefix-entry export")
        with self._prefix_lock:
            if self._prefix_cache is None:
                return []
            if keys is None:
                sel = list(self._prefix_cache.items())
            else:
                sel = []
                for k in keys:
                    k = tuple(int(t) for t in k)
                    entry = self._prefix_cache.get(k)
                    if entry is not None:
                        sel.append((k, entry))
            if limit is not None and len(sel) > limit:
                sel = sel[-limit:]  # the OrderedDict's tail is the MRU
        out = [(key, tree_to_numpy(stored)) for key, stored in sel]
        self._count("prefix_exported", len(out))
        return out

    def import_prefix_entries(self, entries) -> int:
        """Insert peer-exported entries into this engine's prefix cache.
        Each entry is checked against this engine's layout (layers, kv
        heads, head dim, plane dtypes, the 16-token quantum, the max_seq
        fit); an incompatible one is skipped, never trusted. Returns the
        entries inserted; one already present is left alone (local
        recency wins) and does not count."""
        self._refuse_under_mesh("prefix-entry import")
        if self._prefix_cache is None:
            return 0
        prepared = []
        for key, tree in entries:
            key = tuple(int(t) for t in key)
            n16 = len(key)
            if n16 < 16 or n16 % 16 or n16 + 1 > self.max_seq:
                continue
            if (self._prefix_cache_tokens is not None
                    and n16 > self._prefix_cache_tokens):
                continue
            if self._span_reject(tree, n16) is not None:
                continue
            prepared.append((key, self._to_pool(tree)))
        imported = 0
        with self._prefix_lock:
            for key, tree in prepared:
                if key in self._prefix_cache:
                    continue
                self._insert_prefix_locked(key, tree)
                imported += 1
        self._count("prefix_imported", imported)
        return imported

    def _span_reject(self, tree, n16: int) -> str | None:
        """Why a wire KV tree (a prefix entry, a shipped span or a host-tier
        blob: one check guards every plane of the codec) cannot implant
        into this engine; None when it can. The plane-name set tells the
        quantizations apart: int8 trees carry ``k_scale``/``v_scale``
        beside the codes, float trees must not."""
        cfg = self.model.cfg
        H, D = cfg.kv_heads, cfg.head_dim
        if set(tree) != set(self.cache):
            return "layer names differ from this engine's model"
        quant = self.kv_quant == "int8"
        want_keys = {"k", "v", "k_scale", "v_scale"} if quant else {"k", "v"}
        want, want_scale = (1, H, n16, D), (1, H, n16)
        for name, lc in tree.items():
            if set(lc) != want_keys:
                return (f"quantization mismatch: layer {name!r} carries "
                        f"{sorted(lc)} but this engine's kv_quant is "
                        f"{self.kv_quant!r}")
            if np.shape(lc["k"]) != want or np.shape(lc["v"]) != want:
                return (f"KV shape {np.shape(lc['k'])} != {want} "
                        "(kv_heads / head_dim / window mismatch)")
            if quant and (np.shape(lc["k_scale"]) != want_scale
                          or np.shape(lc["v_scale"]) != want_scale):
                return f"scale plane shape != {want_scale}"
            for which, arr in lc.items():
                reason = plane_dtype_reject(arr, self.cache[name][which])
                if reason is not None:
                    return f"layer {name!r} {which}: {reason}"
        return None

    def _to_pool(self, tree) -> dict:
        """A checked wire tree as tensors of the pool's dtypes on its
        device (a bf16 plane's ``V2`` bits read as bf16)."""
        return {name: {which: numpy_to_pool(arr, self.cache[name][which])
                       for which, arr in lc.items()}
                for name, lc in tree.items()}

    def prepare_kv_span(self, ids, tree, meta) -> PreparedKVSpan:
        """Check a shipped per-request span against this engine and put it
        on the device for ``submit(kv_span=...)``. Raises ValueError on any
        meta, layout, quantization or dtype mismatch; callers
        (:func:`fetch_kv_span`) then prefill locally. The upload runs on
        the caller's thread, on the stream the scheduler's implant uses,
        so it is ordered before the implant."""
        self._refuse_under_mesh("KV-span import (prepare_kv_span)")
        try:
            real_len = int(meta["real_len"])
            first_tok = int(meta["first_tok"])
            valid = bool(meta["valid"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"kv span meta malformed: {e}") from None
        if real_len != len(ids):
            raise ValueError(
                f"kv span covers a {real_len}-token prompt; this request "
                f"has {len(ids)} tokens"
            )
        n16 = -(-real_len // 16) * 16
        if n16 + 1 > self.max_seq:
            raise ValueError(
                f"kv span window {n16} + 1 exceeds engine max_seq "
                f"{self.max_seq}"
            )
        reason = self._span_reject(tree, n16)
        if reason is not None:
            raise ValueError(f"kv span rejected: {reason}")
        return PreparedKVSpan(
            self._to_pool(tree),
            {"real_len": real_len, "first_tok": first_tok, "valid": valid},
            n16,
        )

    def drop_prefix_cache(self) -> int:
        """Wipe every stored prefix entry; returns the entries dropped.
        Under a mesh the loop thread drops them, on every rank, at the top
        of its next iteration: a lookup that already hit implants its
        entry first."""
        with self._prefix_lock:
            if self._prefix_cache is None:
                return 0
            n = len(self._prefix_cache)
            if self._ctl is None:
                self._clear_prefix_locked()
        if self._ctl is not None:
            self._queue_program("prefix_drop", keys=None)
        return n

    def _clear_prefix_locked(self) -> None:
        self._prefix_cache.clear()
        self._prefix_lens.clear()
        self._prefix_lens_sorted = None
        self._prefix_tokens_stored = 0

    # -- prefill ------------------------------------------------------------ #

    def _occupy(self, req: _Request, row: int, gen_start: int) -> None:
        """Seat ``req`` in row ``row``: the host mirrors (the drafter's
        history gets the prompt), the seat counters."""
        self._slots[row] = req
        self.real_len[row] = len(req.ids)
        if self.spec_k:
            self.hist_host[row, :] = self.pad_id
            self.hist_host[row, : len(req.ids)] = req.ids
        self.gen_start[row] = gen_start
        self.gen_count[row] = 0
        self.budget[row] = req.max_new_tokens
        self.temp[row] = req.temperature
        self.seeds[row] = -1 if req.seed is None else req.seed
        self.stats["admitted"] += 1
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"], sum(s is not None for s in self._slots)
        )
        if self.paged:
            self.stats["kv_pages_used_peak"] = max(
                self.stats["kv_pages_used_peak"], self.pager.used_pages
            )

    def _admit(self, req: _Request, row: int) -> None:
        """Claim a row (paged: and its pages), implant any cached prefix,
        lay out the prefill pieces and run the FIRST one when it is the
        only one. Multi-piece rows stay in ``_prefilling`` and take one
        piece per loop iteration, between decode chunks. A sessioned
        prompt with no cached prefix takes its span from the host tier
        when it is there. A dense row generates from ``gen_start``, past
        its padded pieces; a prefix whose padded layout would not fit
        ``max_seq`` is not implanted (the prompt prefills whole)."""
        if req.kv_inject is not None:
            self._admit_injected(req, row)
            return
        base, rest = 0, req.ids
        hit = self._lookup_prefix(req.ids)
        if hit is None and req.session and self.host_kv_tier is not None:
            hit = self._take_swapped(req)
        implanted = None
        if hit is not None:
            key, stored = hit
            n16 = len(key)
            suffix = req.ids[n16:]
            # suffixes pad to the 16-token quantum, not a prefill bucket
            C = self.prefill_chunk or -(-len(suffix) // 16) * 16
            n_pieces = -(-len(suffix) // C)
            if self.paged or (n16 + n_pieces * C + req.max_new_tokens
                              + self.spec_k <= self.max_seq):
                implanted = (n16, stored, suffix, C, n_pieces)
        if self.paged:
            self.pager.alloc(
                row, self.pager.pages_for(len(req.ids) + req.max_new_tokens)
            )
        if implanted is not None:
            base, stored, rest, C, n_pieces = implanted
            self._program("implant", local={"stored": stored}, key=key,
                          row=row, n16=base, idx=self._token_index(row, base))
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += base
        else:
            # the layout was checked against max_seq at enqueue
            C = self.prefill_chunk or self._bucket(len(rest))
            n_pieces = -(-len(rest) // C)
        self._occupy(req, row, len(req.ids) if self.paged
                     else base + n_pieces * C)
        self._prefilling[row] = {
            "req": req, "rest": rest, "base": base, "C": C,
            "n_pieces": n_pieces, "piece": 0,
        }
        if req.qspan is not None:
            req.qspan.end()
            req.qspan = None
        if req.espan is not None:
            req.pspan = (
                TRACER.span("prefill", parent=req.espan)
                .set_attr("row", row)
                .set_attr("prefix_hit", base > 0)
                .set_attr("prefix_tokens_reused", base)
                .set_attr("pieces", n_pieces)
            )
        # admission epoch: mirrors and the table changed
        self._carry_dirty = True
        if n_pieces == 1:
            self._advance_prefill(row)

    def _admit_injected(self, req: _Request, row: int) -> None:
        """Admit a peer-prefilled request: implant its span and activate
        the row directly, without a prefill piece. The first token rides
        the meta, so the request starts where the prefill replica left
        it. Positions [real_len, n16) hold junk: a paged row overwrites
        them before any query reaches them, a dense row generates from
        slot n16 and ``decode_kv_mask`` keeps the gap out."""
        span = req.kv_inject
        if self.paged:
            self.pager.alloc(
                row, self.pager.pages_for(len(req.ids) + req.max_new_tokens)
            )
        self._implant(span.tree, row, span.n16)
        self._occupy(req, row, len(req.ids) if self.paged else span.n16)
        self.stats["kv_injected"] += 1
        if req.qspan is not None:
            req.qspan.end()
            req.qspan = None
        if req.espan is not None:
            req.espan.set_attr("kv_injected", True)
        tok, valid = int(span.meta["first_tok"]), bool(span.meta["valid"])
        if valid:
            req.push([tok])
            if self.spec_k:
                self.hist_host[row, len(req.ids)] = tok
        self.last_tok[row] = tok
        if not valid or req.max_new_tokens <= 1:
            self._finish(row)
        else:
            self.active[row] = True
            self.gen_count[row] = 1
            self._carry_dirty = True  # activation epoch, as a prefill's

    def _take_swapped(self, req: _Request):
        """Consume the host tier's span for the request's session when its
        tokens prefix the prompt, as ``(key, tree)`` in
        :meth:`_lookup_prefix`'s format; None on a miss, a diverged
        prompt, or a corrupt or incompatible blob (each a full prefill)."""
        blob = self.host_kv_tier.take(req.session, req.ids)
        if blob is None:
            return None
        try:
            entries, _ = decode_kv_entries(blob)
            key, tree = entries[0]
        except Exception:  # noqa: BLE001 — a corrupt blob is a miss
            return None
        n16 = len(key)
        if n16 < 16 or n16 % 16 or self._span_reject(tree, n16) is not None:
            return None
        self.stats["kv_offload_in"] += 1
        return tuple(key), self._to_pool(tree)

    def _advance_prefill(self, row: int) -> None:
        """Run ONE prefill piece of a prefilling row; the final piece
        yields the first token and activates (or finishes) the request."""
        st = self._prefilling[row]
        req, rest, base, C = st["req"], st["rest"], st["base"], st["C"]
        i = st["piece"]
        final = i == st["n_pieces"] - 1
        piece_ids = rest[i * C: (i + 1) * C]
        piece = np.full((1, C), self.pad_id, np.int64)
        piece[0, : len(piece_ids)] = piece_ids
        offset = base + i * C
        tok, qerr = self._program(
            "prefill", piece=piece, slen=len(piece_ids), offset=offset,
            row=row, temperature=req.temperature,
            seed=-1 if req.seed is None else req.seed,
            # the sampled token's absolute position (kept only from the
            # final piece, where it is len(req.ids))
            pos=offset + len(piece_ids), seeded=req.seed is not None,
            table=(self.pager.table[row:row + 1, :self._pages_w(offset + C)]
                   if self.paged else None),
        )
        if qerr is not None:
            # one sync a piece, as the final piece's int(tok) below:
            # prefill is synchronous by design
            e, d = qerr.tolist()
            if d > 0:
                self._ewma("kv_quant_error", e / d)
        self.stats["prefill_pieces"] += 1
        st["piece"] = i + 1
        if not final:
            return  # a throwaway sample from a non-final position
        del self._prefilling[row]
        if req.pspan is not None:
            req.pspan.end()
            req.pspan = None
        if self._prefix_cache is not None:
            self._store_prefix(req.ids, row)
        tok = int(tok)  # prefill is synchronous by design
        valid = tok != self.eos_id
        if req.want_kv_span:
            # disaggregated prefill: extract the span (a new tensor, queued
            # before any later write to the pages freed below) and retire
            # the row without activating it; the first token travels in the
            # meta, so TTFT is observed once, on the decode side
            n16 = -(-len(req.ids) // 16) * 16
            req.kv_span = self._extract_prefix(row, n16)
            req.kv_span_meta = {"real_len": len(req.ids), "first_tok": tok,
                                "valid": valid}
            self.stats["kv_spans_exported"] += 1
            self._finish(row)
            return
        if valid:
            req.push([tok])
            if self.spec_k:
                self.hist_host[row, len(req.ids)] = tok
        self.last_tok[row] = tok
        if not valid or req.max_new_tokens <= 1:
            self._finish(row)
        else:
            self.active[row] = True
            self.gen_count[row] = 1
            self._carry_dirty = True  # activation epoch

    def _advance_prefills(self) -> None:
        for row in list(self._prefilling):
            if self._prefilling[row]["req"].cancelled.is_set():
                self._finish(row)
                continue
            self._advance_prefill(row)

    def _finish(self, row: int, *, carry_stale: bool = True) -> None:
        req = self._slots[row]
        self._slots[row] = None
        self.active[row] = False
        self.seeds[row] = -1  # a freed row no longer forces the seeded variant
        was_prefilling = self._prefilling.pop(row, None) is not None
        if (req is not None and self.host_kv_tier is not None and req.session
                and req.error is None and not req.want_kv_span
                and not was_prefilling):  # mid-prefill KV is incomplete
            # extract BEFORE the pages are freed: the table row is still
            # this request's
            self._swap_out(req, row)
        if self.paged:
            self.pager.free(row)
        # ``carry_stale=False`` is the drain's EOS/budget retirement: the
        # carry already gates the row on the card, so no epoch is needed.
        # Host-only retirements (cancel, deadline) dirty the carry.
        if carry_stale:
            self._carry_dirty = True
        if req is not None:
            if req.t_first:
                self.ttft_ms.append((req.t_first - req.t_enqueue) * 1e3)
            # count BEFORE done.set(): callers may read stats at once
            self.stats["completed"] += 1
            req.finish()

    # -- host KV tier ------------------------------------------------------- #

    def _swap_out(self, req: _Request, row: int) -> None:
        """Queue a finished sessioned row's span for the host tier. A paged
        row's first ``real_len + emitted - 1`` positions hold written KV
        (the last token is never fed back); a dense row's are contiguous
        over the prompt only (its generated KV sits past the gap), so it
        stores the prompt's window. The extract is queued here; its copy
        to the host and the encode run on the offload thread."""
        if self.paged:
            written = len(req.ids) + max(0, len(req.tokens) - 1)
        else:
            written = len(req.ids)
        n16 = (min(written, self.max_seq) // 16) * 16
        if n16 < 16:
            return
        ctx = (list(req.ids) + list(req.tokens))[:n16]
        self._offload_q.put(
            (req.session, tuple(ctx), self._extract_prefix(row, n16)))

    def _offload_loop(self) -> None:
        """Offload worker: each item is ``(session, key, device tree)``;
        a ``threading.Event`` is a flush barrier, None exits."""
        while True:
            item = self._offload_q.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                item.set()
                continue
            session, key, tree = item
            try:
                blob = encode_kv_entries([(key, tree_to_numpy(tree))])
            except Exception:  # noqa: BLE001 — swap-out is best-effort:
                continue       # the session re-prefills on its next turn
            if self.host_kv_tier.put(session, key, blob):
                self._count("kv_offload_out")

    def flush_offload(self, timeout_s: float = 10.0) -> bool:
        """Block until every swap-out queued so far has landed in the
        host tier (tests and drains; serving never waits)."""
        if self._offload_q is None or self._offload_thread is None:
            return True
        done = threading.Event()
        self._offload_q.put(done)
        return done.wait(timeout_s)

    # -- scheduler loop ----------------------------------------------------- #

    def _loop(self) -> None:
        try:
            # inference mode and the mesh are thread-local: the loop
            # thread enters them
            with torch.inference_mode(), mesh_context(self.mesh):
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._loop_inner()
        except Exception as e:  # noqa: BLE001 — the loop must not die silently
            self._fatal = e
            self._fail_all(e)
        finally:
            if self._ctl is not None:
                try:
                    self._broadcast("stop", {})
                except Exception:  # noqa: BLE001 — a dead follower's group
                    pass

    def _loop_inner(self) -> None:
        pending: _PendingChunk | None = None
        while not self._stop.is_set():
            # watchdog heartbeat: stale while work exists means the loop
            # is wedged (inside a device call or a fault hook)
            self._beat = time.monotonic()
            self._run_queued()
            self._admit_all()
            self._advance_prefills()  # one piece per prefilling row
            if not self.active.any():
                if pending is not None:
                    # burst tail: the chunk in flight outlived its rows —
                    # drain it, then re-evaluate
                    self._drain_chunk(pending)
                    pending = None
                    continue
                if self._prefilling:
                    continue  # keep advancing pieces, don't park
                # idle: park until submit/cancel/stop sets _work
                self._last_dispatch = None
                self.stats["idle_wakes"] += 1
                self._work.wait(_IDLE_PARK_S)
                self._work.clear()
                if self._ctl is not None and not self._stop.is_set():
                    self._program("noop")  # followers outwait no timeout
                continue
            if self.pipeline_depth == 0:
                # synchronous loop: upload, dispatch, drain each chunk
                self._upload_carry()
                self._drain_chunk(self._dispatch_chunk())
                continue
            if self._carry_dirty:
                if pending is not None:
                    # merge point: drain the chunk in flight so the mirrors
                    # are current (retired rows masked), then loop — the
                    # drain may free rows and pages admission wants
                    self._drain_chunk(pending)
                    pending = None
                    continue
                self._upload_carry()
            if pending is not None and self._all_may_retire():
                # end of burst: every active row may finish inside the
                # chunk in flight, so a further chunk would likely decode
                # dead rows — drain first
                self._drain_chunk(pending)
                pending = None
                continue
            # one chunk ahead: queue N+1 on the carry BEFORE draining N
            nxt = self._dispatch_chunk()
            if pending is not None:
                self._drain_chunk(pending)
            pending = nxt

    @property
    def _chunk_span(self) -> int:
        """Most tokens one chunk can advance a row: chunk_steps steps of
        up to K+1 tokens each under speculation."""
        return self.chunk_steps * (self.spec_k + 1)

    def _all_may_retire(self) -> bool:
        """Every host-visible active row could exhaust its budget within
        ONE more chunk (the mirrors lag the chunk in flight by one)."""
        act = self.active
        if not act.any():
            return True
        return bool(((self.budget - self.gen_count)[act] <= self._chunk_span).all())

    def _ewma(self, key: str, value: float, alpha: float = 0.2) -> None:
        cur = self.overlap[key]
        self.overlap[key] = value if cur == 0.0 else (
            (1.0 - alpha) * cur + alpha * value
        )

    def _upload_carry(self) -> None:
        """Upload the per-row arrays from the host mirrors — the one H2D
        an epoch pays, staged through pinned snapshots (an upload is a
        copy, so later mirror edits never reach what a chunk reads). Runs
        only with the mirrors current (no undrained chunk)."""
        c: dict[str, Any] = {
            "last_tok": self.last_tok, "gen_count": self.gen_count,
            "active": self.active, "real_len": self.real_len,
            "budget": self.budget, "temp": self.temp,
            "seed": self.seeds.astype(np.int64),
        }
        self._carry_seeded = bool((self.seeds >= 0).any())
        if self.spec_k:
            c["hist"] = self.hist_host
        if self.paged:
            act = self.active
            if act.any():
                self._carry_h0 = int((self.real_len + self.gen_count)[act].max())
                self._carry_hcap = int((self.real_len + self.budget)[act].max())
            else:
                self._carry_h0 = self._carry_hcap = 0
            w = self._pages_w(
                max(min(self._carry_h0 + self._chunk_span, self._carry_hcap), 1)
            )
            c["table"] = self.pager.table[:, :w]
            self._carry_pages_w = w
        else:
            c["gen_start"] = self.gen_start
        self._program("carry", host=c)
        self._carry_dirty = False
        self._carry_chunks = 0
        self.overlap["carry_uploads"] += 1

    def _dispatch_chunk(self) -> _PendingChunk:
        """Queue one decode chunk on the device carry and thread its
        per-row outputs into the carry for the next one; the outputs are
        staged for the host (copy + event) right behind it."""
        hook = self._fault_hooks.get("pre_chunk")
        if hook is not None:
            hook(self)  # fault seam: a test wedges or slows the loop here
        now = time.perf_counter()
        if self._last_dispatch is not None:
            self._ewma("decode_gap_ms", (now - self._last_dispatch) * 1e3)
        self._last_dispatch = now
        self._ewma(
            "slot_occupancy",
            sum(s is not None for s in self._slots) / self.max_batch,
        )
        active_in = self._carry["active"]
        if self.paged:
            # page-horizon growth across chunks: active rows advance at most
            # chunk_span tokens a chunk; when the bound crosses a pow2 page
            # bucket, widen the device table (the host table is constant
            # within an epoch)
            horizon = min(
                self._carry_h0 + (self._carry_chunks + 1) * self._chunk_span,
                self._carry_hcap,
            )
            w = self._pages_w(max(horizon, 1))
            if w > self._carry_pages_w:
                self._program("widen", table=self.pager.table[:, :w])
                self._carry_pages_w = w
                self.overlap["carry_uploads"] += 1
        res = self._program("chunk", seeded=self._carry_seeded)
        self._carry_chunks += 1
        self.stats["chunks"] += 1
        named = {k: res[k] for k in ("toks", "valid", "eos", "prop", "acc")
                 if k in res}
        named.update(active_in=active_in, last_tok=res["last_tok"],
                     gen_count=res["gen_count"], active_out=res["active"])
        return _PendingChunk(staged=self._outputs.stage(named),
                             slots=list(self._slots), t_dispatch=time.monotonic())

    def _run_carry(self, host: dict) -> None:
        """Upload the per-row arrays of an epoch: the device carry (each a
        pinned snapshot, so later mirror edits never reach it)."""
        up = self.uploader.upload
        self._carry = {k: up(v) for k, v in host.items()}

    def _run_widen(self, table) -> None:
        """Widen the carry's block table (a page bucket crossed mid-epoch)."""
        self._carry["table"] = self.uploader.upload(table)

    def _run_chunk(self, seeded: bool) -> dict:
        """One decode chunk on the carry; its per-row outputs become the
        carry of the next."""
        c = self._carry
        res = self._chunk(c, seeded=seeded)
        for k in ("last_tok", "gen_count", "active", "hist"):
            if k in res:
                c[k] = res[k]
        return res

    def _drain_chunk(self, p: _PendingChunk) -> None:
        """Wait for one chunk's staged outputs (its own event — never the
        chunk queued behind it), credit tokens to the requests resident at
        dispatch, refresh the host mirrors, and retire rows that hit EOS
        or their budget. Rows retired while the chunk was in flight are
        masked out: their tokens belong to a request that left the row."""
        t0 = time.perf_counter()
        o = self._outputs.fetch(p.staged)
        self._ewma("d2h_drain_ms", (time.perf_counter() - t0) * 1e3)
        toks, valid, act_in = o["toks"], o["valid"], o["active_in"]
        chunk_prop = chunk_acc = 0
        for row in range(self.max_batch):
            req = p.slots[row]
            if req is None or not act_in[row]:
                continue  # free or still prefilling at dispatch
            if self._slots[row] is not req:
                continue  # retired while in flight
            hit_eos = False
            fresh: list[int] = []
            if self.spec_k:
                # (steps, K+1) planes: a step's valid tokens are a prefix
                # of its span; only the eos flag (a live EOS) stops a row
                v, t, e = valid[row], toks[row], o["eos"][row]
                hit_eos = bool(e.any())
                stop_s = int(np.argmax(e)) if hit_eos else self.chunk_steps - 1
                flat = t[: stop_s + 1][v[: stop_s + 1]]
                remaining = req.max_new_tokens - len(req.tokens)
                fresh = [int(x) for x in flat[:remaining]]
                row_prop = int(o["prop"][row].sum())
                row_acc = int(o["acc"][row].sum())
                self.stats["spec_proposed"] += row_prop
                self.stats["spec_accepted"] += row_acc
                chunk_prop += row_prop
                chunk_acc += row_acc
                # history mirror: drained tokens at their positions, so the
                # next epoch's upload is exact
                start = int(self.real_len[row]) + len(req.tokens)
                self.hist_host[row, start: start + len(fresh)] = fresh
            else:
                for j in range(self.chunk_steps):
                    if len(req.tokens) + len(fresh) >= req.max_new_tokens:
                        break
                    if not valid[row, j]:
                        hit_eos = True
                        break
                    fresh.append(int(toks[row, j]))
            req.push(fresh)
            if req.espan is not None and fresh:
                # retroactive decode.chunk span (host ints only): stamped
                # at dispatch, reported here so the loop never holds an
                # open span per chunk
                attrs: dict[str, Any] = {"row": row, "tokens": len(fresh)}
                if self.spec_k:
                    attrs["spec_proposed"] = row_prop
                    attrs["spec_accepted"] = row_acc
                TRACER.record_span(
                    "decode.chunk", parent=req.espan,
                    start=p.t_dispatch, end=time.monotonic(), attrs=attrs,
                )
            # per-row mirror refresh: rows edited by admit/prefill since
            # dispatch keep their newer host values
            self.last_tok[row] = o["last_tok"][row]
            self.gen_count[row] = o["gen_count"][row]
            self.active[row] = bool(o["active_out"][row])
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._finish(row, carry_stale=False)
        if chunk_prop:
            self._ewma("spec_acceptance", chunk_acc / chunk_prop)


class _AdmittedStream:
    """Iterator wrapper that releases exactly one admission slot however
    the stream ends: exhaustion, error, or close before the first next."""

    def __init__(self, it, release):
        self._it = it
        self._release = release
        self._released = False

    def _release_once(self) -> None:
        if not self._released:
            self._released = True
            self._release()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except BaseException:  # StopIteration included: the stream is over
            self._release_once()
            raise

    def close(self) -> None:
        try:
            self._it.close()  # cancels the engine row
        finally:
            self._release_once()


def fetch_kv_span(
    engine: LMEngine, peer: str, model_name: str, ids, temperature: float,
    *, trace: Any = None, timeout_s: float = 30.0, seed: int | None = None,
) -> PreparedKVSpan | None:
    """The decode replica's half of a disaggregated dispatch: pull the
    finished span for ``ids`` from the prefill replica at ``peer`` (the
    ``x-kft-prefill-peer`` URL) and check it against ``engine``. Returns
    the :class:`PreparedKVSpan`, or None on ANY failure (peer down or
    gone mid-ship, bad payload, layout or quantization mismatch, the
    ``kv_ship`` fault hook), counted in ``kv_ship_fallbacks``: the caller
    then prefills locally, and the client sees the same tokens. Runs on
    an HTTP thread (blocking ``urllib``), never the scheduler's. The
    ``kv.ship`` span (under ``trace``) bridges the two legs of one trace
    id: its context goes to the peer, so the prefill replica's engine
    spans land under the trace the gateway minted."""
    import json
    import urllib.request

    engine._refuse_under_mesh("KV-span import (x-kft-prefill-peer)")
    t0 = time.monotonic()
    span = TRACER.span("kv.ship", parent=trace)
    if span:
        span.set_attr("peer", peer)
        span.set_attr("model", model_name)
        span.set_attr("prompt_tokens", len(ids))
    try:
        hook = engine._fault_hooks.get("kv_ship")
        if hook is not None:
            hook(engine)  # fault seam: a test drops the ship here
        payload = {"ids": [int(t) for t in ids],
                   "temperature": float(temperature)}
        if seed is not None:
            # the peer's first token (in the meta) must come from the same
            # seeded stream as the rest
            payload["seed"] = int(seed)
        hdrs = {"Content-Type": "application/json"}
        if span:
            hdrs[TRACE_HEADER] = span.header()
        req = urllib.request.Request(
            f"{peer.rstrip('/')}/v2/models/{model_name}/kv_span:prefill",
            data=json.dumps(payload).encode(), headers=hdrs, method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            blob = resp.read()
        entries, meta = decode_kv_entries(blob)
        if not entries or meta is None:
            raise ValueError("span payload missing entries or meta")
        prepared = engine.prepare_kv_span(ids, entries[0][1], meta)
    except Exception as e:  # noqa: BLE001 — every failed ship degrades to
        engine._count("kv_ship_fallbacks")  # a local prefill
        if span:
            span.set_attr("error", f"{type(e).__name__}: {e}")
            span.end("error")
        return None
    KV_SHIP_BYTES.labels(model=model_name, direction="import").inc(len(blob))
    KV_SHIP_MS.observe((time.monotonic() - t0) * 1e3)
    engine._count("kv_ship_bytes", len(blob))
    if span:
        span.set_attr("bytes", len(blob))
        span.end()
    return prepared


class LMEngineModel(LMRuntimeModel):
    """Engine-backed serving model (``causal-lm-engine``): the
    ``causal-lm`` runtime's data path (tokenizer, preprocess,
    postprocess; see :class:`LMRuntimeModel`) with continuous batching
    underneath, so rows from concurrent requests share one decode batch.
    Request rows are text, ``{"text": ...}``, ``{"input_ids": [...]}`` or
    a bare id list, with optional ``max_new_tokens`` (clamped to the
    model's) and ``temperature``; responses are ``{"token_ids": [...]}``.
    The request headers (``serve/headers.py``) carry the deadline,
    priority and sampling seed; ``x-kft-resume-tokens`` continues a
    stream (:meth:`stream_row_tokens`); ``x-kft-prefill-peer`` (a prefill
    replica's URL) has each row's span pulled from that replica
    (:func:`fetch_kv_span`) so that this one runs no prefill, and
    ``x-kft-session`` keys the host KV tier (``host_kv_bytes``).

    Weights, ``device`` and ``seed`` as in :class:`LMRuntimeModel`;
    ``prefill_buckets`` (or ``buckets.seq_lens``) are the engine's prefill
    buckets. ``load()`` builds the model and starts the engine; on the card
    it runs :meth:`warmup` (the kernel build included) before the model
    reports ready. Engine knobs (``kv_pool_tokens``, ``pipeline_depth``,
    ``spec_draft_tokens``, ``prefix_cache_entries``, ``prefill_chunk``,
    ...) pass through with the JAX defaults: without ``kv_pool_tokens``
    the engine runs the dense cache. ``max_seq`` defaults to the largest
    bucket plus ``max_new_tokens`` (plus K in dense speculative mode).
    ``watchdog`` (default on) supervises the engine
    (``serve/watchdog.py``) with the JAX defaults of its thresholds; a
    trip rebuilds the engine's device state and shares only the weights
    with the old one.

    ``mesh``/``rules`` (the JAX signature) serve tensor-parallel: every
    rank constructs the same model from the same arguments and calls
    :meth:`load`. On rank 0, the leader, ``load`` returns a ready model to
    put behind ``ModelServer``; on every other rank it runs the leader's
    device programs and returns when the leader's engine stops (its
    ``unload``). A tensor-parallel engine has no watchdog rebuild yet, so
    ``watchdog=False`` is required.
    """

    def __init__(
        self, name: str, storage_path: str | None = None, *,
        config: TransformerConfig | None = None,
        buckets: BucketSpec | None = None,
        prefill_buckets: tuple[int, ...] | None = None,
        max_new_tokens: int = 32, eos_id: int = 1, seed: int = 0,
        state_dict: Mapping[str, torch.Tensor] | None = None, device=None,
        max_batch: int = 8, max_seq: int | None = None, watchdog: bool = True,
        watchdog_interval_s: float = 0.5, watchdog_wedge_factor: float = 8.0,
        watchdog_min_wedge_s: float = 30.0, **engine_kwargs,
    ):
        if prefill_buckets is not None:
            if buckets is not None:
                raise ValueError("give buckets or prefill_buckets, not both")
            buckets = BucketSpec(batch_sizes=(1,),
                                 seq_lens=tuple(sorted(prefill_buckets)))
        super().__init__(
            name, storage_path, config=config, buckets=buckets,
            max_new_tokens=max_new_tokens, eos_id=eos_id, seed=seed,
            state_dict=state_dict, device=device,
        )
        seq_lens = self.buckets.seq_lens
        dense_k = (engine_kwargs.get("spec_draft_tokens", 0)
                   if engine_kwargs.get("kv_pool_tokens") is None else 0)
        self._engine_config = LMEngineConfig(
            max_batch=max_batch,
            max_seq=max_seq or seq_lens[-1] + max_new_tokens + dense_k,
            prefill_buckets=tuple(seq_lens), eos_id=eos_id, seed=seed,
            **engine_kwargs,
        )
        _reject_unported(self._engine_config)
        if self._engine_config.mesh is not None and watchdog:
            raise NotImplementedError(
                "the watchdog's engine rebuild under a tensor-parallel mesh "
                f"is not ported yet (ROADMAP {TP_UNPORTED}): pass "
                "watchdog=False")
        self.engine: LMEngine | None = None
        self._executor: cf.ThreadPoolExecutor | None = None
        #: engine watchdog: supervises ``engine``, flips ``ready`` on trips
        self.watchdog = None
        self._watchdog_on = watchdog
        self._watchdog_config = dict(
            interval_s=watchdog_interval_s, wedge_factor=watchdog_wedge_factor,
            min_wedge_s=watchdog_min_wedge_s,
        )
        #: what the last :meth:`warmup` did (``seconds``, ``libraries``)
        self.warmup_report: dict | None = None
        # admission control on the caller's thread: the private executor
        # is sized max_batch, so excess rows would otherwise queue unseen
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        #: called after every supervised restart (the server zeroes its
        #: load signals there)
        self._restart_listeners: list = []

    def add_restart_listener(self, fn) -> None:
        self._restart_listeners.append(fn)

    def _make_engine(self) -> LMEngine:
        """One engine from the stored knobs over the shared weights: its
        own page pool, uploader, output ring, prefix cache and
        generator. ``load`` builds the first, a restart the next."""
        eng = LMEngine(self._lm, config=self._engine_config)
        eng.model_name = self.name
        return eng

    def restart_engine(self, err: Exception | None = None) -> LMEngine:
        """Rebuild the engine's device state (the watchdog's rebuild hook;
        operators may call it too). The old engine must already be
        poisoned or stopped: a wedged thread of it is abandoned and exits
        on its own."""
        self.engine = self._make_engine().start()
        # the fresh engine starts with zeroed stats; the admission count
        # must match. Poisoned requests still unwinding release later,
        # and _release clamps at zero.
        with self._inflight_lock:
            self._inflight = 0
        for fn in list(self._restart_listeners):
            try:
                fn()
            except Exception:  # noqa: BLE001 — a listener must not block
                pass  # the restart; readiness recovery comes first
        return self.engine

    def _set_ready(self, ready: bool) -> None:
        # the watchdog flips this first on a trip: /v2/health/ready says
        # not ready while the engine rebuilds
        self.ready = ready

    def load(self) -> bool:
        self._lm = self._build_lm()
        self._executor = cf.ThreadPoolExecutor(
            max_workers=self._engine_config.max_batch,
            thread_name_prefix=f"lm-engine-{self.name}",
        )
        eng = self._make_engine()
        if not eng.is_leader:
            # a follower rank of a tensor-parallel engine: run the leader's
            # device programs until the leader's engine stops
            self.engine = eng
            eng.start()
            return True
        self.engine = eng.start()
        if self.engine.device.type == "cuda":
            # the first request must not pay the kernels' build
            self.warmup()
        if self._watchdog_on:
            from kubeflow_tpu_torch.serve.watchdog import (
                EngineWatchdog,
                WatchdogConfig,
            )

            self.watchdog = EngineWatchdog(
                lambda: self.engine, self.restart_engine,
                on_ready=self._set_ready,
                config=WatchdogConfig(**self._watchdog_config),
                model_name=self.name,
            ).start()
        self.ready = True
        return True

    def unload(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
        super().unload()

    def warmup(self) -> dict:
        """Run every path the first requests would: on the card, build
        the CUDA kernels and load each library this config launches (a
        failed build raises); then a prompt per prefill bucket, a verify
        when ``spec_draft_tokens > 0`` (a repeating prompt, so the drafter
        matches), and a prefix store and hit when the prefix cache is on.
        Eager programs have no shape-keyed compile, so one pass per path
        warms it. Warmup traffic must not pollute production metrics:
        ``stats`` and ``overlap`` restart at zero and ``ttft_ms`` empties;
        warmup requests carry no trace, so the TTFT/TPOT histograms never
        see them. Returns (and keeps as ``warmup_report``) the seconds it
        took, the kernel libraries it loaded and whether the model was
        already reporting ready while it ran (not when ``load`` ran it)."""
        t0 = time.perf_counter()
        eng = self.engine
        libraries = []
        if eng.device.type == "cuda":
            from kubeflow_tpu_torch.ops import _build, paged_attention

            _build.build()
            if eng.paged_attn_impl == "kernel":
                paged_attention._lib()
                libraries.append("paged_attention")
        vocab = self.config.vocab_size
        for i, s in enumerate(eng.prefill_buckets):
            eng.submit([2 + i % (vocab - 2)] * s, max_new_tokens=2)
        if eng.spec_k:
            s0 = eng.prefill_buckets[0]
            cap = eng.max_seq - s0
            if cap >= 2:
                eng.submit(([3, 5, 7] * s0)[:s0],
                           max_new_tokens=min(eng.spec_k + 2, cap))
        if eng._prefix_cache is not None and 17 + 2 <= eng.max_seq and (
            eng.prefill_chunk or eng.prefill_buckets[-1] >= 17
        ):
            eng.drop_prefix_cache()
            tok = 2 + len(eng.prefill_buckets) % (vocab - 2)
            tail = 2 + (tok - 1) % (vocab - 2)
            eng.submit([tok] * 17, max_new_tokens=2)      # stores 16
            eng.submit([tok] * 16 + [tail], max_new_tokens=2)  # hits it
            eng.drop_prefix_cache()
        for key in eng.stats:
            eng.stats[key] = 0
        for key in eng.overlap:
            eng.overlap[key] = 0 if key == "carry_uploads" else 0.0
        eng.ttft_ms.clear()
        self.warmup_report = {"seconds": time.perf_counter() - t0,
                              "libraries": libraries, "ready": self.ready}
        return self.warmup_report

    def _row_budget(self, row) -> int:
        """The row's ``max_new_tokens`` clamped to the model cap."""
        req = row.get("max_new_tokens")
        if req is None:
            return self.max_new_tokens
        return max(1, min(int(req), self.max_new_tokens))

    def _pull_kv_span(self, row, peer, trace, deadline, *, ids=None,
                      seed=None):
        """The row's span from its prefill peer; None without a peer or on
        any failed ship (then the engine prefills locally). ``ids``
        overrides the row's prompt: a resumed dispatch pulls the span of
        prompt + committed tokens, so this replica runs no prefill."""
        eng = self.engine
        if not peer or eng is None:
            return None
        timeout_s = 30.0
        if deadline is not None:
            timeout_s = max(0.1, min(timeout_s, deadline - time.monotonic()))
        return fetch_kv_span(
            eng, peer, self.name, row["ids"] if ids is None else ids,
            row["temperature"], trace=trace, timeout_s=timeout_s, seed=seed,
        )

    def _submit_row(self, row, deadline: float | None = None,
                    priority: int = 0, seed: int | None = None,
                    peer: str | None = None, session: str | None = None,
                    trace: Any = None) -> dict:
        kv_span = self._pull_kv_span(row, peer, trace, deadline, seed=seed)
        toks = self.engine.submit(
            row["ids"], max_new_tokens=self._row_budget(row),
            temperature=row["temperature"], deadline=deadline,
            priority=priority, seed=seed, trace=trace, kv_span=kv_span,
            session=session,
        )
        return {"token_ids": toks}

    def _admit(self, n_rows: int) -> None:
        eng = self.engine  # snapshot: unload() may clear it concurrently
        if eng is None:
            raise RuntimeError(f"model {self.name!r} is unloaded")
        cap = self._engine_config.max_batch + eng.max_queue
        with self._inflight_lock:
            if self._inflight + n_rows > cap:
                raise EngineOverloaded(
                    f"{self._inflight} rows in flight (capacity {cap})"
                )
            self._inflight += n_rows

    def _release(self, n_rows: int) -> None:
        with self._inflight_lock:
            # clamped: a restart zeroes the count while poisoned requests
            # are still unwinding toward their release
            self._inflight = max(0, self._inflight - n_rows)

    def predict(self, rows, headers=None) -> list[dict]:
        # rows fan out so they share the decode batch with each other and
        # everyone else's; release only after EVERY row settles, or new
        # requests would pass the cap while siblings still run
        deadline = deadline_from_headers(headers)
        priority = priority_from_headers(headers)
        seed = seed_from_headers(headers)
        peer = header_get(headers, PREFILL_PEER_HEADER)
        session = header_get(headers, SESSION_HEADER)
        ctx = ctx_from_headers(headers)
        self._admit(len(rows))
        try:
            futs = [self._executor.submit(self._submit_row, r, deadline,
                                          priority, seed, peer, session, ctx)
                    for r in rows]
            cf.wait(futs)
        finally:
            self._release(len(rows))
        return [f.result() for f in futs]

    def stream_row_tokens(self, row, headers=None) -> _AdmittedStream:
        """Token-chunk iterator for one preprocessed row: the server's
        ``generate_stream``. Admission is EAGER (model cap and engine
        admission both run here), so an overload or shed raises before
        the server commits a 200; the wrapper releases the slot however
        the stream ends, also when closed before its first chunk. With a
        prefill peer the span is pulled here too, for prompt + resume
        tokens, on the server's request thread."""
        deadline = deadline_from_headers(headers)
        priority = priority_from_headers(headers)
        seed = seed_from_headers(headers)
        resume = resume_from_headers(headers)
        peer = header_get(headers, PREFILL_PEER_HEADER)
        session = header_get(headers, SESSION_HEADER)
        ctx = ctx_from_headers(headers)
        self._admit(1)
        try:
            kv_span = self._pull_kv_span(
                row, peer, ctx, deadline, seed=seed,
                ids=list(row["ids"]) + list(resume or ()),
            )
            it = self.engine.stream(
                row["ids"], max_new_tokens=self._row_budget(row),
                temperature=row["temperature"], deadline=deadline,
                priority=priority, seed=seed, resume_tokens=resume,
                trace=ctx, kv_span=kv_span, session=session,
            )
        except BaseException:
            self._release(1)
            raise
        return _AdmittedStream(it, lambda: self._release(1))

    def postprocess(self, outputs, headers=None) -> Any:
        return {"predictions": outputs}


def engine_from_runtime(
    runtime: LMRuntimeModel, *, max_batch: int = 8, max_seq: int = 256, **kw
) -> LMEngine:
    """A started engine over a loaded runtime's model (loading it first
    when it is not ready); ``kw`` are engine knobs."""
    if not runtime.ready:
        runtime.load()
    return LMEngine(runtime._lm, max_batch=max_batch, max_seq=max_seq,
                    eos_id=runtime.eos_id, **kw).start()
