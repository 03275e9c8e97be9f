"""Generative LM serving over a dense KV cache: the port of
``kubeflow_tpu/serve/generate.py``.

Prompt in, tokens out (the KServe HuggingFace runtime's generative
path): prefill writes the padded prompt into a ``(B, kv_heads, P +
max_new_tokens, head_dim)`` cache, then each new token costs one decode
step against it.

- **Bucketed shapes**: prompts pad to (batch, prefill) buckets
  (:class:`~kubeflow_tpu_torch.serve.model.BucketSpec`) and every
  generation runs ``max_new_tokens`` steps, as in JAX.
- **Ragged batches by kv masks**: right-padded prompts write pad keys
  and values into the cache; :func:`decode_kv_mask` keeps them out of
  every attention, and per-row positions keep RoPE continuous across the
  prompt→generation boundary.
- Rows that hit EOS keep stepping but emit ``pad_id``; the validity
  count, not a pad search, trims the output.

Where JAX runs the whole generation as ONE jitted program (prefill plus
a ``lax.scan`` of decode steps), :func:`make_generate_fn` here is a
Python loop of eager steps: every step is enqueued by the host.
Capturing it as one graph is later work (ROADMAP queue 3, eager
dispatch).

Sampling matches JAX draw for draw: the generation's key is split once
before the first token and once a step (``serve/threefry.py``
:func:`split`), and a temperature row draws from
``jax.random.categorical`` of that step's key over the whole batch
(:func:`categorical_one_key`), so a seeded ``LMRuntimeModel`` samples the
JAX runtime's tokens.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_kv_cache,
    init_weights,
)
from kubeflow_tpu_torch.serve.model import BucketSpec, Model
from kubeflow_tpu_torch.serve.threefry import categorical_one_key, prng_key, split


def _rows(x, dev, ndim: int) -> torch.Tensor:
    """A scalar or ``(B,)`` value as a ``(B or 1, 1, ...)`` tensor of
    ``ndim`` dims on ``dev`` (JAX's ``atleast_1d`` plus new axes)."""
    return torch.as_tensor(x, device=dev).reshape(-1, *([1] * (ndim - 1)))


def decode_kv_mask(kpos, prompt_len, gen_start, slot, window=None):
    """(B, T) cache-slot mask for ONE decode step over a ``[prompt | gap
    | gen]`` row layout: prompt slots ``[0, prompt_len)`` sit at their
    token positions; gen slot ``s`` in ``[gen_start, slot]`` holds token
    position ``prompt_len + (s - gen_start)`` (the gap between
    ``prompt_len`` and ``gen_start`` is padding and never attended).

    ``window`` applies sliding-window attention in token-position space:
    the query (at position ``prompt_len + slot - gen_start``) keeps keys
    with position > query pos - window, which in the gen region reduces
    to ``s > slot - window``. Shared by :func:`make_generate_fn` and the
    dense ``LMEngine``; scalars and ``(B,)`` tensors both broadcast."""
    dev = kpos.device
    pl, gs, sl = (_rows(x, dev, 2) for x in (prompt_len, gen_start, slot))
    k = kpos[None, :]
    prompt_keep = k < pl
    gen_keep = (k >= gs) & (k <= sl)
    if window is not None:
        qpos = pl + sl - gs
        prompt_keep = prompt_keep & (k > qpos - window)
        gen_keep = gen_keep & (k > sl - window)
    return prompt_keep | gen_keep


def decode_span_kv_mask(kpos, prompt_len, gen_start, slot0, span, window=None):
    """(B, span, T) cache-slot mask for a SPAN of decode queries at gen
    slots ``slot0 .. slot0+span-1``, the speculative verify step: query
    j attends the prompt slots plus gen slots ``[gen_start, slot0+j]``
    (the verify forward writes every span position's KV before
    attending, so without the per-query bound query j would see later
    draft keys). The slot→position mapping and the window are
    :func:`decode_kv_mask`'s, lifted to a per-query axis."""
    dev = kpos.device
    pl, gs = (_rows(x, dev, 3) for x in (prompt_len, gen_start))
    sl = _rows(slot0, dev, 3) + torch.arange(span, device=dev)[None, :, None]
    k = kpos[None, None, :]
    prompt_keep = k < pl
    gen_keep = (k >= gs) & (k <= sl)
    if window is not None:
        qpos = pl + sl - gs
        prompt_keep = prompt_keep & (k > qpos - window)
        gen_keep = gen_keep & (k > sl - window)
    return prompt_keep | gen_keep


def gumbel_argmax(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw over the last axis of f32 ``scores`` (logits, or
    log-probabilities) by Gumbel-max, with noise from ``generator``."""
    u = torch.rand(
        scores.shape, generator=generator, device=scores.device
    ).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def sample_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """The engine's per-row greedy/temperature sampling over ``(B, V)``
    logits.

    ``temperature`` is per row ``(B,)``: rows at ``<= 0`` take the argmax
    (the first index on ties, as ``jnp.argmax``); the others draw from
    ``softmax(logits / t)`` by Gumbel-max with noise from ``generator``.
    These unseeded draws differ from the JAX engine's engine-key stream,
    so they match it only in distribution; seeded requests draw through
    ``serve/threefry.py`` instead and match it token for token.
    """
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    return torch.where(temperature <= 0.0, greedy, gumbel_argmax(scaled, generator))


def sample_logits_key(logits: torch.Tensor, key, temperature: torch.Tensor,
                      *, sampling: bool = True) -> torch.Tensor:
    """JAX ``sample_logits``: per-row greedy/temperature sampling over
    ``(B, V)`` logits with ONE threefry ``key`` for the batch
    (``jax.random.categorical`` over the whole batch). ``sampling=False``
    (no row above temperature 0) skips the draw, which greedy rows never
    keep."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    return torch.where(temperature <= 0.0, greedy,
                       categorical_one_key(key, scaled))


def make_generate_fn(
    model: TransformerLM,
    *,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
):
    """``generate(prompt, prompt_len, rng, temperature) -> (tokens,
    n_valid)`` over ``model`` (which holds its weights, where the JAX
    function takes ``params``): prefill at ``cache_index=0``, then
    ``max_new_tokens - 1`` decode steps. ``prompt (B, P)`` and
    ``prompt_len``, ``temperature (B,)`` are tensors on the model's
    device; ``rng`` is a threefry key (``(2,)`` words). Returns ``(B,
    max_new_tokens)`` tokens (``pad_id`` after a row's EOS) and each
    row's count of real tokens."""
    cfg = model.cfg

    @torch.inference_mode()
    def generate(prompt, prompt_len, rng, temperature):
        B, P = prompt.shape
        dev = prompt.device
        max_len = P + max_new_tokens
        if not cfg.use_rope and max_len > cfg.max_seq_len:
            # a learned-position gather past the table would be garbage
            raise ValueError(
                f"prompt bucket {P} + max_new_tokens {max_new_tokens} "
                f"exceeds max_seq_len {cfg.max_seq_len}"
            )
        prompt_len = prompt_len.to(torch.int64)
        sampling = bool((temperature > 0.0).any())  # one read, before the loop
        cache = init_kv_cache(cfg, B, max_len, device=dev)
        logits, cache = model(prompt, cache=cache, cache_index=0)
        # each row's next-token logits sit at its LAST REAL prompt slot
        last = logits[torch.arange(B, device=dev), prompt_len - 1]
        rng, sub = split(rng)
        first = sample_logits_key(last, sub, temperature, sampling=sampling)
        valid = first != eos_id
        done = ~valid
        tok = torch.where(done, pad_id, first)
        toks, valids = [tok], [valid]
        kpos = torch.arange(max_len, device=dev)
        # mask operands stay on the device: a host scalar would be a
        # synchronizing copy every step
        gen_start = torch.full((B,), P, dtype=torch.int64, device=dev)
        for j in range(max_new_tokens - 1):
            rng, sub = split(rng)
            slot = P + j  # this token's cache slot (the same for all rows)
            # attend real prompt slots and generated slots up to and incl.
            # this one; never pad slots, never unwritten ones
            kv_mask = decode_kv_mask(kpos, prompt_len, gen_start, gen_start + j,
                                     cfg.attn_window)
            lg, cache = model(tok[:, None], cache=cache, cache_index=slot,
                              positions=(prompt_len + j)[:, None],
                              kv_mask=kv_mask)
            nxt = sample_logits_key(lg[:, 0], sub, temperature,
                                    sampling=sampling)
            # a slot holds real content iff no earlier EOS and this draw
            # is not EOS: pad_id may be a real token, so validity is kept
            valid = ~done & (nxt != eos_id)
            done = done | (nxt == eos_id)
            tok = torch.where(done, pad_id, nxt)
            toks.append(tok)
            valids.append(valid)
        return torch.stack(toks, 1), torch.stack(valids, 1).sum(1)

    return generate


def restore_state(storage_path: str) -> dict:
    """The model ``state_dict`` under ``storage_path``, in either layout a
    user will have:

    1. a ``train/checkpoint.py`` ``Checkpointer`` directory (step
       subdirectories): the train→serve handoff takes the newest step
       that verifies, and its ``model`` state;
    2. a bare saved state: a ``torch.save`` file, or a directory holding
       one as ``state.pt`` (a ``state_dict``, or a trainer state with a
       ``model`` entry).

    A path that does not exist fails closed before anything is created;
    a train checkpoint that fails to restore raises its error."""
    from kubeflow_tpu_torch.train.checkpoint import (
        STATE_NAME,
        CheckpointConfig,
        Checkpointer,
    )

    path = os.path.abspath(storage_path)
    if not os.path.exists(path):
        raise RuntimeError(
            f"storage_path {path!r} does not exist (failed mount / typo?)"
        )
    if os.path.isdir(path):
        steps = [p for p in os.listdir(path)
                 if p.isdigit() and os.path.isdir(os.path.join(path, p))]
        if steps:
            try:
                state = Checkpointer(CheckpointConfig(directory=path)).restore()
            except Exception as e:
                raise RuntimeError(
                    f"storage_path {path!r} is a train checkpoint (latest "
                    f"step {max(map(int, steps))}) but restoring it failed: {e}"
                ) from e
        elif os.path.isfile(os.path.join(path, STATE_NAME)):
            state = torch.load(os.path.join(path, STATE_NAME),
                               map_location="cpu", weights_only=True)
        else:
            raise RuntimeError(
                f"storage_path {path!r} holds neither checkpoint steps "
                f"nor a {STATE_NAME}"
            )
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "model" in state:
        return state["model"]
    return state


class LMRuntimeModel(Model):
    """Causal-LM serving runtime (``causal-lm``): text or ids in →
    generated ids out, one :func:`make_generate_fn` run a request over
    its padded (batch, prompt) bucket.

    v1 request rows: ``"prompt text"``, ``{"text": ..}``, ``{"input_ids":
    [...]}`` or a bare id list, with an optional per-row ``temperature``
    (0 = greedy). Response rows: ``{"token_ids": [...]}``.

    Weights: ``storage_path`` (a port checkpoint, see
    :func:`restore_state`), else ``state_dict`` (e.g. bridged JAX
    params), else random from ``seed``. The model is built on ``device``
    (``None`` = the CUDA card). Sampling keys come from
    ``PRNGKey(seed)``, split once a request as in JAX.
    """

    def __init__(
        self,
        name: str,
        storage_path: str | None = None,
        *,
        config: TransformerConfig | None = None,
        buckets: BucketSpec | None = None,
        max_new_tokens: int = 32,
        eos_id: int = 1,
        seed: int = 0,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        device=None,
    ):
        super().__init__(name)
        self.config = config or TransformerConfig(causal=True)
        if not self.config.causal:
            raise ValueError(
                f"{type(self).__name__} needs a causal TransformerConfig")
        self.buckets = buckets or BucketSpec(batch_sizes=(1, 4),
                                             seq_lens=(32, 128))
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self._storage_path = storage_path
        self._state_dict = state_dict
        self._seed = seed
        self._device = device
        self._lm: TransformerLM | None = None
        self._generate = None
        self._rng = prng_key(torch.tensor(seed))
        #: one generation at a time: the key stream advances in request order
        self._run_lock = threading.Lock()
        from kubeflow_tpu_torch.serve.runtimes import SimpleTokenizer

        self.tokenizer = SimpleTokenizer(self.config.vocab_size)
        # bounded: a long-lived server must not grow a list per request
        self.stats = {"requests": 0, "generate_ms": deque(maxlen=1024)}
        if not self.config.use_rope:
            worst = self.buckets.seq_lens[-1] + max_new_tokens
            if worst > self.config.max_seq_len:
                raise ValueError(
                    f"largest seq bucket {self.buckets.seq_lens[-1]} + "
                    f"max_new_tokens {max_new_tokens} exceeds "
                    f"max_seq_len {self.config.max_seq_len}"
                )

    # -- lifecycle ------------------------------------------------------- #

    def _build_lm(self) -> TransformerLM:
        """The weights (restored first: a bad ``storage_path`` fails before
        anything is allocated) in a ``TransformerLM`` on the device."""
        state = (restore_state(self._storage_path)
                 if self._storage_path is not None else self._state_dict)
        model = TransformerLM(self.config, device=self._device)
        if state is not None:
            model.load_state_dict(state)
        else:  # random weights: latency benchmarks and tests
            init_weights(model, self._seed)
        return model.eval().requires_grad_(False)

    def load(self) -> bool:
        self._lm = self._build_lm()
        self._generate = make_generate_fn(
            self._lm, max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
        )
        self.ready = True
        return True

    def unload(self) -> None:
        self._lm = None
        self._generate = None
        super().unload()

    def warmup(self) -> None:
        """One generation per (batch, prompt) bucket."""
        for b in self.buckets.batch_sizes:
            for s in self.buckets.seq_lens:
                self._run(np.zeros((b, s), np.int64), np.full((b,), s, np.int64),
                          np.zeros((b,), np.float32))

    # -- data path ------------------------------------------------------- #

    def preprocess(self, payload: Any, headers: Mapping[str, str] | None = None):
        if isinstance(payload, Mapping) and "instances" in payload:
            payload = payload["instances"]
        rows = []
        for inst in payload:
            temperature = 0.0
            budget = None
            if isinstance(inst, str):
                ids = self.tokenizer.encode(inst)
            elif isinstance(inst, Mapping):
                temperature = float(inst.get("temperature", 0.0))
                if inst.get("max_new_tokens") is not None:
                    # per-request output budget (vLLM max_tokens analog);
                    # engine-backed runtimes clamp it to the model cap
                    budget = int(inst["max_new_tokens"])
                    if budget < 1:
                        raise ValueError(
                            f"max_new_tokens must be >= 1, got {budget}"
                        )
                if isinstance(inst.get("text"), str):
                    ids = self.tokenizer.encode(inst["text"])
                else:
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

    def _run(self, prompt, prompt_len, temperature):
        dev = self._lm.device
        with self._run_lock:
            self._rng, sub = split(self._rng)
            tokens, n_valid = self._generate(
                torch.from_numpy(prompt).to(dev),
                torch.from_numpy(prompt_len).to(dev), sub,
                torch.from_numpy(temperature).to(dev),
            )
            return tokens.cpu().numpy(), n_valid.cpu().numpy()

    def predict(self, rows, headers=None) -> list[dict]:
        n = len(rows)
        longest = max(len(r["ids"]) for r in rows)
        bb = self.buckets.bucket_batch(n)
        bs = self.buckets.bucket_seq(longest)
        prompt = np.zeros((bb, bs), np.int64)
        plen = np.ones((bb,), np.int64)  # pad rows: length 1, harmless
        temperature = np.zeros((bb,), np.float32)  # honoured per row
        for i, r in enumerate(rows):
            prompt[i, : len(r["ids"])] = r["ids"]
            plen[i] = len(r["ids"])
            temperature[i] = r["temperature"]
        t0 = time.perf_counter()
        out, n_valid = self._run(prompt, plen, temperature)
        self.stats["generate_ms"].append((time.perf_counter() - t0) * 1e3)
        self.stats["requests"] += 1
        # trim by the validity count: pad_id can be a real vocab token
        return [{"token_ids": [int(t) for t in out[i, : n_valid[i]]]}
                for i in range(n)]

    def postprocess(self, outputs, headers=None) -> Any:
        return {"predictions": outputs}
