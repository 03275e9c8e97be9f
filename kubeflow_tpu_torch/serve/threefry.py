"""Threefry-2x32 counter-based random numbers: the port's own copy of what
``jax.random`` computes for the engine's seeded sampling.

A seeded request draws the token at absolute position ``p`` from
``fold_in(PRNGKey(seed), p)`` (``kubeflow_tpu/serve/engine.py``
``_seeded_sample``), so its stream depends only on (seed, position,
logits): the same on any replica, in any batch, after any resume. This
module reproduces those draws bit for bit — the key, ``fold_in``, the
32-bit ``random_bits`` of ``jax_threefry_partitionable=True`` (JAX's
default), ``uniform`` and Gumbel-max ``categorical`` — so seeded streams
of the port and of the JAX engine are token-identical.

The engine's draws are batched: one key per row, ``(B, 2)``, with
``(B,)`` seeds and positions, on the tensors' device without a host
sync. ``make_generate_fn`` instead threads ONE key through a
generation, as the JAX function does: :func:`split` derives the next
keys on the host (a key is two words), and :func:`categorical_one_key`
draws a whole ``(B, V)`` batch from one key, its counters running flat
over ``B·V`` as ``jax.random.categorical`` partitions them.
Words are ``int64`` tensors holding unsigned 32-bit values (masked after
every add and shift), since torch's ``uint32`` lacks shifts and xors on
CUDA. Seeds are 32-bit, as the engine's int32 seed mirror holds them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds: key words ``(k1, k2)``
    encrypt counter words ``(x1, x2)``. All four broadcast against each
    other (tensors or Python ints, values in ``[0, 2**32)``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: ``(..., 2)`` words
    ``(0, seed mod 2**32)``."""
    seed = seed.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key (..., 2)`` and the
    32-bit ``data (...)`` — the cipher of counter ``(0, data)``."""
    d = data.to(torch.int64) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under partitionable
    threefry: counter ``(0, i)`` for flat index ``i``, the two output
    words xor-ed. ``key (B, 2)`` gives ``(B, n)``."""
    lo = torch.arange(n, device=key.device, dtype=torch.int64)[None, :]
    b1, b2 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` under partitionable threefry: key
    ``i`` is the cipher of counter ``(0, i)`` (so ``fold_in(key, i)``).
    ``key`` is a ``(2,)`` tensor or a pair of words; the ``(num, 2)``
    result is computed with Python integers and returned on the CPU."""
    k1, k2 = (int(w) for w in (key.tolist() if torch.is_tensor(key) else key))
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                        dtype=torch.int64)


def _to_uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """32-bit words to ``jax.random.uniform`` floats: the top 23 bits of
    each word become a mantissa in ``[1, 2)``, minus 1, scaled and
    floored at ``minval``. XLA fuses the scaling into one f32 FMA (one
    rounding); the f64 product of two f32 values is exact, so computing
    it in f64 and rounding once reproduces it."""
    bits = (bits >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(maxval) - np.float32(minval))
    lo = float(np.float32(minval))
    scaled = (floats.double() * span + lo).float()
    return torch.clamp(scaled, min=lo)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``, one
    row a key: ``key (B, 2)`` gives ``(B, n)``."""
    return _to_uniform(random_bits(key, n), minval, maxval)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of f32
    ``logits (B, V)`` by Gumbel-max (JAX's "low" mode): ``argmax(g +
    logits)`` with ``g = -log(-log(uniform(key, V, tiny, 1)))``."""
    u = uniform(key, logits.shape[-1], TINY, 1.0)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def key_of(seed: int, *data: int) -> torch.Tensor:
    """``fold_in(...fold_in(PRNGKey(seed), data[0])..., data[-1])``
    computed on the host with Python integers: a ``(2,)`` int64 CPU
    tensor, the key the JAX trainer folds a step (and a microbatch) into."""
    k = (0, seed & MASK)
    for d in data:
        k = threefry2x32(*k, 0, d & MASK)
    return torch.tensor(k, dtype=torch.int64)


def uniform_one_key(key, shape, device, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` of ONE
    key: element ``i`` in row-major order comes from counter ``(0, i)``,
    the flat index partitionable threefry gives any shape, so a 2-D draw
    is the flat draw reshaped. ``key`` is a ``(2,)`` tensor or a pair of
    words; the bits are computed on ``device``."""
    k1, k2 = (int(w) for w in (key.tolist() if torch.is_tensor(key) else key))
    n = math.prod(shape)
    lo = torch.arange(n, device=device, dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return _to_uniform(b1 ^ b2, minval, maxval).reshape(shape)


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) <
    p`` with ``p`` rounded to f32 first, as JAX casts it."""
    return uniform_one_key(key, shape, device) < float(np.float32(p))


def categorical_one_key(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` of ONE key over
    f32 ``logits (B, V)``: the Gumbel noise of element ``(b, v)`` comes
    from counter ``(0, b·V + v)`` (:func:`uniform_one_key`)."""
    u = uniform_one_key(key, logits.shape, logits.device, TINY, 1.0)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def seeded_sample(logits: torch.Tensor, seed: torch.Tensor, pos: torch.Tensor,
                  temperature: torch.Tensor, legacy: torch.Tensor) -> torch.Tensor:
    """Per-row draws of the resume contract (JAX ``_seeded_sample``): a
    row with ``seed >= 0`` takes the token at absolute position ``pos``
    from ``fold_in(PRNGKey(seed), pos)`` — argmax when its temperature is
    ``<= 0`` — and an unseeded row (``seed < 0``) keeps ``legacy``, the
    engine generator's draw. ``logits (B, V)`` f32; the others ``(B,)``."""
    key = fold_in(prng_key(seed), pos)
    drawn = categorical(key, logits / torch.clamp(temperature, min=1e-6)[:, None])
    greedy = torch.argmax(logits, dim=-1)
    seeded = torch.where(temperature <= 0.0, greedy, drawn)
    return torch.where(seed >= 0, seeded, legacy.to(seeded.dtype))
