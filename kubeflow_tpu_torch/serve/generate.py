"""Token sampling: the port of ``kubeflow_tpu/serve/generate.py:sample_logits``.

The whole-batch ``make_generate_fn`` path and ``LMRuntimeModel`` are not
ported yet (ROADMAP queue 1 item 3); the engine is the serving path.
"""

from __future__ import annotations

import torch


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
    """Per-row greedy/temperature sampling over ``(B, V)`` logits.

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
