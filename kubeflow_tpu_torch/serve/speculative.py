"""Speculative decoding: prompt-lookup drafting and the verify rule — the
port of ``kubeflow_tpu/serve/speculative.py``.

The drafter matches each row's last ``ngram`` tokens against the row's
own history (prompt plus everything generated) and proposes the
continuation of a match; one (K+1)-position verify forward then scores
the carry token plus K drafts, and the longest agreeing prefix is
emitted with the bonus token from the first rejected position — up to
K+1 tokens for one forward.

Both functions are tensor ops over static shapes with no host sync, so
they run inside the engine's decode chunk on the card. Greedy
verification accepts a draft iff it is the argmax, which makes greedy
speculative streams identical to plain decoding. Temperature rows use
the distribution-preserving rejection rule for a point-mass proposal;
their accept and resample noise comes from the engine's
``torch.Generator``, so those streams match the JAX engine in
distribution only.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.serve.generate import gumbel_argmax


def propose_draft(hist: torch.Tensor, hist_len: torch.Tensor, *, ngram: int,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row prompt-lookup draft from the row's own token history.

    ``hist (B, H)`` holds each row's tokens at positions ``[0,
    hist_len)``; entries past ``hist_len (B,)`` are stale and never
    consulted. Returns ``(draft (B, k), draft_len (B,))``. A row matches
    its last ``ngram`` tokens against every earlier window ending before
    them and takes the continuation of the most recent match that has
    ``k`` tokens inside history, else of the most recent match; rows
    without ``ngram + 1`` tokens or without a match draft 0 tokens.
    """
    B, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)
    # the matching context: the last ngram tokens (clipped reads are junk
    # when hist_len < ngram, and gated below)
    cidx = (hist_len - ngram)[:, None] + torch.arange(ngram, device=dev)[None, :]
    ctx = torch.gather(hist, 1, cidx.clamp(0, H - 1))
    m = torch.ones((B, H), dtype=torch.bool, device=dev)
    for i in range(ngram):
        m &= torch.roll(hist, -i, dims=1) == ctx[:, i:i + 1]
    # a window must end before the context itself (no self-match) and
    # leave at least one continuation token; rolled wrap-around entries
    # fail the same bound
    valid = m & (pos[None, :] + ngram < hist_len[:, None])
    full = valid & (pos[None, :] + ngram + k <= hist_len[:, None])
    p_full = torch.where(full, pos[None, :], -1).amax(dim=1)
    p_any = torch.where(valid, pos[None, :], -1).amax(dim=1)
    p_star = torch.where(p_full >= 0, p_full, p_any)
    has = (p_star >= 0) & (hist_len >= ngram + 1)
    src = p_star + ngram
    idx = (src[:, None] + torch.arange(k, device=dev)[None, :]).clamp(0, H - 1)
    draft = torch.gather(hist, 1, idx)
    avail = (hist_len - src).clamp(0, k)
    return draft, torch.where(has, avail, 0)


def spec_accept(logits: torch.Tensor, draft: torch.Tensor,
                draft_len: torch.Tensor, generator: torch.Generator,
                temperature: torch.Tensor):
    """Accept the longest agreeing draft prefix plus the bonus token.

    ``logits (B, K+1, V)``: position i scored the prefix extended by
    drafts ``0..i-1``. ``draft (B, K)``, ``draft_len (B,)``,
    ``temperature (B,)`` (``<= 0`` is greedy). Greedy rows accept
    ``draft[i]`` iff it is ``argmax(logits[:, i])``; temperature rows
    accept with probability ``p_i(draft[i])`` and on rejection resample
    from ``p`` without the rejected token's mass. Returns ``(emitted (B,
    K+1), n_emit (B,), n_acc (B,))``: positions below ``n_emit = n_acc +
    1`` are real. EOS and budget gating are the caller's.
    """
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    greedy_t = torch.argmax(logits, dim=-1)                         # (B, K+1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None, None]
    probs = torch.softmax(scaled, dim=-1)
    is_greedy = temperature <= 0.0
    u = torch.rand((B, K), generator=generator, device=dev)
    p_draft = torch.gather(probs[:, :K], 2, draft[..., None])[..., 0]
    acc = torch.where(is_greedy[:, None], draft == greedy_t[:, :K], u < p_draft)
    acc &= torch.arange(K, device=dev)[None, :] < draft_len[:, None]
    # longest agreeing prefix: one disagreement poisons the tail
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    p_b = torch.gather(probs, 1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
    greedy_b = torch.gather(greedy_t, 1, n_acc[:, None])[:, 0]
    rejected = n_acc < draft_len
    d_rej = torch.gather(draft, 1, n_acc.clamp(max=K - 1)[:, None])
    # the residual: the rejected token's mass removed, renormalized (all
    # mass on the draft cannot happen for a real rejection; keep p then)
    resid = p_b.scatter(1, d_rej, 0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    safe = norm > 0
    resid = torch.where(safe, resid / torch.where(safe, norm, 1.0), p_b)
    p_bonus = torch.where(rejected[:, None], resid, p_b)
    drawn = gumbel_argmax(torch.log(p_bonus.clamp_min(1e-30)), generator)
    bonus = torch.where(is_greedy, greedy_b, drawn)
    i = torch.arange(K1, device=dev)[None, :]
    full = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    emitted = torch.where(
        i < n_acc[:, None], full,
        torch.where(i == n_acc[:, None], bonus[:, None], 0),
    )
    return emitted, n_acc + 1, n_acc
