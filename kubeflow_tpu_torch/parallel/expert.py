"""Mixture of experts: the port of ``kubeflow_tpu/parallel/expert.py``.

Top-k routing builds a ``(tokens, experts, capacity)`` combine tensor,
and expert inputs and outputs are einsums against it (GShard/Switch dense
dispatch), with the Switch load-balancing loss and the router z-loss.

The JAX function runs in the global view: capacity
``max(int(cf·k·T/E), 1)`` counts the GLOBAL tokens and a token's slot in
its expert's buffer is its place in a cumulative count over all tokens in
global (batch, seq) order, choice-major. Here each rank holds a block of
rows times a sequence chunk, which is not a contiguous run of that order,
so each rank gathers every rank's per-row, per-choice expert counts over
the token axes (``Axis.TOKENS``) and builds its tokens' global offsets
from them (:func:`_positions`): the drops are the global view's. The
balance and z losses take global means by sums over the token axes
whose gradient passes through (``core/collectives.py`` ``psum``), so each
rank's backward yields its share and the trainer sums the shares.

Tokens are replicated over ``expert`` and ``model``: a rank computes its
local experts (the expert dim of the weights it holds) for every token of
its block, with the expert FFN split column/row over ``model`` when the
weights are, and one sum over those axes combines the partial outputs.
The rank's tokens fill only their own slots of each expert buffer (the
others stay 0 and come out 0), so no token moves between ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.core import collectives as coll
from kubeflow_tpu_torch.core.mesh import Axis, Mesh, current_mesh


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    expert_dim: int = 256        # per-expert FFN hidden dim
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3


def router_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def _token_group(mesh: Mesh | None) -> tuple[int, int]:
    """(ranks that split the tokens, this rank's index among them)."""
    if mesh is None:
        return 1, 0
    return mesh.size(Axis.TOKENS), mesh.index(Axis.TOKENS)


def _positions(onehot: torch.Tensor, rows: int, mesh: Mesh | None) -> torch.Tensor:
    """Each (token, choice)'s slot in its expert's buffer, in the global
    order: all of choice 0 before choice 1, tokens in (batch, seq) order.
    ``onehot`` is this rank's ``(T_local, k, E)`` block of ``rows`` rows."""
    T, k, E = onehot.shape
    oh = onehot.reshape(rows, T // rows, k, E)
    counts = oh.sum(1)                                    # (rows, k, E)
    nt, me = _token_group(mesh)
    if nt > 1:
        counts = coll._all_gather(counts, mesh, Axis.TOKENS, 0, tiled=False)
        nseq = mesh.size(Axis.SEQ)
        parts = nt // nseq
        # (parts, nseq, rows, ...) -> global (row, seq chunk) order
        counts = counts.reshape(parts, nseq, rows, k, E).transpose(1, 2)
        counts = counts.reshape(parts * rows * nseq, k, E)
        p, j = divmod(me, nseq)
        mine = (p * rows + torch.arange(rows, device=onehot.device)) * nseq + j
    else:
        mine = torch.arange(rows, device=onehot.device)
    total = counts.sum(0)                                 # (k, E)
    choice_off = torch.cumsum(total, 0) - total           # earlier choices
    before = torch.cumsum(counts, 0) - counts             # earlier chunks
    base = choice_off + before[mine]                      # (rows, k, E)
    within_chunk = torch.cumsum(oh, 1) - oh
    return (base[:, None] + within_chunk).reshape(T, k, E)


def top_k_routing(probs: torch.Tensor, k: int, capacity: int, *,
                  rows: int = 1, mesh: Mesh | None = None):
    """``(combine (T, E, C) float, dispatch (T, E, C) bool)`` for this
    rank's tokens; a token past its expert's capacity is dropped (Switch),
    the kept gates renormalized over the k choices."""
    T, E = probs.shape
    top_idx = torch.topk(probs, k, dim=-1).indices                  # (T, k)
    onehot = F.one_hot(top_idx, E).float()                          # (T, k, E)
    pos = _positions(onehot, rows, mesh)
    within = (pos < capacity) & (onehot > 0)
    gate = probs[:, None, :] * onehot
    denom = (gate * within).sum((1, 2), keepdim=True)
    gate = torch.where(within, gate, 0.0) / torch.clamp(denom, min=1e-9)
    # at most one choice of a token picks expert e, so the reference's
    # einsum over k against one-hot slots is this scatter, bit for bit
    slot = (torch.arange(E, device=probs.device) * capacity
            + pos.long().clamp(0, capacity - 1))                    # (T, k, E)
    combine = torch.zeros(T, E * capacity, dtype=gate.dtype, device=gate.device)
    combine = combine.scatter_add(1, slot.reshape(T, k * E), gate.reshape(T, k * E))
    combine = combine.reshape(T, E, capacity)
    return combine, combine > 0.0


def _global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    if mesh is None or mesh.group(Axis.TOKENS) is None:
        return x
    return coll.psum(x, Axis.TOKENS, mesh=mesh)


def load_balancing_loss(probs: torch.Tensor, dispatch: torch.Tensor, *,
                        mesh: Mesh | None = None, total_tokens=None) -> torch.Tensor:
    """Switch aux loss ``E * dot(mean router prob, mean tokens/expert)``,
    both means over the global tokens."""
    E = probs.shape[-1]
    T = probs.shape[0] if total_tokens is None else total_tokens
    density = _global_sum(dispatch.any(-1).float().sum(0), mesh) / T
    mean_prob = _global_sum(probs.sum(0), mesh) / T
    return E * torch.sum(density * mean_prob)


def moe_ffn(
    x: torch.Tensor,                 # (T_local, d_model) token activations
    router_kernel: torch.Tensor,     # (d_model, E)
    up_kernel: torch.Tensor,         # (E or E_local, d_model, expert_dim[/model])
    down_kernel: torch.Tensor,       # (E or E_local, expert_dim[/model], d_model)
    cfg: MoEConfig,
    *,
    rows: int = 1,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Dense-dispatch MoE FFN. Returns ``(out (T_local, d_model),
    aux_loss, stats)``. ``x`` holds ``rows`` rows of this rank's token
    block (row-major); under a mesh the tokens are the rank's block of the
    global batch and the expert weights its local shards."""
    mesh = current_mesh() if mesh is None else mesh
    T_local, _ = x.shape
    E = cfg.num_experts
    T = T_local * _token_group(mesh)[0]
    capacity = max(int(cfg.capacity_factor * cfg.top_k * T / E), 1)

    logits = x.float() @ router_kernel.float()
    probs = router_probs(logits)
    combine, dispatch = top_k_routing(probs, cfg.top_k, capacity,
                                      rows=rows, mesh=mesh)

    # the axes the expert weights are split over: a rank's experts (and
    # its columns of their FFN) see every token of its block
    E_local = up_kernel.shape[0]
    split = tuple(a for a, on in ((Axis.EXPERT, E_local < E),
                                  (Axis.MODEL, up_kernel.shape[2] < cfg.expert_dim))
                  if on)
    x_in, comb = x, combine
    e0 = 0
    if split:
        x_in = coll.enter(x, split, mesh=mesh)
        comb = coll.enter(combine, split, mesh=mesh)
        if E_local < E:
            e0 = mesh.index(Axis.EXPERT) * E_local
    disp = dispatch[:, e0:e0 + E_local].to(x.dtype)
    comb = comb[:, e0:e0 + E_local].to(x.dtype)
    expert_in = torch.einsum("tec,td->ecd", disp, x_in)
    h = torch.einsum("ecd,edf->ecf", expert_in, up_kernel.to(x.dtype))
    h = F.gelu(h, approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, down_kernel.to(x.dtype))
    out = torch.einsum("tec,ecd->td", comb, expert_out)
    if split:
        out = coll.psum(out, split, mesh=mesh)

    aux = cfg.aux_loss_weight * load_balancing_loss(
        probs, dispatch, mesh=mesh, total_tokens=T)
    lse = torch.logsumexp(logits, dim=-1)
    z = cfg.z_loss_weight * _global_sum((lse * lse).sum(), mesh) / T
    kept = _global_sum(dispatch.float().sum(), mesh)
    stats = {
        "moe_dropped_frac": 1.0 - kept / (cfg.top_k * T),
        "moe_aux_loss": aux,
        "moe_z_loss": z,
    }
    return out.to(x.dtype), aux + z, stats
