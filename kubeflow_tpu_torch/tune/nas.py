"""Neural architecture search: DARTS and ENAS on a one-shot supernet, the
port of ``kubeflow_tpu/tune/nas.py``.

Search space: a single cell DAG of ``nodes`` intermediate nodes; every
edge (i→j) mixes the candidate ops (:data:`OPS`). The supernet runs on
NHWC images with the JAX model's layers (``models/conv.py``'s flax-shaped
``Conv``, flax's ``LayerNorm`` and ``Dense``) under flax's auto-names
(``Conv_0`` the stem, ``Conv_1``… in creation order, ``LayerNorm_k`` a
node, ``Dense_0``), so JAX weights cross with ``models/bridge.py``
:func:`~kubeflow_tpu_torch.models.bridge.supernet_params_to_state_dict`.

- :class:`DARTSSearcher`: first-order DARTS, a weight step on the train
  split and an architecture step on the val split, both ``adam`` at
  optax's defaults; ``derive()`` keeps the argmax non-zero op an edge and
  the two strongest edges a node.
- :class:`ENASSearcher`: weight sharing and REINFORCE. The controller
  (:class:`ControllerNet`) is flax's ``OptimizedLSTMCell`` (gates i, f,
  g, o in one concatenated product, zero initial carry) sampling two
  (input, op) decisions a node, invalid inputs masked. Its draws are
  ``jax.random``'s, bit for bit, through ``serve/threefry.py``
  (``split``, ``categorical``), so a seed samples the JAX searcher's
  architectures.

Weights are drawn by a ``torch.Generator`` on the CPU from ``seed`` (flax's
scales, not its streams: tests bridge JAX weights in) and then moved to
``device``, so a CPU run and a card run start from the same weights.
``device=None`` means the CUDA card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.models.bert import BiasDense, LayerNorm
from kubeflow_tpu_torch.models.conv import Conv, max_pool
from kubeflow_tpu_torch.serve import threefry
from kubeflow_tpu_torch.train.optim import adam


def _skip(x):
    return x


def _zero(x):
    return torch.zeros_like(x)


def _maxpool(x):
    return max_pool(x, 3, 1, padding="SAME")


#: candidate op name → factory ``(channels, device) -> callable``; an op
#: with weights is a ``Conv`` module, the rest are plain functions
OPS: dict[str, Callable[[int, torch.device], Callable]] = {
    "conv3": lambda ch, dev: Conv(ch, ch, 3, device=dev),
    "conv1": lambda ch, dev: Conv(ch, ch, 1, device=dev),
    "skip": lambda ch, dev: _skip,
    "maxpool": lambda ch, dev: _maxpool,
    "zero": lambda ch, dev: _zero,
}


@dataclasses.dataclass(frozen=True)
class NASSpace:
    """Cell-based space (the Katib NAS operations/graph config analog)."""

    ops: tuple[str, ...] = ("conv3", "conv1", "skip", "maxpool", "zero")
    nodes: int = 3  # intermediate nodes; node j gets edges from all i<j+1
    channels: int = 16
    num_classes: int = 10
    #: [H, W, C] of the images the searcher will see
    input_shape: tuple[int, int, int] = (8, 8, 1)

    def __post_init__(self):
        unknown = [o for o in self.ops if o not in OPS]
        if unknown:
            raise ValueError(f"unknown ops {unknown}; have {sorted(OPS)}")

    @property
    def edges(self) -> list[tuple[int, int]]:
        """(from_node, to_node); node 0 is the cell input."""
        return [(i, j) for j in range(1, self.nodes + 1) for i in range(j)]


@torch.no_grad()
def _init_weights(model: nn.Module, seed: int, device: torch.device) -> None:
    """flax's default scales from a CPU generator: LeCun normal conv and
    dense kernels, zero biases, unit norm scales, normal(0.1) embeddings,
    orthogonal recurrent kernels a gate; then copied onto ``device``."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            host = torch.ones(p.shape)
        elif leaf in ("bias", "b_h"):
            host = torch.zeros(p.shape)
        elif leaf in ("inp_embed", "op_embed", "start"):
            host = torch.randn(p.shape, generator=gen) * 0.1
        elif leaf == "w_h":
            host = torch.cat([nn.init.orthogonal_(torch.empty(p.shape[1], p.shape[1]),
                                                  generator=gen)
                              for _ in range(4)])
        else:
            host = torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5
        p.copy_(host.to(device))


class SuperNet(nn.Module):
    """One-shot model: stem → mixed-op cell → head on NHWC f32 images.
    ``forward(x (B, H, W, C), alpha (n_edges, n_ops)) -> logits``;
    ``weights_are_probs`` takes alpha rows as the mixing weights (ENAS's
    hard one-hot rows) instead of logits."""

    def __init__(self, space: NASSpace, weights_are_probs: bool = False,
                 *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.space, self.weights_are_probs = space, weights_are_probs
        sp = space
        self.Conv_0 = Conv(sp.input_shape[2], sp.channels, 3, device=dev)
        n_conv = 1
        #: (edge, op) → the op's callable, in the JAX module's call order
        self._ops: dict[tuple[int, int], Callable] = {}
        for j in range(1, sp.nodes + 1):
            for e, (_, jj) in enumerate(sp.edges):
                if jj != j:
                    continue
                for k, op_name in enumerate(sp.ops):
                    op = OPS[op_name](sp.channels, dev)
                    if isinstance(op, nn.Module):
                        self.add_module(f"Conv_{n_conv}", op)
                        n_conv += 1
                    self._ops[e, k] = op
            self.add_module(f"LayerNorm_{j - 1}", LayerNorm(sp.channels, 1e-6, dev))
        self.Dense_0 = BiasDense(sp.channels, sp.num_classes,
                                 dtype=torch.float32, device=dev)
        _init_weights(self, seed, dev)

    def forward(self, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        sp = self.space
        x = F.relu(self.Conv_0(x))
        states = [x]
        for j in range(1, sp.nodes + 1):
            acc = 0.0
            for e, (i, jj) in enumerate(sp.edges):
                if jj != j:
                    continue
                w = alpha[e] if self.weights_are_probs else torch.softmax(alpha[e], -1)
                mixed = 0.0
                for k in range(len(sp.ops)):
                    mixed = mixed + w[k] * self._ops[e, k](states[i])
                acc = acc + mixed
            norm = getattr(self, f"LayerNorm_{j - 1}")
            states.append(F.relu(norm(acc)))
        return self.Dense_0(states[-1].mean(dim=(1, 2)))


@dataclasses.dataclass
class DerivedCell:
    """Discrete architecture: chosen op per kept edge."""

    edges: list[tuple[int, int, str]]  # (from, to, op)

    def to_dict(self) -> dict:
        return {"edges": [list(e) for e in self.edges]}


def _batch(batch: Mapping[str, Any], device: torch.device):
    """(images f32, labels int64) of a numpy or tensor batch on ``device``."""
    return (torch.as_tensor(np.asarray(batch["image"], np.float32)).to(device),
            torch.as_tensor(np.asarray(batch["label"])).long().to(device))


def _adam_step(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


class DARTSSearcher:
    """First-order DARTS: alternate w-steps (train split) and alpha-steps
    (val split); ``derive`` reads off the discrete cell."""

    def __init__(
        self,
        space: NASSpace,
        *,
        w_lr: float = 1e-2,
        alpha_lr: float = 3e-3,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.space = space
        self.net = SuperNet(space, seed=seed, device=self.device)
        n_edges, n_ops = len(space.edges), len(space.ops)
        self.alpha = torch.zeros(n_edges, n_ops, device=self.device,
                                 requires_grad=True)
        self._w = list(self.net.parameters())
        self.w_opt = adam(w_lr)(self._w)
        self.a_opt = adam(alpha_lr)([self.alpha])

    def _loss(self, alpha, batch):
        x, y = batch
        return F.cross_entropy(self.net(x, alpha), y)

    def step(
        self,
        train_batch: Mapping[str, Any],
        val_batch: Mapping[str, Any],
    ) -> dict[str, float]:
        """One bilevel iteration; returns both losses."""
        w_loss = self._loss(self.alpha.detach(), _batch(train_batch, self.device))
        _adam_step(self.w_opt, self._w, torch.autograd.grad(w_loss, self._w))
        a_loss = self._loss(self.alpha, _batch(val_batch, self.device))
        _adam_step(self.a_opt, [self.alpha],
                   torch.autograd.grad(a_loss, [self.alpha]))
        return {"w_loss": w_loss.item(), "alpha_loss": a_loss.item()}

    def search(
        self,
        data: Callable[[int], tuple[Mapping[str, Any], Mapping[str, Any]]],
        steps: int,
    ) -> DerivedCell:
        for i in range(steps):
            train_batch, val_batch = data(i)
            self.step(train_batch, val_batch)
        return self.derive()

    def derive(self, keep_per_node: int = 2) -> DerivedCell:
        """Discrete cell: per edge the argmax non-zero op; per node keep the
        ``keep_per_node`` strongest incoming edges (DARTS derivation)."""
        sp = self.space
        alpha = self.alpha.detach().cpu().numpy()
        zero_idx = sp.ops.index("zero") if "zero" in sp.ops else None
        chosen: list[tuple[int, int, str, float]] = []
        for e, (i, j) in enumerate(sp.edges):
            probs = np.exp(alpha[e] - alpha[e].max())
            probs = probs / probs.sum()
            order = np.argsort(-probs)
            best = next(
                (k for k in order if zero_idx is None or k != zero_idx),
                order[0],
            )
            chosen.append((i, j, sp.ops[int(best)], float(probs[best])))
        edges: list[tuple[int, int, str]] = []
        for j in range(1, sp.nodes + 1):
            incoming = sorted(
                (c for c in chosen if c[1] == j), key=lambda c: -c[3]
            )[:keep_per_node]
            edges.extend((i, jj, op) for i, jj, op, _ in incoming)
        return DerivedCell(edges=edges)

    def alpha_entropy(self) -> float:
        """Mean per-edge entropy of the op distribution — falls as the
        search commits to an architecture."""
        with torch.no_grad():
            p = torch.softmax(self.alpha, dim=-1)
            return (-(p * torch.log(p + 1e-9)).sum(-1)).mean().item()


# --------------------------------------------------------------------------- #
# ENAS: RL-controller NAS with weight sharing
# --------------------------------------------------------------------------- #


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``w_i (4H, in)`` (no bias) and ``w_h
    (4H, H)``, ``b_h (4H,)`` hold the i, f, g, o gates' kernels in that
    order; ``(c, h) -> (c', h')``."""

    def __init__(self, n_in: int, hidden: int, device: torch.device):
        super().__init__()
        self.w_i = nn.Parameter(torch.empty(4 * hidden, n_in, device=device))
        self.w_h = nn.Parameter(torch.empty(4 * hidden, hidden, device=device))
        self.b_h = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, carry, x):
        c, h = carry
        z = F.linear(h, self.w_h, self.b_h) + F.linear(x, self.w_i)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return (c, torch.sigmoid(o) * torch.tanh(c))


class ControllerNet(nn.Module):
    """ENAS's autoregressive LSTM controller over the micro cell space.
    For each intermediate node it emits two (input-node, op) decisions,
    each conditioned on everything sampled so far through the LSTM state;
    invalid input nodes (>= current node) are masked.

    ``forward(key, greedy)`` → (inputs [nodes, 2], ops [nodes, 2] int64,
    sum-log-prob of the taken decisions, total policy entropy). ``key``
    is a ``jax.random`` key as a ``(2,)`` tensor or a pair of words; the
    draws are ``jax.random.categorical``'s."""

    def __init__(self, space: NASSpace, hidden: int = 64, *, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.space, self.hidden = space, hidden
        n_in = space.nodes + 1  # candidate input nodes (0 = cell input)
        self.OptimizedLSTMCell_0 = LSTMCell(hidden, hidden, dev)
        self.inp_embed = nn.Parameter(torch.empty(n_in, hidden, device=dev))
        self.op_embed = nn.Parameter(torch.empty(len(space.ops), hidden, device=dev))
        self.start = nn.Parameter(torch.empty(hidden, device=dev))
        self.head_input = BiasDense(hidden, n_in, dtype=torch.float32, device=dev)
        self.head_op = BiasDense(hidden, len(space.ops), dtype=torch.float32,
                                 device=dev)
        #: masks of the input head, one a node: 0 for inputs < j, -1e9 else
        self.register_buffer("_masks", torch.tensor(
            [[0.0 if i < j else -1e9 for i in range(n_in)]
             for j in range(1, space.nodes + 1)], device=dev), persistent=False)
        _init_weights(self, seed, dev)

    def forward(self, key, greedy: bool = False):
        sp = self.space
        cell = self.OptimizedLSTMCell_0
        zero = self.start.new_zeros(1, self.hidden)
        carry = (zero, zero)
        rng = key

        def pick(rng, logits):
            p = torch.log_softmax(logits, -1)
            if greedy:
                choice = torch.argmax(logits)
            else:
                choice = threefry.categorical_one_key(rng, logits[None])[0]
            return choice, p[choice], -(torch.exp(p) * p).sum()

        x = self.start[None]
        inputs, ops = [], []
        logp = entropy = 0.0
        for j in range(1, sp.nodes + 1):
            for _slot in range(2):
                carry = cell(carry, x)
                rng, k = threefry.split(rng)
                i, lp, ent = pick(k, self.head_input(carry[1])[0] + self._masks[j - 1])
                logp, entropy = logp + lp, entropy + ent
                x = self.inp_embed[i][None]
                carry = cell(carry, x)
                rng, k = threefry.split(rng)
                o, lp, ent = pick(k, self.head_op(carry[1])[0])
                logp, entropy = logp + lp, entropy + ent
                x = self.op_embed[o][None]
                inputs.append(i)
                ops.append(o)
        shape = (sp.nodes, 2)
        return (torch.stack(inputs).reshape(shape), torch.stack(ops).reshape(shape),
                logp, entropy)


class ENASSearcher:
    """ENAS (Pham et al.): weight sharing + REINFORCE.

    Each :meth:`step` (1) trains the SHARED supernet weights on the train
    split through one controller-sampled path (hard one-hot edge weights);
    (2) updates the controller by REINFORCE on the sampled path's
    validation accuracy against a moving-average baseline, with an
    entropy bonus. ``derive()`` is the greedy controller rollout.
    """

    def __init__(
        self,
        space: NASSpace,
        *,
        w_lr: float = 1e-2,
        ctrl_lr: float = 3e-3,
        entropy_coef: float = 1e-3,
        baseline_decay: float = 0.8,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.space = space
        self.net = SuperNet(space, weights_are_probs=True, seed=seed,
                            device=self.device)
        self.controller = ControllerNet(space, seed=seed + 1, device=self.device)
        # the JAX searcher splits PRNGKey(seed) into (net init, controller
        # init, sampling); the port keeps the third for its draws
        self._rng = threefry.split((0, seed & threefry.MASK), 3)[2]
        self._w = list(self.net.parameters())
        self._c = list(self.controller.parameters())
        self.w_opt = adam(w_lr)(self._w)
        self.c_opt = adam(ctrl_lr)(self._c)
        self.entropy_coef = entropy_coef
        self.baseline_decay = baseline_decay
        self.baseline = 0.0
        #: edge index lookup: (from, to) → position in space.edges
        self._edge_idx = {e: n for n, e in enumerate(space.edges)}
        #: the (inputs, ops) each step sampled for its weight and its
        #: controller update, as nested lists
        self.sampled: list[dict[str, Any]] = []

    def arch_weights(self, inputs: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
        """Sampled decisions → hard [n_edges, n_ops] mixing weights.
        Unselected edges are all-zero rows; a node picking the same input
        and op twice keeps weight 1 (max, not sum)."""
        sp = self.space
        n = sp.nodes
        # edge of (input i, node j): node j's edges start at j(j-1)/2
        first = torch.tensor([j * (j - 1) // 2 for j in range(1, n + 1)],
                             device=inputs.device)
        edge = (first[:, None] + inputs).reshape(-1)
        A = torch.zeros(len(sp.edges), len(sp.ops), device=inputs.device)
        return A.index_put((edge, ops.reshape(-1)),
                           torch.ones_like(edge, dtype=A.dtype))

    def step(
        self,
        train_batch: Mapping[str, Any],
        val_batch: Mapping[str, Any],
    ) -> dict[str, float]:
        """One ENAS iteration: shared-weight step on a sampled path, then
        a REINFORCE controller step on validation reward."""
        self._rng, k1, k2 = threefry.split(self._rng, 3)
        x, y = _batch(train_batch, self.device)
        with torch.no_grad():
            w_in, w_ops, _, _ = self.controller(k1)
        w_loss = F.cross_entropy(self.net(x, self.arch_weights(w_in, w_ops)), y)
        _adam_step(self.w_opt, self._w, torch.autograd.grad(w_loss, self._w))

        x, y = _batch(val_batch, self.device)
        c_in, c_ops, logp, entropy = self.controller(k2)
        with torch.no_grad():
            logits = self.net(x, self.arch_weights(c_in, c_ops))
            reward = (torch.argmax(logits, -1) == y).float().mean()
        c_loss = -(reward - self.baseline) * logp - self.entropy_coef * entropy
        _adam_step(self.c_opt, self._c, torch.autograd.grad(c_loss, self._c))
        reward = reward.item()
        d = self.baseline_decay
        self.baseline = d * self.baseline + (1 - d) * reward
        self.sampled.append({"w": [w_in.tolist(), w_ops.tolist()],
                             "ctrl": [c_in.tolist(), c_ops.tolist()]})
        return {
            "w_loss": w_loss.item(),
            "ctrl_loss": c_loss.item(),
            "reward": reward,
            "baseline": self.baseline,
        }

    def search(
        self,
        data: Callable[[int], tuple[Mapping[str, Any], Mapping[str, Any]]],
        steps: int,
    ) -> DerivedCell:
        for i in range(steps):
            train_batch, val_batch = data(i)
            self.step(train_batch, val_batch)
        return self.derive()

    def derive(self) -> DerivedCell:
        """Greedy (argmax) controller rollout → discrete cell, same
        DerivedCell shape the DARTS searcher emits."""
        with torch.no_grad():
            inputs, ops, _, _ = self.controller((0, 0), greedy=True)
        inputs, ops = inputs.cpu().numpy(), ops.cpu().numpy()
        edges: list[tuple[int, int, str]] = []
        for j in range(1, self.space.nodes + 1):
            seen: set[tuple[int, str]] = set()
            for slot in range(2):
                i = int(inputs[j - 1, slot])
                op = self.space.ops[int(ops[j - 1, slot])]
                # same input with DIFFERENT ops is a real architecture the
                # reward was measured on (the edge computes op_a + op_b) —
                # keep both; only an exact duplicate collapses
                if (i, op) in seen:
                    continue
                seen.add((i, op))
                edges.append((i, j, op))
        return DerivedCell(edges=edges)


__all__ = ["OPS", "NASSpace", "SuperNet", "DerivedCell", "DARTSSearcher",
           "ControllerNet", "ENASSearcher"]
