"""BERT encoder in PyTorch: the port of ``kubeflow_tpu/models/bert.py``.

bert-base's structure (learned positions and token-type embeddings,
post-LN blocks, an exact-erf GELU intermediate, a pooler over [CLS]) with
the JAX module's parameter tree, so weights cross with
``models/bridge.py`` (:func:`~kubeflow_tpu_torch.models.bridge.
bert_params_to_state_dict`). Attention goes through the port's
:func:`~kubeflow_tpu_torch.models.transformer.dispatch_attention`,
non-causal, with the padding mask as segment ids (pads are segment 0,
valid tokens 1): ``attn_impl="flash"`` launches the flash-forward CUDA
kernel on the card, and its plain twin on the CPU.

The dtype flow is the flax one, step for step:

- a projection (:class:`BiasDense`, flax ``nn.Dense(dtype=cfg.dtype)``)
  casts input, kernel and bias to ``cfg.dtype``, rounds the product to
  it, then adds the bias in it;
- a LayerNorm (:class:`LayerNorm`, flax ``nn.LayerNorm`` has no
  ``dtype``) promotes to f32: statistics as E[x²] − E[x]² in f32, and an
  f32 output, so the residual stream after every norm is f32 even in a
  bf16 model;
- the embedding sum is ``(embed + pos) + types`` in ``cfg.dtype``;
- the MLM ``unembed`` and the classifier compute in f32.

Projection weights are stored in ``param_dtype``, by default
``cfg.dtype`` (the serving layout: the cast is deterministic, so storing
the cast weight gives the same result); training stores them in f32 and
casts weight and bias to ``cfg.dtype`` at every call, as flax does with
its f32 params. Embeddings, norm parameters and the f32 heads are f32.
The JAX config's ``interpret_kernels`` has no counterpart (a CUDA kernel
has no interpret mode).

:func:`make_mlm_loss_fn` and :func:`make_mlm_init_fn` are the MLM
training plumbing of the JAX module: 15% of the tokens, drawn by
``jax.random.bernoulli`` under the trainer's step key (the port's
threefry, bit for bit), become :data:`MASK_TOKEN`, and the loss is the
cross-entropy over the masked positions. No padding mask is passed, so
every row is one segment and the attention runs non-causal over all of
it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.models.transformer import (
    Embedding,
    TransformerConfig,
    dispatch_attention,
)
from kubeflow_tpu_torch.serve.threefry import bernoulli

BERT_ATTN_IMPLS = ("flash", "reference")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    attn_impl: str = "flash"

    def __post_init__(self):
        if self.attn_impl not in BERT_ATTN_IMPLS:
            raise ValueError(
                f"attn_impl {self.attn_impl!r} not in {BERT_ATTN_IMPLS}")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by num_heads "
                f"{self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def attention_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            d_model=self.hidden_size,
            n_heads=self.num_heads,
            d_ff=self.intermediate_size,
            causal=False,
            use_rope=False,
            dtype=self.dtype,
            attn_impl=self.attn_impl,
        )


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def bert_tiny(**overrides) -> BertConfig:
    """4-layer test-size config (fast CI / CPU runs)."""
    base = dict(
        hidden_size=128, num_layers=4, num_heads=8, intermediate_size=256,
        vocab_size=1024,
    )
    base.update(overrides)
    return BertConfig(**base)


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #

class BiasDense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)`` with its bias: weight and bias are
    stored in ``param_dtype`` (default ``dtype``) and cast to ``dtype``,
    the input is cast to it, and the product rounded to it before the
    bias is added in it."""

    def __init__(self, n_in: int, n_out: int, *, dtype: torch.dtype,
                 device: torch.device, param_dtype: torch.dtype | None = None):
        super().__init__(n_in, n_out, bias=True, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()``: f32 statistics with the fast variance
    (E[x²] − E[x]², clipped at 0), ``(x − mean) · (rsqrt(var + eps) ·
    scale) + bias``, f32 out."""

    def __init__(self, features: int, eps: float, device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


def _dense(cfg: BertConfig, n_in: int, n_out: int, device,
           param_dtype=None, dtype=None) -> BiasDense:
    """A projection computing in ``dtype`` (default ``cfg.dtype``) with
    weights stored in ``param_dtype`` (default the compute dtype)."""
    dtype = dtype or cfg.dtype
    return BiasDense(n_in, n_out, dtype=dtype, device=device,
                     param_dtype=param_dtype or dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.attn_cfg = cfg.attention_cfg()
        H = cfg.hidden_size
        self.q_proj = _dense(cfg, H, H, device, param_dtype)
        self.k_proj = _dense(cfg, H, H, device, param_dtype)
        self.v_proj = _dense(cfg, H, H, device, param_dtype)
        self.o_proj = _dense(cfg, H, H, device, param_dtype)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor):
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = self.q_proj(x).view(B, S, H, D).transpose(1, 2)
        k = self.k_proj(x).view(B, S, H, D).transpose(1, 2)
        v = self.v_proj(x).view(B, S, H, D).transpose(1, 2)
        # padding via segments: pad -> 0, valid -> 1 (pads attend only to
        # pads, and their outputs are dropped downstream)
        seg = attention_mask.to(torch.int32)
        o = dispatch_attention(q, k, v, self.attn_cfg, segment_ids=seg)
        o = o.transpose(1, 2).reshape(B, S, H * D)
        return self.o_proj(o)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device, param_dtype=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attn = BertSelfAttention(cfg, device, param_dtype)
        self.ln1 = LayerNorm(cfg.hidden_size, eps, device)
        self.up_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size,
                              device, param_dtype)
        self.down_proj = _dense(cfg, cfg.intermediate_size, cfg.hidden_size,
                                device, param_dtype)
        self.ln2 = LayerNorm(cfg.hidden_size, eps, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor):
        # post-LN, as in the original
        x = self.ln1(x + self.attn(x, attention_mask))
        # exact (erf) GELU: the tanh approximation breaks parity with
        # converted HF checkpoints
        y = self.down_proj(F.gelu(self.up_proj(x)))
        return self.ln2(x + y)


class BertEncoder(nn.Module):
    """``forward(input_ids, attention_mask=None, token_type_ids=None)`` →
    ``(sequence_output (B, S, H), pooled_output (B, H))``."""

    def __init__(self, cfg: BertConfig, device, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size, cfg.dtype, device)
        self.pos_embedding = nn.Parameter(
            torch.empty(cfg.max_position, cfg.hidden_size, device=device))
        self.type_embed = Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                    cfg.dtype, device)
        self.ln_embed = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(
            BertLayer(cfg, device, param_dtype) for _ in range(cfg.num_layers))
        self.pooler = _dense(cfg, cfg.hidden_size, cfg.hidden_size, device,
                             param_dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        B, S = input_ids.shape
        if S > cfg.max_position:
            raise ValueError(f"seq {S} exceeds max_position {cfg.max_position}")
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.int32, device=dev)
        x = self.embed(input_ids) + self.pos_embedding[None, :S].to(cfg.dtype)
        x = self.ln_embed(x + self.type_embed(token_type_ids))
        for layer in self.layers:
            x = layer(x, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForMaskedLM(nn.Module):
    """MLM logits ``(B, S, vocab)`` in f32. Parameters are allocated
    uninitialized on ``device`` (``None`` = the CUDA card): load a state
    dict or call :func:`init_bert_weights`. ``param_dtype`` stores the
    ``cfg.dtype`` projections in another dtype (f32 master weights for
    training); ``None`` stores them in ``cfg.dtype``."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        H = cfg.hidden_size
        self.encoder = BertEncoder(cfg, dev, param_dtype)
        self.mlm_transform = _dense(cfg, H, H, dev, param_dtype)
        self.mlm_ln = LayerNorm(H, cfg.layer_norm_eps, dev)
        self.unembed = _dense(cfg, H, cfg.vocab_size, dev,
                              dtype=torch.float32)

    @property
    def device(self) -> torch.device:
        return self.mlm_ln.scale.device

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.encoder(input_ids, attention_mask, token_type_ids)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq)))
        return self.unembed(h)


class BertForSequenceClassification(nn.Module):
    """Class logits ``(B, num_classes)`` in f32 from the pooled [CLS]."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, *, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.encoder = BertEncoder(cfg, dev)
        self.classifier = _dense(cfg, cfg.hidden_size, num_classes, dev,
                                 dtype=torch.float32)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        _, pooled = self.encoder(input_ids, attention_mask, token_type_ids)
        return self.classifier(pooled)


@torch.no_grad()
def init_bert_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn by a ``torch.Generator`` on the
    model's device: fan-in scaled normals for projections and embedding
    tables, N(0, 0.02) for positions, zero biases, unit norm scales (the
    flax initializers' scales; the streams differ)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        elif name.endswith("pos_embedding"):
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
    return model


# --------------------------------------------------------------------------- #
# Trainer plumbing (BASELINE config 3)
# --------------------------------------------------------------------------- #

#: conventionally [MASK]; the synthetic data only needs an id
MASK_TOKEN = 3


def make_mlm_loss_fn(mask_rate: float = 0.15):
    """``(model, {"inputs"}, key) -> (loss, {"masked_accuracy"})``: the
    JAX ``make_mlm_loss_fn``. The mask is ``bernoulli(key, mask_rate,
    (B, S))`` through the port's threefry (bit-equal to JAX's under the
    same key); masked tokens become :data:`MASK_TOKEN`; the loss is the
    f32 cross-entropy summed over masked positions over ``max(#masked,
    1)``, and the accuracy counts argmax hits (first index on ties) there
    over the same denominator."""

    def loss_fn(model: BertForMaskedLM, batch, key):
        tokens = batch["inputs"].long()
        mask = bernoulli(key, mask_rate, tuple(tokens.shape), tokens.device)
        corrupted = torch.where(mask, MASK_TOKEN, tokens)
        logits = model(corrupted)
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  tokens.reshape(-1), reduction="none")
        denom = mask.sum().clamp(min=1)
        loss = torch.where(mask.reshape(-1), per_tok, 0.0).sum() / denom
        hits = (logits.argmax(-1) == tokens) & mask
        return loss, {"masked_accuracy": hits.sum() / denom}

    return loss_fn


def make_mlm_init_fn(cfg: BertConfig):
    """``init_params(seed, device) -> BertForMaskedLM`` for the trainer:
    f32 master weights (``param_dtype=torch.float32``, compute in
    ``cfg.dtype``) drawn by :func:`init_bert_weights` from ``seed``."""

    def init_params(seed: int, device) -> BertForMaskedLM:
        model = BertForMaskedLM(cfg, device=device, param_dtype=torch.float32)
        return init_bert_weights(model, seed)

    return init_params
