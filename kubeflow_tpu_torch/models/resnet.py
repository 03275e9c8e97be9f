"""ResNet (v1.5, bottleneck blocks, GroupNorm) in PyTorch: the port of
``kubeflow_tpu/models/resnet.py`` (BASELINE config 2, ResNet-50 on
CIFAR-10).

The JAX model's layout and numerics: NHWC input, a 3×3 stride-1 stem for
32×32 images (or 7×7 stride 2 and a 3×3 ``SAME`` max pool), GroupNorm
after every conv (``min(groups, channels)`` groups, flax's ε = 1e-6 and
f32 statistics), stride 2 on the 3×3 conv of each stage's first block
with flax's ``SAME`` padding ((0, 1) on an even size), a projection
(1×1 conv and GroupNorm) where the shape changes, and a mean over H and
W before the f32 head. Layers are ``models/conv.py``'s; submodule names
are the JAX module's (``stem``, ``gn_stem``, ``stage{s}_block{b}``'s
``conv1``…``gn_proj``, ``head``), so weights cross with
``models/bridge.py`` :func:`~kubeflow_tpu_torch.models.bridge.
cnn_params_to_state_dict`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.models.bert import BiasDense
from kubeflow_tpu_torch.models.conv import Conv, GroupNorm, max_pool
from kubeflow_tpu_torch.models.mnist_cnn import init_cnn_weights, make_loss_fn

__all__ = ["ResNetConfig", "ResNet", "resnet50_cifar", "resnet18_cifar",
           "make_init_fn", "make_loss_fn"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    num_filters: int = 64
    num_classes: int = 10
    #: 3×3 stride-1 stem for 32×32 inputs (else 7×7 stride 2 and a max pool)
    cifar_stem: bool = True
    #: GroupNorm groups
    groups: int = 32
    dtype: torch.dtype = torch.float32


def resnet50_cifar(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def resnet18_cifar(**kw) -> ResNetConfig:
    base = dict(stage_sizes=(2, 2, 2, 2))
    base.update(kw)
    return ResNetConfig(**base)


class BottleneckBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, strides: int, cfg: ResNetConfig,
                 device):
        super().__init__()
        conv = lambda i, o, k, s=1: Conv(  # noqa: E731
            i, o, k, strides=s, use_bias=False, dtype=cfg.dtype, device=device)
        norm = lambda c: GroupNorm(min(cfg.groups, c), c, device=device)  # noqa: E731
        out = filters * 4
        self.conv1, self.gn1 = conv(c_in, filters, 1), norm(filters)
        self.conv2, self.gn2 = conv(filters, filters, 3, strides), norm(filters)
        self.conv3 = conv(filters, out, 1)
        # flax takes min(groups, filters * 4) for the block's last norms
        self.gn3 = GroupNorm(min(cfg.groups, out), out, device=device)
        if c_in != out or strides != 1:
            self.proj = conv(c_in, out, 1, strides)
            self.gn_proj = GroupNorm(min(cfg.groups, out), out, device=device)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        residual = x if self.proj is None else self.gn_proj(self.proj(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(images (B, H, W, 3)) -> logits (B, num_classes)`` f32.
    Weights are f32, computed in ``cfg.dtype``, allocated uninitialized
    on ``device`` (``None`` = the CUDA card): load a state dict or call
    :func:`~kubeflow_tpu_torch.models.mnist_cnn.init_cnn_weights`."""

    def __init__(self, cfg: ResNetConfig, *, in_channels: int = 3, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        F0 = cfg.num_filters
        self.stem = Conv(in_channels, F0, 3 if cfg.cifar_stem else 7,
                         strides=1 if cfg.cifar_stem else 2, use_bias=False,
                         dtype=cfg.dtype, device=dev)
        self.gn_stem = GroupNorm(cfg.groups, F0, device=dev)
        c_in = F0
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            for block in range(num_blocks):
                filters = F0 * 2**stage
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}", BottleneckBlock(
                    c_in, filters, strides, cfg, dev))
                c_in = filters * 4
        self.head = BiasDense(c_in, cfg.num_classes, dtype=torch.float32,
                              device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.stem(x.to(cfg.dtype))
        if not cfg.cifar_stem:
            x = max_pool(x, 3, 2, "SAME")
        x = F.relu(self.gn_stem(x))
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            for block in range(num_blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        return self.head(x.mean(dim=(1, 2)))


def make_init_fn(cfg: ResNetConfig):
    """``init_params(seed, device) -> ResNet`` for the trainer (f32
    weights from :func:`~kubeflow_tpu_torch.models.mnist_cnn.
    init_cnn_weights`)."""

    def init_params(seed: int, device) -> ResNet:
        return init_cnn_weights(ResNet(cfg, device=device), seed)

    return init_params
