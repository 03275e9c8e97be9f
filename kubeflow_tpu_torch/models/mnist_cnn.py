"""MNIST CNN in PyTorch: the port of ``kubeflow_tpu/models/mnist_cnn.py``
(BASELINE config 1).

Two 3×3 conv blocks (32 and 64 channels, ReLU, 2×2 max pool) and two
dense layers (128, then the classes in f32), on NHWC input as the JAX
model takes it. The feature map is flattened in (H, W, C) order, as
flax reshapes an NHWC tensor, so ``Dense_0``'s rows line up with the JAX
kernel's. Submodule names are flax's auto-names (``Conv_0``, ``Conv_1``,
``Dense_0``, ``Dense_1``), so weights cross with
``models/bridge.py`` :func:`~kubeflow_tpu_torch.models.bridge.
cnn_params_to_state_dict`. No layer reaches a kernel of the port:
convolutions and products are torch ops, as they are XLA ops in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import resolve_device
from kubeflow_tpu_torch.models.bert import BiasDense
from kubeflow_tpu_torch.models.conv import Conv, max_pool


class MnistCNN(nn.Module):
    """``forward(images (B, 28, 28, 1)) -> logits (B, num_classes)`` f32.
    Weights are f32, computed in ``dtype``, allocated uninitialized on
    ``device`` (``None`` = the CUDA card): load a state dict or call
    :func:`init_cnn_weights`."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 *, image_shape=(28, 28, 1), device=None):
        super().__init__()
        dev = resolve_device(device)
        H, W, C = image_shape
        self.dtype = dtype
        self.Conv_0 = Conv(C, 32, 3, dtype=dtype, device=dev)
        self.Conv_1 = Conv(32, 64, 3, dtype=dtype, device=dev)
        flat = (H // 4) * (W // 4) * 64
        self.Dense_0 = BiasDense(flat, 128, dtype=dtype, device=dev,
                                 param_dtype=torch.float32)
        self.Dense_1 = BiasDense(128, num_classes, dtype=torch.float32,
                                 device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(F.relu(self.Conv_0(x.to(self.dtype))), 2, 2)
        x = max_pool(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)


@torch.no_grad()
def init_cnn_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn by a ``torch.Generator`` on the
    model's device: flax's default scales (LeCun normal, variance 1/fan-in,
    for conv and dense kernels; zero biases; unit GroupNorm scales). The
    streams differ from JAX's, so tests bridge JAX weights in."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
    return model


def make_init_fn(num_classes: int = 10, dtype: torch.dtype = torch.float32):
    """``init_params(seed, device) -> MnistCNN`` for the trainer (f32
    weights from :func:`init_cnn_weights`)."""

    def init_params(seed: int, device) -> MnistCNN:
        model = MnistCNN(num_classes, dtype, device=device)
        return init_cnn_weights(model, seed)

    return init_params


def make_loss_fn():
    """``(model, (images, labels), key) -> (loss, {"accuracy"})``: the mean
    cross-entropy of the f32 logits and the argmax accuracy (the JAX
    ``make_loss_fn``, shared by the MNIST CNN and ResNet)."""

    def loss_fn(model: nn.Module, batch, key=None):
        del key  # the model draws nothing
        images, labels = batch
        labels = labels.long()
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn
