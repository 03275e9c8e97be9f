"""flax's image layers on NHWC tensors, for the port's CNNs
(``models/mnist_cnn.py``, ``models/resnet.py``).

The JAX models are NHWC with flax defaults that torch's layers do not
share; each is spelled out here:

- :class:`Conv` is ``nn.Conv(features, (k, k), strides, use_bias, dtype)``:
  ``SAME`` padding by default, which pads ``max((ceil(n/s) - 1)·s + k -
  n, 0)`` split low ``⌊·/2⌋``, high the rest, so a 3×3 stride-2 conv on
  an even size pads (0, 1), not torch's symmetric (1, 1). Input, kernel
  and bias are cast to ``dtype`` and the bias is added after the product
  in it; the weights stay f32 (``param_dtype``), torch's ``(out, in, kh,
  kw)`` layout where flax has ``(kh, kw, in, out)``.
- :func:`max_pool` is ``nn.max_pool``: ``VALID`` by default, ``SAME``
  pads with -inf.
- :class:`GroupNorm` is ``nn.GroupNorm(num_groups)``: statistics over
  (H, W, the group's channels) in f32 by the fast variance (E[x²] −
  E[x]², clipped at 0), ε = 1e-6 (torch's default is 1e-5), ``(x −
  mean) · (rsqrt(var + ε) · scale) + bias``, f32 out.

The convolution runs on an NCHW view of the NHWC tensor, which torch
reads as channels-last without a copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """``(low, high)`` padding of one spatial dim under ``SAME``."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_hw(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """``SAME`` padding of an NCHW view's H and W."""
    (ht, hb), (wl, wr) = (same_pads(n, k, s) for n in x.shape[2:])
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: square ``kernel``, ``strides``, ``SAME``
    padding, compute in ``dtype`` over f32 weights."""

    def __init__(self, c_in: int, c_out: int, kernel: int, *, strides: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(_pad_hw(x.to(dt).permute(0, 3, 1, 2), self.kernel,
                             self.strides),
                     self.weight.to(dt), stride=self.strides)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def max_pool(x: torch.Tensor, window: int, strides: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` of an NHWC tensor with a square window."""
    y = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        y = _pad_hw(y, window, strides, value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    return F.max_pool2d(y, window, strides).permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over the last (channel) axis of
    an NHWC tensor."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(
                f"Number of groups ({num_groups}) does not divide the number "
                f"of channels ({channels}).")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, *hw, C = x.shape
        G = self.num_groups
        xf = x.float()
        g = xf.reshape(B, -1, G, C // G)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(B, *hw, C)
