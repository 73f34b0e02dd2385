"""Bias + LeakyReLU + gain: ``leaky_relu(x + bias, 0.2) * sqrt(2)``
(``dusty_gan_tpu/ops/activation.py``), channel axis 1."""

from __future__ import annotations

import math

import torch
from torch import nn

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     gain: float = SQRT2):
    if bias is not None:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x = x + bias.to(x.dtype).view(shape)
    # the gain is rounded to x's dtype first, as the JAX package does
    gain = float(torch.tensor(gain, dtype=x.dtype))
    return torch.where(x >= 0, x, x * negative_slope) * gain


class FusedLeakyReLU(nn.Module):
    """Learnable per-channel bias (zeros) + LeakyReLU(0.2) * sqrt(2)."""

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 gain: float = SQRT2):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.gain = gain

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.gain)
