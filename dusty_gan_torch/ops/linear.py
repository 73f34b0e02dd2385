"""Equalized-learning-rate convolutions (ProGAN).

Weights are N(0, 1) and scaled at run time by ``gain / sqrt(fan_in)``
with ``fan_in = weight[0].numel()`` in the torch layout
(``dusty_gan_tpu/ops/linear.py``):

* ``nn.Conv2d`` weight (O, I, kh, kw): ``fan_in = I*kh*kw``, the true fan-in
  (the discriminator);
* ``nn.ConvTranspose2d`` weight (I, O, kh, kw): ``fan_in = O*kh*kw``, the
  reference's ConvT fan-in quirk, kept (the generator).

``EqualLR`` wraps the conv as ``.module`` so the state-dict keys are the
reference's ``<...>.module.weight`` / ``.module.bias``.  The forward runs a
plain ``F.conv2d`` / ``F.conv_transpose2d`` in ``compute_dtype`` (None = the
input's dtype); a bias is added after the conv in the output dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class EqualLR(nn.Module):
    """Runtime-scaled ``nn.Conv2d`` or ``nn.ConvTranspose2d``."""

    def __init__(self, module, gain: float = 1.0):
        super().__init__()
        if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            raise TypeError("EqualLR wraps nn.Conv2d or nn.ConvTranspose2d, "
                            f"got {type(module)}")
        self.module = module
        nn.init.normal_(module.weight)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
        self.scale = gain / math.sqrt(module.weight[0].numel())

    def forward(self, x, compute_dtype=None):
        m = self.module
        dtype = compute_dtype or x.dtype
        w = (m.weight * self.scale).to(dtype)
        if isinstance(m, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x.to(dtype), w, None, m.stride, m.padding)
        else:
            y = F.conv2d(x.to(dtype), w, None, m.stride, m.padding)
        if m.bias is not None:
            y = y + m.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


def equal_lr_convt(in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                   bias: bool = False) -> EqualLR:
    return EqualLR(nn.ConvTranspose2d(in_ch, out_ch, kernel, stride, padding,
                                      bias=bias))


def equal_lr_conv(in_ch: int, out_ch: int, kernel, stride=1,
                  bias: bool = False) -> EqualLR:
    """VALID conv (padding is the caller's ring pad)."""
    return EqualLR(nn.Conv2d(in_ch, out_ch, kernel, stride, 0, bias=bias))


def equal_lr_proj(in_ch: int, out_ch: int, shape=(4, 16)) -> EqualLR:
    """Latent projection (``dcgan_eqlr.py:6-16``): a ConvT with kernel
    (H0, W0), stride 1, padding 0, applied to z as a (B, I, 1, 1) map."""
    return equal_lr_convt(in_ch, out_ch, tuple(shape))
