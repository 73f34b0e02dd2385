"""Equalized-LR DCGAN generator and discriminator for LiDAR range images,
NCHW (``dusty_gan_tpu/models/dcgan_eqlr.py``).

Layout and state-dict keys follow the reference ``nn.Sequential``s.
Generator:

  0  latent projection: ConvT k(H/16, W/16) on z as (B, I, 1, 1)
     + FusedLeakyReLU                         0.0.module.weight, 0.1.bias
  1-3 Up: ring-pad 1; ConvT k4 s2 p3; FusedLeakyReLU
                                              i.1.module.weight, i.2.bias
  4  one head per output key: ring-pad 1; ConvT k4 s2 p3 with bias
                                    4.heads.<key>.1.module.{weight,bias}

``tanh`` is applied to ``depth`` only, in f32.  Each head is its own ConvT
with its own equalized-LR scale.  Stage ``i`` (0: the projection, 1-3:
up0-up2) emits ``ch(3 - i)`` channels.  ``compose_layer`` and
``compose_alpha`` blend N latents into one sample (multi-code mGANprior):
stages 0..compose_layer run on all N, the feature maps are summed as
``sum(alpha * h, dim=0, keepdim=True)``, and the rest runs on batch 1.
``compose_alpha`` is (N, C, 1, 1) in the port's NCHW layout, where the
JAX package's is (N, 1, 1, C).

Discriminator:

  0  BlurVH (the two filter buffers)      0.blur_v.kernel, 0.blur_h.kernel
  1-4 Down: ring-pad 1; conv k4 s2 VALID; FusedLeakyReLU
                                              i.1.module.weight, i.2.bias
  5  logit: conv k(H/16, W/16) with bias      5.module.{weight,bias}

Its precision boundaries are the JAX package's (``Discriminator.input_f32``):
the blur and ``1`` (down0) always run in float32, as the tanh inverse-depth
domain saturates near -1 where LiDAR range lives and a bf16 image erases
returns beyond ~106 m; ``2``-``4`` run in ``compute_dtype``; the logit conv
runs in float32 and returns float32 (B, 1, 1, 1), since a bf16 logit would
erase a far-field-only change.  On the card, float32 means TF32 off, which
``dusty_gan_torch.resolve_device`` sets.  The JAX package's hi/lo bf16
operand split of down0 is a TPU measure and is not ported: down0 is a plain
float32 conv here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from dusty_gan_torch.ops.activation import FusedLeakyReLU
from dusty_gan_torch.ops.blur import BlurVH
from dusty_gan_torch.ops.linear import (EqualLR, equal_lr_conv, equal_lr_convt,
                                        equal_lr_proj)
from dusty_gan_torch.ops.padding import RingPad


def _hpad_mode(ring: bool) -> str:
    return "circular" if ring else "reflect"


class _Block(nn.Sequential):
    """Sequential whose EqualLR members take ``compute_dtype``."""

    def forward(self, x, compute_dtype=None):
        for m in self:
            x = m(x, compute_dtype) if isinstance(m, EqualLR) else m(x)
        return x


class Heads(nn.Module):
    def __init__(self, in_ch: int, out_ch: Dict[str, int], ring: bool = True):
        super().__init__()
        self.heads = nn.ModuleDict({
            name: _Block(
                RingPad(1, _hpad_mode(ring), "reflect"),
                equal_lr_convt(in_ch, ch, 4, 2, 3, bias=True),
            )
            for name, ch in out_ch.items()
        })

    def forward(self, x, compute_dtype=None):
        return {name: head(x, compute_dtype) for name, head in self.heads.items()}


class Generator(nn.Module):
    def __init__(self, in_ch: int = 512, out_ch: Optional[Dict[str, int]] = None,
                 ch_base: int = 64, ch_max: int = 512,
                 shape: Sequence[int] = (64, 256), ring: bool = True):
        super().__init__()
        self.in_ch = int(in_ch)
        self.out_ch = dict(out_ch or {"depth": 1})
        self.shape = tuple(shape)
        self.ch_base, self.ch_max = int(ch_base), int(ch_max)
        ch = self.ch
        h0, w0 = self.shape[0] >> 4, self.shape[1] >> 4
        self.add_module("0", _Block(equal_lr_proj(self.in_ch, ch(3), (h0, w0)),
                                    FusedLeakyReLU(ch(3))))
        for idx, i in enumerate((2, 1, 0)):
            self.add_module(str(idx + 1), _Block(
                RingPad(1, _hpad_mode(ring), "reflect"),
                equal_lr_convt(ch(i + 1), ch(i), 4, 2, 3),
                FusedLeakyReLU(ch(i)),
            ))
        self.add_module("4", Heads(ch(0), self.out_ch, ring))

    def ch(self, i: int) -> int:
        return min(self.ch_base << i, self.ch_max)

    def forward(self, z, compute_dtype: Optional[torch.dtype] = None,
                compose_layer: Optional[int] = None,
                compose_alpha: Optional[torch.Tensor] = None):
        h = z[:, :, None, None]
        for i in range(4):
            h = self._modules[str(i)](h, compute_dtype)
            if compose_layer == i:
                h = torch.sum(h * compose_alpha, dim=0, keepdim=True)
        outs = self._modules["4"](h, compute_dtype)
        outs["depth"] = torch.tanh(outs["depth"].float())
        return outs


class Discriminator(nn.Module):
    def __init__(self, in_ch: int = 1, ch_base: int = 64, ch_max: int = 512,
                 shape: Sequence[int] = (64, 256), ring: bool = True):
        super().__init__()
        self.shape = tuple(shape)
        ch = lambda i: min(ch_base << i, ch_max)
        self.add_module("0", BlurVH(ring))
        in_chs = (2 * in_ch, ch(0), ch(1), ch(2))
        for i in range(4):
            self.add_module(str(i + 1), _Block(
                RingPad(1, _hpad_mode(ring), "reflect"),
                equal_lr_conv(in_chs[i], ch(i), 4, 2),
                FusedLeakyReLU(ch(i)),
            ))
        self.add_module("5", equal_lr_conv(
            ch(3), 1, (self.shape[0] >> 4, self.shape[1] >> 4), 1, bias=True))

    def forward(self, x, compute_dtype: Optional[torch.dtype] = None):
        """(B, in_ch, H, W) -> (B, 1, 1, 1) float32 logits."""
        h = self._modules["1"](self._modules["0"](x.float()))
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        for i in (2, 3, 4):
            h = self._modules[str(i)](h, compute_dtype)
        return self._modules["5"](h.float()).float()
