"""Separable [1,2,1]/4 antialias blurs (``dusty_gan_tpu/ops/blur.py``), NCHW.

``blur_v`` blurs along H with reflect padding, ``blur_h`` along W with
circular padding (reflect when ``ring=False``), and ``blur_vh``
concatenates the two on channels.  Each is three shifted slices and two
adds, the JAX package's order of operations.

``BlurVH`` is the discriminator's first layer.  It registers the
reference's two filter buffers, ``blur_v.kernel`` (1, 1, 3, 1) and
``blur_h.kernel`` (1, 1, 1, 3), so reference state dicts load strictly, and
blurs with their taps; with the [1,2,1]/4 taps (powers of two) the result
equals ``blur_vh``'s bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from dusty_gan_torch.ops.padding import pad_ring

TAPS = (0.25, 0.5, 0.25)


def _taps3(p: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """taps[0] p[i] + taps[1] p[i+1] + taps[2] p[i+2] along ``dim``."""
    n = p.shape[dim] - 2
    a, b, c = (p.narrow(dim, k, n) for k in range(3))
    return a * taps[0] + b * taps[1] + c * taps[2]


def blur_v(x: torch.Tensor, taps=TAPS) -> torch.Tensor:
    """[1,2,1]/4 along H with reflect padding."""
    return _taps3(pad_ring(x, (0, 0, 1, 1), vertical="reflect"), 2, taps)


def blur_h(x: torch.Tensor, ring: bool = True, taps=TAPS) -> torch.Tensor:
    """[1,2,1]/4 along W with circular padding (reflect when not ``ring``)."""
    mode = "circular" if ring else "reflect"
    return _taps3(pad_ring(x, (1, 1, 0, 0), horizontal=mode), 3, taps)


def blur_vh(x: torch.Tensor, ring: bool = True) -> torch.Tensor:
    """concat(vertical blur, horizontal blur) on channels."""
    return torch.cat([blur_v(x), blur_h(x, ring)], dim=1)


class _Blur(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.register_buffer("kernel", torch.tensor(TAPS).reshape(shape))

    def taps(self, dtype):
        return self.kernel.to(dtype).flatten()


class BlurVH(nn.Module):
    """``blur_vh`` with the reference's filter buffers."""

    def __init__(self, ring: bool = True):
        super().__init__()
        self.ring = ring
        self.blur_v = _Blur((1, 1, 3, 1))
        self.blur_h = _Blur((1, 1, 1, 3))

    def forward(self, x):
        return torch.cat([blur_v(x, self.blur_v.taps(x.dtype)),
                          blur_h(x, self.ring, self.blur_h.taps(x.dtype))], dim=1)
