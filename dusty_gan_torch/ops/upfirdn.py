"""StyleGAN2's FIR resampling (NVlabs ``torch_utils/ops/upfirdn2d.py``),
NCHW, zero padding.

``upfirdn2d(x, f, up, down, padding, gain)``: insert ``up - 1`` zeros
after every pixel along H and W, pad by ``padding`` = (left, right, top,
bottom), correlate each channel with the 2-D filter ``outer(f, f) *
gain`` (``f`` the 1-D taps, normalised to sum 1 by ``setup_filter``), and
keep every ``down``-th pixel.  The filter is separable, and the port
applies it as two passes of shifted multiply-adds, along W then H, each
over the kept pixels only.  NVlabs' form is a depthwise conv
(``groups=C``); torch's double backward of a grouped convolution runs one
convolution a group, 512 a blur, which made a train step on the card
7.1 s, and with the channels folded into the batch (one ungrouped conv of
one channel) cuDNN took 64 s for one blur's double backward at 256 x
129 x 513 (batch 32), where the shifted adds take 121 ms (``PERF.md``).
The [1, 3, 3, 1] taps are symmetric, so correlation and convolution
agree.  The three resamplings StyleGAN2 takes from it:

* ``upsample2d``: up 2, padding (2, 1, 2, 1), gain 4: the skip image's
  2x up-sampling;
* the blur after a stride-2 transposed convolution (``ops/modulated.py``):
  padding (1, 1, 1, 1), gain 4;
* ``downsample2d``: down 2, padding (1, 1, 1, 1): the residual D's skip;
  the blur before its stride-2 3x3 convolution: padding (2, 2, 2, 2).

The filter runs in the input's dtype (bf16 inside the networks' bf16
stretches, float32 on the skip image).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

TAPS = (1.0, 3.0, 3.0, 1.0)


def setup_filter(taps: Sequence[float] = TAPS) -> Tuple[float, ...]:
    """The 1-D taps normalised to sum 1 (the 2-D filter is their outer
    product)."""
    total = float(sum(taps))
    return tuple(float(t) / total for t in taps)


def _fir1d(x: torch.Tensor, taps: Sequence[float], dim: int, down: int) -> torch.Tensor:
    """Correlation with ``taps`` along ``dim``, every ``down``-th output."""
    n = (x.shape[dim] - len(taps)) // down + 1

    def tap(k):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(k, k + down * (n - 1) + 1, down)
        return x[tuple(idx)]

    y = tap(0) * taps[0]
    for k in range(1, len(taps)):
        y = y.add(tap(k), alpha=taps[k])
    return y


def upfirdn2d(x: torch.Tensor, f: Sequence[float], up: int = 1, down: int = 1,
              padding: Sequence[int] = (0, 0, 0, 0), gain: float = 1.0) -> torch.Tensor:
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, tuple(int(p) for p in padding))
    taps = tuple(f)[::-1]  # correlation with the flipped filter: a convolution
    x = _fir1d(x, taps, 3, down)
    return _fir1d(x, tuple(t * gain for t in taps), 2, down)


def upsample2d(x: torch.Tensor, f: Sequence[float]) -> torch.Tensor:
    """2x up-sampling: (B, C, H, W) -> (B, C, 2H, 2W)."""
    return upfirdn2d(x, f, up=2, padding=(2, 1, 2, 1), gain=4.0)


def downsample2d(x: torch.Tensor, f: Sequence[float]) -> torch.Tensor:
    """2x down-sampling: (B, C, H, W) -> (B, C, H/2, W/2)."""
    return upfirdn2d(x, f, down=2, padding=(1, 1, 1, 1))
