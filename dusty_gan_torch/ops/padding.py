"""Ring padding: circular along azimuth (W), reflect/constant along rings (H).

A LiDAR range image wraps around 360 deg horizontally, so convolutions pad
W circularly and H by reflection (``dusty_gan_tpu/ops/padding.py``), here
on NCHW tensors.  W is padded first, so the H reflection also covers the
W pad columns.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

_MODES = ("circular", "reflect", "replicate", "constant")


def pad_ring(x, padding, horizontal: str = "circular",
             vertical: str = "reflect"):
    """Pad an NCHW tensor: W with ``horizontal`` mode, then H with
    ``vertical`` mode.  ``padding`` is an int (all sides) or
    (left, right, top, bottom)."""
    if isinstance(padding, int):
        left = right = top = bottom = padding
    else:
        left, right, top, bottom = padding
    for mode in (horizontal, vertical):
        if mode not in _MODES:
            raise ValueError(f"unknown pad mode: {mode}")
    if left or right:
        x = F.pad(x, (left, right, 0, 0), mode=horizontal)
    if top or bottom:
        x = F.pad(x, (0, 0, top, bottom), mode=vertical)
    return x


class RingPad(nn.Module):
    """``pad_ring`` as a parameter-free module (the reference's ``Pad``
    slot in its ``nn.Sequential`` blocks, so state-dict indices line up)."""

    def __init__(self, padding, horizontal: str = "circular",
                 vertical: str = "reflect"):
        super().__init__()
        self.padding = padding
        self.horizontal = horizontal
        self.vertical = vertical

    def forward(self, x):
        return pad_ring(x, self.padding, self.horizontal, self.vertical)
