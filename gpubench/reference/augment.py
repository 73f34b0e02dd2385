"""DiffAugment (Zhao et al., 2020) as the published DUSty code applies it,
given its random draws, NCHW.

* brightness: ``x + u*u*0.5``; saturation: ``mean_c + (x - mean_c) *
  (u*u + 1)``; contrast: ``mean + (x - mean) * (u*u*0.5 + 1)``, u ~ U(-1, 1)
  per image (the published code squares u: it fills one tensor twice and
  multiplies it by itself);
* translation by (th, tw): out[i, j] = x[i + th, (j + tw) mod (W - 1)],
  zero where i + th leaves the image (the published code wraps modulo
  W - 1);
* cutout: zero the (round(H/2), round(W/2)) window starting at
  ``off - size // 2``, clamped to the image.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Ops = List[Tuple[str, Dict[str, torch.Tensor]]]


def _factor(u: torch.Tensor, band: float, offset: float) -> torch.Tensor:
    return (u * u * band + offset).view(-1, 1, 1, 1)


def translate(x: torch.Tensor, th: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    i = torch.arange(h, device=x.device).view(1, h) + th.view(-1, 1)  # (B, H)
    keep = ((i >= 0) & (i < h)).to(x.dtype).view(b, 1, h, 1)
    i = i.clamp(0, h - 1).view(b, 1, h, 1).expand(b, c, h, w)
    y = torch.gather(x, 2, i) * keep
    j = (torch.arange(w, device=x.device).view(1, w) + tw.view(-1, 1)) % (w - 1)
    return torch.gather(y, 3, j.view(b, 1, 1, w).expand(b, c, h, w))


def cutout(x: torch.Tensor, off_h: torch.Tensor, off_w: torch.Tensor) -> torch.Tensor:
    _, _, h, w = x.shape
    sh, sw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
    top = (off_h - sh // 2).view(-1, 1, 1)
    left = (off_w - sw // 2).view(-1, 1, 1)
    rows = torch.arange(h, device=x.device).view(1, h, 1)
    cols = torch.arange(w, device=x.device).view(1, 1, w)
    cut = (rows >= top) & (rows < top + sh) & (cols >= left) & (cols < left + sw)
    return x * (~cut).to(x.dtype).unsqueeze(1)


def augment(x: torch.Tensor, ops: Ops) -> torch.Tensor:
    for name, d in ops:
        if name == "brightness":
            x = x + _factor(d["u"], 0.5, 0.0)
        elif name == "saturation":
            m = x.mean(dim=1, keepdim=True)
            x = m + (x - m) * _factor(d["u"], 1.0, 1.0)
        elif name == "contrast":
            m = x.mean(dim=(1, 2, 3), keepdim=True)
            x = m + (x - m) * _factor(d["u"], 0.5, 1.0)
        elif name == "translation":
            x = translate(x, d["th"], d["tw"])
        elif name == "cutout":
            x = cutout(x, d["off_h"], d["off_w"])
        else:
            raise ValueError(f"unknown augmentation {name!r}")
    return x
