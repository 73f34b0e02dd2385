"""Differentiable GAN augmentations (DiffAugment), NCHW
(``dusty_gan_tpu/ops/diff_augment.py``).

Brightness, saturation, contrast, translation and cutout, with the
reference's quirks kept:

* the colour factor is ``u * u * band + offset`` with u ~ U(-1, 1): the
  reference multiplies a tensor by itself after two in-place fills, so its
  Bernoulli gate is dead and the factor is u² (the JAX package's default
  ``ALIASED_FACTOR``; its unaliased variant is not ported);
* translation zero-fills vertically and wraps the width modulo **W - 1**,
  so column W - 1 is never read;
* cutout zeroes the (H/2, W/2) window clamped to the image.

Every image is augmented: the JAX ops' probability gate ``p`` is 1 in
training (the trainer never sets another value), so it is not ported.

The random draws are separate from the ops: ``draw_augment`` takes every
draw of a policy from a ``torch.Generator`` on the images' device (or a
test builds the same dict from the JAX package's keys), and
``diff_augment`` applies them.  Translation is an index gather.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEFAULT_POLICY = ("brightness", "saturation", "contrast", "translation", "cutout")


def _colour_factor(u: torch.Tensor, band: float, offset: float = 0.0) -> torch.Tensor:
    """(B,) uniform(-1, 1) draws -> (B, 1, 1, 1) factor u*u*band + offset."""
    u = u.reshape(-1, 1, 1, 1)
    return u * u * band + offset


def rand_brightness(x, u, band: float = 0.5):
    return x + _colour_factor(u, band).to(x.dtype)


def rand_saturation(x, u, band: float = 1.0):
    factor = _colour_factor(u, band, 1.0).to(x.dtype)
    x_mean = x.mean(dim=1, keepdim=True)
    return x_mean + (x - x_mean) * factor


def rand_contrast(x, u, band: float = 0.5):
    factor = _colour_factor(u, band, 1.0).to(x.dtype)
    x_mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return x_mean + (x - x_mean) * factor


def translation_shifts(h: int, w: int, ratio=(1.0 / 8.0, 1.0 / 8.0)):
    """Largest vertical and horizontal shift."""
    return int(h * ratio[0] / 2 + 0.5), int(w * ratio[1] / 2 + 0.5)


def rand_translation(x, th, tw):
    """out[i, j] = x[i + th, (j + tw) mod (W - 1)], zero where i + th leaves
    the image."""
    b, c, h, w = x.shape
    rows = torch.arange(h, device=x.device)[None, :] + th.reshape(-1, 1)  # (B, H)
    inside = (rows >= 0) & (rows < h)
    rows = rows.clamp(0, h - 1)
    y = torch.gather(x, 2, rows[:, None, :, None].expand(b, c, h, w))
    y = y * inside[:, None, :, None].to(x.dtype)
    cols = torch.remainder(torch.arange(w, device=x.device)[None, :] + tw.reshape(-1, 1),
                           w - 1)  # (B, W)
    return torch.gather(y, 3, cols[:, None, None, :].expand(b, c, h, w))


def cutout_size(h: int, w: int, ratio: float = 0.5):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_cutout(x, off_h, off_w, ratio: float = 0.5):
    """Zero the window of (cut_h, cut_w) starting at off - cut // 2,
    clamped to the image."""
    _, _, h, w = x.shape
    cut_h, cut_w = cutout_size(h, w, ratio)
    lo_h = off_h.reshape(-1, 1, 1) - cut_h // 2
    lo_w = off_w.reshape(-1, 1, 1) - cut_w // 2
    gh = torch.arange(h, device=x.device)[None, :, None]
    gw = torch.arange(w, device=x.device)[None, None, :]
    inside = (gh >= lo_h) & (gh <= lo_h + cut_h - 1) & (gw >= lo_w) & (gw <= lo_w + cut_w - 1)
    return x * (1.0 - inside[:, None].to(x.dtype))


def draw_augment(policy: Sequence[str], b: int, h: int, w: int,
                 generator: Optional[torch.Generator],
                 device) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
    """Every draw of ``policy`` for a (B, C, H, W) batch as (op, draws)
    pairs in policy order: colour ops take ``u`` (B,) ~ U(-1, 1);
    translation ``th``, ``tw`` (B,) uniform integer shifts; cutout ``off_h``
    (B,) uniform in [0, H + 1 - cut_h % 2), ``off_w`` likewise."""
    kw = dict(generator=generator, device=device)
    draws = []
    for name in policy:
        if name in ("brightness", "saturation", "contrast"):
            d = {"u": torch.rand((b,), **kw) * 2.0 - 1.0}
        elif name == "translation":
            sh, sw = translation_shifts(h, w)
            d = {"th": torch.randint(-sh, sh + 1, (b,), **kw),
                 "tw": torch.randint(-sw, sw + 1, (b,), **kw)}
        elif name == "cutout":
            cut_h, cut_w = cutout_size(h, w)
            d = {"off_h": torch.randint(0, h + (1 - cut_h % 2), (b,), **kw),
                 "off_w": torch.randint(0, w + (1 - cut_w % 2), (b,), **kw)}
        else:
            raise ValueError(f"unknown augmentation {name!r}")
        draws.append((name, d))
    return draws


def diff_augment(x: torch.Tensor,
                 draws: List[Tuple[str, Dict[str, torch.Tensor]]]) -> torch.Tensor:
    """Apply the ops of ``draws`` (``draw_augment``'s pairs) in order."""
    for name, d in draws:
        if name == "brightness":
            x = rand_brightness(x, d["u"])
        elif name == "saturation":
            x = rand_saturation(x, d["u"])
        elif name == "contrast":
            x = rand_contrast(x, d["u"])
        elif name == "translation":
            x = rand_translation(x, d["th"], d["tw"])
        elif name == "cutout":
            x = rand_cutout(x, d["off_h"], d["off_w"])
        else:
            raise ValueError(f"unknown augmentation {name!r}")
    return x
