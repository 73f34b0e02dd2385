"""DUSty maskers over a generator backbone (``dusty_gan_tpu/models/dusty.py``),
NCHW.

* ``GumbelSigmoid``: binary Gumbel-sigmoid; a learnable inverse
  temperature ``softplus(weight) + 1/tau_max`` when ``tau`` is None.
* ``DUSty1``: a per-pixel mask from a 1-channel confidence map.
* ``DUSty2``: per-pixel x per-image masks from a 2-channel map; at eval
  the image mask is ``logit > 0``.

Composite: ``depth = mask * depth + (1 - mask) * drop_const``.  Noise is
either a fixed field (``fixed_noise``) or drawn from ``generator``.
``compose_layer`` / ``compose_alpha`` go to the backbone (multi-code
composition, ``dcgan_eqlr.Generator``).
``mask`` is returned as the concatenation [pixel, image] for DUSty2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dusty_gan_torch.ops.gumbel import gumbel_sigmoid, logistic_noise


class GumbelSigmoid(nn.Module):
    def __init__(self, tau: Optional[float] = 1.0, tau_max: float = 1.0,
                 hard: bool = True, pixelwise: bool = True, eps: float = 1e-10):
        super().__init__()
        self.tau = tau
        self.tau_max = tau_max
        self.hard = hard
        self.pixelwise = pixelwise
        self.eps = eps
        if tau is None:
            self.weight = nn.Parameter(torch.zeros(()))

    def forward(self, logits, threshold: float = 0.5, noise=None,
                generator: Optional[torch.Generator] = None):
        """``noise``: a fixed field; when None it is drawn from
        ``generator`` (or the default generator)."""
        if noise is None:
            b, _, h, w = logits.shape
            noise = logistic_noise(generator, b, (h, w), self.pixelwise,
                                   self.eps, device=logits.device)
        inverse_tau = None
        if self.tau is None:
            inverse_tau = F.softplus(self.weight) + 1.0 / self.tau_max
        return gumbel_sigmoid(logits.float(), noise, tau=self.tau,
                              inverse_tau=inverse_tau, hard=self.hard,
                              threshold=threshold)


class _Masker(nn.Module):
    def __init__(self, backbone: nn.Module, drop_const: float = -1.0):
        super().__init__()
        self.backbone = backbone
        self.register_buffer("drop_const", torch.tensor(float(drop_const)))

    def _composite(self, out, depth, mask):
        out["depth_orig"] = depth
        out["depth"] = mask * depth + (1.0 - mask) * self.drop_const
        return out


class DUSty1(_Masker):
    """Per-pixel measurability masking (reference dusty.py:65-91)."""

    def __init__(self, backbone, tau: Optional[float] = 1.0,
                 drop_const: float = -1.0):
        super().__init__(backbone, drop_const)
        self.gumbel = GumbelSigmoid(tau=tau, hard=True, pixelwise=True)

    def forward(self, latent, compute_dtype=None, train: bool = True,
                threshold: float = 0.5, fixed_noise=None,
                generator: Optional[torch.Generator] = None,
                compose_layer: Optional[int] = None, compose_alpha=None):
        out = dict(self.backbone(latent, compute_dtype, compose_layer, compose_alpha))
        depth = out["depth"]
        mask = self.gumbel(out["confidence"].float(), threshold, fixed_noise,
                           generator)
        out["mask"] = mask
        return self._composite(out, depth, mask)


class DUSty2(_Masker):
    """Per-pixel x per-image masking (reference dusty.py:94-127)."""

    def __init__(self, backbone, tau: Optional[float] = 1.0,
                 drop_const: float = -1.0):
        super().__init__(backbone, drop_const)
        self.gumbel_pixel = GumbelSigmoid(tau=tau, hard=True, pixelwise=True)
        self.gumbel_image = GumbelSigmoid(tau=tau, hard=True, pixelwise=False)

    def forward(self, latent, compute_dtype=None, train: bool = True,
                threshold: float = 0.5, fixed_noise=None,
                generator: Optional[torch.Generator] = None,
                compose_layer: Optional[int] = None, compose_alpha=None):
        """``fixed_noise``: None or {"pixel": (1|B,1,H,W), "image":
        (1|B,1,1,1)}."""
        out = dict(self.backbone(latent, compute_dtype, compose_layer, compose_alpha))
        depth = out["depth"]
        logits = out["confidence"].float()  # (B, 2, H, W)
        fixed_noise = fixed_noise or {}
        mask_pixel = self.gumbel_pixel(logits[:, :1], threshold,
                                       fixed_noise.get("pixel"), generator)
        if train:
            mask_image = self.gumbel_image(logits[:, 1:], threshold,
                                           fixed_noise.get("image"), generator)
        else:
            mask_image = (logits[:, 1:] > 0.0).float()
        out["mask"] = torch.cat([mask_pixel, mask_image], dim=1)
        return self._composite(out, depth, mask_pixel * mask_image)
