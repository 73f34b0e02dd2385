"""DUSty maskers over a generator backbone (``dusty_gan_tpu/models/dusty.py``),
NCHW.

* ``GumbelSigmoid``: binary Gumbel-sigmoid; a learnable inverse
  temperature ``softplus(weight) + 1/tau_max`` when ``tau`` is None.
* ``DUSty1``: a per-pixel mask from a 1-channel confidence map.
* ``DUSty2``: per-pixel x per-image masks from a 2-channel map; at eval
  the image mask is ``logit > 0``.

Composite: ``depth = mask * depth + (1 - mask) * drop_const``.  Noise is
either a fixed field (``fixed_noise``, in ``noise_fields``' form) or drawn
from ``generator``.  ``compose_layer`` / ``compose_alpha`` go to the
backbone (multi-code composition, ``dcgan_eqlr.Generator``), and so do any
further keywords (the StyleGAN2 backbone's ``style`` draws and ``ws``).
``mask`` is returned as the concatenation [pixel, image] for DUSty2.

The module-level ``has_masker``, ``noise_fields``, ``generate`` and
``w_space`` are the one place outside the maskers that tells a bare
backbone from a masked generator: training, evaluation and the CLIs call
any generator through them.
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

    def draw(self, generator: Optional[torch.Generator], b: int, shape, device=None):
        """The logistic field this module consumes for a batch of ``b``
        (H, W) ``shape`` images: (b, 1, H, W) pixelwise, else (b, 1, 1, 1)."""
        return logistic_noise(generator, b, shape, self.pixelwise, self.eps, device=device)

    def forward(self, logits, threshold: float = 0.5, noise=None,
                generator: Optional[torch.Generator] = None):
        """``noise``: a fixed field; when None it is drawn from
        ``generator`` (or the default generator)."""
        if noise is None:
            b, _, h, w = logits.shape
            noise = self.draw(generator, b, (h, w), logits.device)
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

    def noise_fields(self, generator, b: int, shape, device=None):
        """The (b, 1, H, W) field ``forward`` takes as ``fixed_noise``."""
        return self.gumbel.draw(generator, b, shape, device)

    def forward(self, latent, compute_dtype=None, train: bool = True,
                threshold: float = 0.5, fixed_noise=None,
                generator: Optional[torch.Generator] = None,
                compose_layer: Optional[int] = None, compose_alpha=None, **backbone_kw):
        out = dict(self.backbone(latent, compute_dtype, compose_layer, compose_alpha,
                                 **backbone_kw))
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

    def noise_fields(self, generator, b: int, shape, device=None):
        """{"pixel": (b, 1, H, W), "image": (b, 1, 1, 1)}, drawn in that
        order, as ``forward`` takes them as ``fixed_noise``."""
        return {"pixel": self.gumbel_pixel.draw(generator, b, shape, device),
                "image": self.gumbel_image.draw(generator, b, shape, device)}

    def forward(self, latent, compute_dtype=None, train: bool = True,
                threshold: float = 0.5, fixed_noise=None,
                generator: Optional[torch.Generator] = None,
                compose_layer: Optional[int] = None, compose_alpha=None, **backbone_kw):
        """``fixed_noise``: None or {"pixel": (1|B,1,H,W), "image":
        (1|B,1,1,1)}."""
        out = dict(self.backbone(latent, compute_dtype, compose_layer, compose_alpha,
                                 **backbone_kw))
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


def has_masker(G: nn.Module) -> bool:
    """Whether ``G`` is a backbone under a DUSty masker (its output then
    holds ``depth_orig`` and ``mask``)."""
    return isinstance(G, _Masker)


def noise_fields(G: nn.Module, generator: Optional[torch.Generator], b: int, shape,
                 device=None):
    """The Gumbel noise ``G`` consumes for a batch of ``b``, in the form
    ``generate`` takes as ``noise``: None for a bare backbone."""
    return G.noise_fields(generator, b, shape, device) if has_masker(G) else None


def generate(G: nn.Module, z, compute_dtype=None, *, train: bool, threshold: float = 0.5,
             noise=None, generator: Optional[torch.Generator] = None, **backbone_kw):
    """``G``'s output dict for latents ``z``.  The masker's arguments
    (``train``, ``threshold``, ``noise`` as ``fixed_noise``, ``generator``)
    reach a masked ``G`` only; a bare backbone takes ``z``,
    ``compute_dtype`` and ``backbone_kw``.  A keyword left at None is not
    passed, so a backbone without it (DCGAN has no ``style``) accepts the
    call."""
    kw = {k: v for k, v in backbone_kw.items() if v is not None}
    if has_masker(G):
        return G(z, compute_dtype, train=train, threshold=threshold, fixed_noise=noise,
                 generator=generator, **kw)
    return G(z, compute_dtype, **kw)


def w_space(G: nn.Module) -> Optional[nn.Module]:
    """``G``'s backbone (bare or under a masker) if it has a w-space, that
    is ``num_ws`` style inputs (``models/stylegan2.py``), else None."""
    net = G.backbone if has_masker(G) else G
    return net if getattr(net, "num_ws", None) else None
