"""Binary Gumbel-softmax (Gumbel-sigmoid) with a straight-through hard mask
(``dusty_gan_tpu/ops/gumbel.py``), NCHW.

Noise is an argument: ``logistic_noise`` draws it from an explicit
``torch.Generator``; fixed-noise evaluation passes the same field back in.
"""

from __future__ import annotations

import torch


def logistic_noise(generator, batch: int, hw, pixelwise: bool = True,
                   eps: float = 1e-10, device=None, dtype=torch.float32):
    """The reference's logistic field ``-log(log(u1+eps)/log(u2+eps)+eps)``,
    (B, 1, H, W) pixelwise or (B, 1, 1, 1) imagewise."""
    shape = (batch, 1, hw[0], hw[1]) if pixelwise else (batch, 1, 1, 1)
    u1 = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u2 = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(torch.log(u1 + eps) / torch.log(u2 + eps) + eps)


def gumbel_sigmoid(logits, noise, tau=1.0, inverse_tau=None, hard: bool = True,
                   threshold: float = 0.5):
    """Relaxed binary sample of ``logits`` given a noise field (None = no
    noise).  The hard value is ``hard - soft.detach() + soft`` in the JAX
    package's order of operations, the straight-through form the gradient
    flows through; it is not simplified to ``hard`` even without
    gradients."""
    if noise is not None:
        logits = logits + noise.to(logits.dtype)
    if inverse_tau is not None:
        soft = torch.sigmoid(logits * inverse_tau)
    else:
        soft = torch.sigmoid(logits / tau)
    if not hard:
        return soft
    hard_mask = (soft > threshold).to(soft.dtype)
    return hard_mask - soft.detach() + soft
