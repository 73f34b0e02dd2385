"""Losses (``dusty_gan_tpu/models/losses.py``).  Only the reconstruction
loss is ported so far; the GAN losses, R1 and the path-length penalty come
with the training slice."""

from __future__ import annotations

import torch


def masked_loss(img_ref: torch.Tensor, img_gen: torch.Tensor, mask: torch.Tensor,
                distance: str = "l1") -> torch.Tensor:
    """Per-sample masked reconstruction loss, (B,): the mean of the L1 or
    squared L2 error over the pixels where ``mask`` is set."""
    if distance == "l1":
        err = (img_ref - img_gen).abs()
    elif distance == "l2":
        err = (img_ref - img_gen) ** 2
    else:
        raise NotImplementedError(distance)
    dims = tuple(range(1, img_ref.dim()))
    return (err * mask).sum(dim=dims) / mask.sum(dim=dims)
