"""Masked depth error and accuracy metrics for reconstruction evaluation
(``dusty_gan_tpu/metrics/depth.py``): abs_rel, sq_rel, rmse, rmse_log and
the delta < 1.25^k accuracies, per sample over the masked pixels.  Images
are (B, H, W, 1)."""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, x.dim()))
    return (x * mask).sum(dim=dims) / mask.sum(dim=dims)


def compute_depth_error(depth_ref, depth_gen, mask=None):
    if mask is None:
        mask = torch.ones_like(depth_ref)
    diff = depth_ref - depth_gen
    return {
        "abs_rel": _masked_mean(diff.abs() / depth_ref, mask),
        "sq_rel": _masked_mean(diff ** 2 / depth_ref, mask),
        "rmse": torch.sqrt(_masked_mean(diff ** 2, mask)),
        "rmse_log": torch.sqrt(_masked_mean(
            (torch.log(depth_ref) - torch.log(depth_gen)) ** 2, mask)),
    }


def compute_depth_accuracy(depth_ref, depth_gen, mask=None):
    if mask is None:
        mask = torch.ones_like(depth_ref)
    delta = torch.maximum(depth_ref / depth_gen, depth_gen / depth_ref)
    return {f"accuracy_{k}": _masked_mean((delta < 1.25 ** k).to(depth_ref.dtype), mask)
            for k in (1, 2, 3)}
