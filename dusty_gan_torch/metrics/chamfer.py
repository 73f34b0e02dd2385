"""Chamfer distance: bidirectional nearest-neighbour squared distances
(``dusty_gan_tpu/metrics/chamfer.py``).

The nearest-neighbour searches are the CUDA kernels of ``chamfer_cuda``
(``nn_argmin``, K3, where the argmin feeds a backward; ``nn_dist``, K2,
on evaluation paths).  ``chamfer_distance`` is a ``torch.autograd.Function``
whose backward is the analytic scatter of the JAX package's ``_cd_bwd``:
``d dist1[n] / d x[n] = 2 (x[n] - y[argmin])`` with the cross terms
added into the partner cloud, so autograd never materialises the
(B, N, M) distance tensor.  On a CUDA device ``index_add_`` sums the cross
terms with atomics in no fixed order, so the gradient of a partner point
that is the nearest neighbour of several points varies by float32 rounding
from run to run.
"""

from __future__ import annotations

import torch

from dusty_gan_torch.metrics.chamfer_cuda import nn_argmin, nn_dist


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, M, 3), idx (B, N) -> (B, N, 3) points[b, idx[b, n]]."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, 3))


def _scatter_add(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor):
    """target[b, idx[b, n]] += values[b, n] for (B, M, 3), (B, N), (B, N, 3)."""
    b, m, _ = target.shape
    flat = (idx.long() + m * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    target.view(-1, 3).index_add_(0, flat, values.reshape(-1, 3))


class ChamferDistance(torch.autograd.Function):
    """(B, N, 3), (B, M, 3) -> (dist1 (B, N), dist2 (B, M))."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1 = nn_argmin(xyz1, xyz2)
        d2, i2 = nn_argmin(xyz2, xyz1)
        ctx.save_for_backward(xyz1, xyz2, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):
        xyz1, xyz2, i1, i2 = ctx.saved_tensors
        # forward-point gradients
        t1 = 2.0 * g1[..., None] * (xyz1 - _gather(xyz2, i1))  # (B, N, 3)
        t2 = 2.0 * g2[..., None] * (xyz2 - _gather(xyz1, i2))  # (B, M, 3)
        gx, gy = t1.clone(), t2.clone()
        # cross terms: each nearest neighbour receives minus its query's term
        _scatter_add(gy, i1, -t1)
        _scatter_add(gx, i2, -t2)
        return gx, gy


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """(B, N, 3), (B, M, 3) float32 -> (dist1 (B, N), dist2 (B, M)) of
    squared nearest-neighbour distances, differentiable in both clouds."""
    return ChamferDistance.apply(xyz1, xyz2)


def chamfer_distance_eval(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Forward-only Chamfer without the argmin (kernel K2 both ways); use
    ``chamfer_distance`` when gradients are needed."""
    return nn_dist(xyz1, xyz2), nn_dist(xyz2, xyz1)


def compute_cd(pcs_1: torch.Tensor, pcs_2: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer score per batch element, (B,): the mean of each
    cloud's nearest-neighbour squared distances to the other, summed.
    Evaluation only (no gradient)."""
    d1, d2 = chamfer_distance_eval(pcs_1, pcs_2)
    return d1.mean(dim=1) + d2.mean(dim=1)
