"""Approximate earth mover's distance by the annealed auction
(``dusty_gan_tpu/metrics/emd.py``).

``earth_mover_distance`` is a ``torch.autograd.Function``: its forward runs
``emd_pair`` (kernel K5 on a CUDA device, the dense plain version on the
CPU), which returns the auction's residues R, C, V and U besides the cost;
the match is held constant, as in the reference backward, so the gradients
are elementwise in them, ``2 g (R x - V)`` and ``2 g (C y - U)``, and the
(B, N, M) match never reaches autograd.  ``earth_mover_distance_dense`` is
the dense path through autograd with the match detached.
"""

from __future__ import annotations

import torch

from dusty_gan_torch.metrics.emd_cuda import approx_match, emd_pair, match_cost

__all__ = ["approx_match", "match_cost", "earth_mover_distance_dense",
           "earth_mover_distance", "compute_emd"]


def earth_mover_distance_dense(xyz1: torch.Tensor, xyz2: torch.Tensor,
                               max_batch: int = 64) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B,) approximate EMD over materialised
    (b, N, M) tensors, ``max_batch`` pairs at a time; differentiable in both
    clouds with the match held constant."""
    outs = []
    for i in range(0, xyz1.shape[0], max_batch):
        x, y = xyz1[i:i + max_batch], xyz2[i:i + max_batch]
        with torch.no_grad():
            match = approx_match(x, y)
        outs.append(match_cost(x, y, match))
    return torch.cat(outs)


class EarthMoverDistance(torch.autograd.Function):
    """(B, N, 3), (B, M, 3) -> (B,) cost, with the analytic backward."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        cost, r, c, v, u = emd_pair(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, r, c, v, u)
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, r, c, v, u = ctx.saved_tensors
        g = g[:, None, None]
        gx = 2.0 * g * (r[..., None] * xyz1 - v)
        gy = 2.0 * g * (c[..., None] * xyz2 - u)
        return gx, gy


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) float32 -> (B,) approximate EMD, differentiable
    in both clouds (the match held constant)."""
    return EarthMoverDistance.apply(xyz1, xyz2)


def compute_emd(pcs_1: torch.Tensor, pcs_2: torch.Tensor) -> torch.Tensor:
    """Per-point EMD score, (B,): the cost divided by the point count, which
    must be the same in both clouds."""
    n1, n2 = pcs_1.shape[1], pcs_2.shape[1]
    if n1 != n2:
        raise ValueError(f"compute_emd needs equal point counts, got {n1} != {n2}")
    return earth_mover_distance(pcs_1, pcs_2) / float(n1)
