"""Furthest point sampling + gather (``dusty_gan_tpu/metrics/fps.py``), a
plain PyTorch loop of k dependent steps over a running min-distance vector.

Kept exactly:
* the first selected index is always 0, even for a dropped origin point;
* points with squared magnitude <= 1e-3 never update the running distances
  and are never selected (dropped pixels back-project to the origin);
* running distances start at 1e10;
* ties go to the first index (``argmax``).

The loop is the tracer's span ``fps``, and its k - 1 steps are added to
the counter ``fps.steps`` once a call (``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from dusty_gan_torch.utils import profiling


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


@torch.no_grad()
def furthest_point_sampling(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> (B, k) int64 indices."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    valid = _sq_norm(xyz) > 1e-3
    idxs = torch.zeros((b, k), dtype=torch.int64, device=xyz.device)
    temp = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    neg = torch.full((), -1.0, dtype=torch.float32, device=xyz.device)
    old = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    batch = torch.arange(b, device=xyz.device)
    profiling.count("fps.steps", max(k - 1, 0))
    with profiling.span("fps"):
        for j in range(1, k):
            last = xyz[batch, old]  # (B, 3)
            d = _sq_norm(xyz - last[:, None, :])
            temp = torch.where(valid, torch.minimum(temp, d), temp)
            old = torch.where(valid, temp, neg).argmax(dim=-1)
            idxs[:, j] = old
    return idxs


def gather_points(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, k) -> (B, k, C)."""
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, xyz.shape[-1]))


def downsample_point_clouds(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> (B, k, 3) FPS subset."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3) clouds, got {tuple(xyz.shape)}")
    return gather_points(xyz, furthest_point_sampling(xyz, k))
