"""Surface normals on the range-image grid
(``dusty_gan_tpu/geometry/normals.py``).

For each pixel, the 8 neighbours at distance ``d`` (W padded circularly,
H padded with +inf) give 8 difference vectors; the cross product of each
with the one two steps further round is a candidate normal.  "closest"
keeps the pair whose two vectors are shortest, "mean" averages all 8.
Points and normals are (B, H, W, 3).

``euler_angles_to_rotation_matrix`` is the demo camera's rotation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dusty_gan_torch.ops.padding import pad_ring

# the 8 neighbour offsets (dh, dw), in the JAX package's order
_OFFSETS = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))


def estimate_surface_normal(points: torch.Tensor, d: int = 2,
                            mode: str = "closest") -> torch.Tensor:
    """(B, H, W, 3) points -> (B, H, W, 3) unit normals."""
    b, h, w, c = points.shape
    if c != 3:
        raise ValueError(f"points must be (B, H, W, 3), got {tuple(points.shape)}")
    p = pad_ring(points.permute(0, 3, 1, 2), (d, d, 0, 0), horizontal="circular")
    p = F.pad(p, (0, 0, d, d), value=float("inf")).permute(0, 2, 3, 1)

    def neighbor(dh, dw):
        return p[:, d + dh * d:d + dh * d + h, d + dw * d:d + dw * d + w]

    anchors = p[:, d:d + h, d:d + w, None]  # (B, H, W, 1, 3)
    n1 = torch.stack([neighbor(*o) for o in _OFFSETS], dim=3)  # (B, H, W, 8, 3)
    n2 = torch.stack([neighbor(*_OFFSETS[(k + 2) % 8]) for k in range(8)], dim=3)
    v1, v2 = n1 - anchors, n2 - anchors
    if mode == "closest":
        diff = torch.linalg.vector_norm(v1, dim=-1) + torch.linalg.vector_norm(v2, dim=-1)
        i = diff.argmin(dim=3)[..., None, None].expand(-1, -1, -1, 1, 3)
        normals = torch.linalg.cross(v1.gather(3, i)[..., 0, :],
                                     v2.gather(3, i)[..., 0, :], dim=-1)
    elif mode == "mean":
        normals = torch.linalg.cross(v1, v2, dim=-1).mean(dim=3)
    else:
        raise NotImplementedError(mode)
    return normals / (torch.linalg.vector_norm(normals, dim=-1, keepdim=True) + 1e-8)


def xyz_to_normal(xyz: torch.Tensor, mode: str = "closest") -> torch.Tensor:
    """Normal map in [0, 1]: negated normals with NaN and inf set to 0,
    mapped from [-1, 1]."""
    normals = -estimate_surface_normal(xyz, mode=mode)
    normals = torch.nan_to_num(normals, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp((normals + 1.0) / 2.0, 0.0, 1.0)


def euler_angles_to_rotation_matrix(theta) -> torch.Tensor:
    """(3,) angles (x, y, z) in radians -> the float32 (3, 3) rotation
    R = Rz(theta[2]) @ Ry(theta[1]) @ Rx(theta[0])."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    cx, sx = torch.cos(theta[0]), torch.sin(theta[0])
    cy, sy = torch.cos(theta[1]), torch.sin(theta[1])
    cz, sz = torch.cos(theta[2]), torch.sin(theta[2])
    one, zero = torch.ones(()), torch.zeros(())
    r_x = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    r_y = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    r_z = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    return r_z @ r_y @ r_x
