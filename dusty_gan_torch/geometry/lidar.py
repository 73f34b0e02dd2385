"""LiDAR coordinate model: depth normalization and polar -> Cartesian maps
(``dusty_gan_tpu/geometry/lidar.py``).

Range images are (B, H, W, 1), the angle grid is (H, W, 2) with channel 0
elevation (pitch) and 1 azimuth (yaw), point sets are (B, N, 3), as in the
JAX package.

* ``invert_depth``: [0,1] depth -> [0,1] normalized inverse depth;
* ``revert_depth``: its inverse;
* ``inv_to_xyz(inv, tol)``: valid = |inv - drop_const| > tol; depth in
  meters divided by max_depth (unit space); invalid pixels go to the origin;
* ``points_to_depth``: differentiable re-projection of points into a range
  image, by nearest-angle search and bilinear splatting.

The angle grid is resized to the model shape with antialiased bilinear
interpolation, which is what ``jax.image.resize(..., "bilinear")`` does when
it shrinks a grid; plain ``align_corners=False`` interpolation differs from
it by milliradians when the angle file is wider than the model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dusty_gan_torch.geometry.render import bilinear_rasterizer


def normalize_minmax(x, vmin, vmax):
    return (x - vmin) / (vmax - vmin)


def denormalize_minmax(x, vmin, vmax):
    return x * (vmax - vmin) + vmin


def sigmoid_to_tanh(x):
    """[0,1] -> [-1,1]."""
    return x * 2.0 - 1.0


def tanh_to_sigmoid(x):
    """[-1,1] -> [0,1]."""
    return (x + 1.0) / 2.0


@dataclasses.dataclass(frozen=True)
class Lidar:
    angle: torch.Tensor  # (H, W, 2) float32
    min_depth: float
    max_depth: float
    drop_const: float = 0.0

    @property
    def shape(self) -> Tuple[int, int]:
        return self.angle.shape[0], self.angle.shape[1]

    @staticmethod
    def from_angle_array(angle_2hw, shape, min_depth: float, max_depth: float,
                         device="cpu") -> "Lidar":
        """Build from a (2, H0, W0) angle grid resized to ``shape``."""
        a = torch.as_tensor(np.asarray(angle_2hw, np.float32)).to(device)
        h, w = shape
        if tuple(a.shape[1:]) != (h, w):
            a = F.interpolate(a[None], size=(h, w), mode="bilinear",
                              align_corners=False, antialias=True)[0]
        return Lidar(angle=a.permute(1, 2, 0).contiguous(),
                     min_depth=float(min_depth), max_depth=float(max_depth))

    @staticmethod
    def from_angle_file(path: str, shape, min_depth: float, max_depth: float,
                        device="cpu") -> "Lidar":
        """Load ``angles.npy`` or ``angles.pt``."""
        if str(path).endswith(".npy"):
            arr = np.load(path)
        else:
            arr = torch.load(path, map_location="cpu").numpy()
        return Lidar.from_angle_array(arr, shape, min_depth, max_depth, device)

    def invert_depth(self, norm_depth):
        depth = denormalize_minmax(norm_depth, self.min_depth, self.max_depth)
        disp = 1.0 / depth
        return normalize_minmax(disp, 1.0 / self.max_depth, 1.0 / self.min_depth)

    def revert_depth(self, norm_disp, norm: bool = True):
        disp = denormalize_minmax(norm_disp, 1.0 / self.max_depth, 1.0 / self.min_depth)
        depth = 1.0 / disp
        if norm:
            return normalize_minmax(depth, self.min_depth, self.max_depth)
        return depth

    def pol_to_xyz(self, polar):
        """(B, H, W, 1) range -> (B, H, W, 3) xyz."""
        pitch = self.angle[..., 0]
        yaw = self.angle[..., 1]
        x = polar[..., 0] * torch.cos(pitch) * torch.cos(yaw)
        y = polar[..., 0] * torch.cos(pitch) * torch.sin(yaw)
        z = polar[..., 0] * torch.sin(pitch)
        return torch.stack([x, y, z], dim=-1)

    def inv_to_xyz(self, inv_depth, tol: float = 1e-8):
        """(B, H, W, 1) normalized inverse depth in [0,1] -> (B, H, W, 3)
        unit-space xyz; dropped pixels -> origin."""
        valid = torch.abs(inv_depth - self.drop_const) > tol
        depth = self.revert_depth(inv_depth)
        depth = depth * (self.max_depth - self.min_depth) + self.min_depth
        depth = depth / self.max_depth
        depth = depth * valid
        return self.pol_to_xyz(depth)

    def nearest_angle(self, pitch: torch.Tensor, yaw: torch.Tensor,
                      chunk: int = 8192) -> torch.Tensor:
        """Flat index of the grid angle nearest each (pitch, yaw), by
        squared angle distance.  The H*W grid is scanned in ``chunk``-sized
        slabs with a running (min, argmin), so memory is O(B*N*chunk): a tie
        inside a slab goes to its first occurrence and across slabs the
        comparison is strict, so the earlier slab wins; the index does not
        depend on ``chunk``."""
        ref = self.angle.reshape(-1, 2)
        best = torch.full(pitch.shape, float("inf"), dtype=pitch.dtype, device=pitch.device)
        best_idx = torch.zeros(pitch.shape, dtype=torch.long, device=pitch.device)
        chunk = max(1, min(int(chunk), ref.shape[0]))
        for off in range(0, ref.shape[0], chunk):
            rc = ref[off:off + chunk]
            d2 = (pitch[..., None] - rc[:, 0]) ** 2 + (yaw[..., None] - rc[:, 1]) ** 2
            cmin, cidx = torch.min(d2, dim=-1)
            take = cmin < best
            best = torch.where(take, cmin, best)
            best_idx = torch.where(take, cidx + off, best_idx)
        return best_idx

    def points_to_depth(self, xyz: torch.Tensor, drop_value: float = 1.0, tol: float = 1e-8,
                        tau: float = 2.0, chunk: int = 8192):
        """(B, N, 3) unit-space points -> ((B, H, W, 1) normalised depth,
        validity), differentiable with respect to ``xyz``: each point lands
        on the pixel of its nearest grid angle, weighted exp(-tau * depth)
        and gated to (min_depth, max_depth), splatted bilinearly; a pixel's
        depth is its weighted mean, an empty pixel is ``drop_value``.
        ``tol`` is unused, as in the JAX package."""
        h, w = self.shape
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        r = torch.sqrt(x ** 2 + y ** 2 + 1e-24)
        depth_1d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        weight = torch.exp(-tau * depth_1d)
        depth_m = depth_1d * self.max_depth
        weight = weight * ((depth_m > self.min_depth)
                           & (depth_m < self.max_depth)).to(weight.dtype)
        pitch = torch.atan2(z, r)
        yaw = torch.atan2(y, x)
        with torch.no_grad():
            ids = self.nearest_angle(pitch, yaw, chunk)
        uv = torch.stack([ids // w, ids % w], dim=-1).to(xyz.dtype)
        num = bilinear_rasterizer(uv, weight * depth_m, (h, w))
        den = bilinear_rasterizer(uv, weight, (h, w))
        depth_2d = num / (den + 1e-8)
        valid = depth_2d != 0
        depth_2d = normalize_minmax(depth_2d, self.min_depth, self.max_depth)
        depth_2d = torch.where(valid, depth_2d, torch.full_like(depth_2d, drop_value))
        return depth_2d, valid
