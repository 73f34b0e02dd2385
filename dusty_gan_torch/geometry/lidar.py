"""LiDAR coordinate model: depth normalization and polar -> Cartesian maps
(``dusty_gan_tpu/geometry/lidar.py``).

Range images are (B, H, W, 1), the angle grid is (H, W, 2) with channel 0
elevation (pitch) and 1 azimuth (yaw), point sets are (B, N, 3), as in the
JAX package.

* ``invert_depth``: [0,1] depth -> [0,1] normalized inverse depth;
* ``revert_depth``: its inverse;
* ``inv_to_xyz(inv, tol)``: valid = |inv - drop_const| > tol; depth in
  meters divided by max_depth (unit space); invalid pixels go to the origin.

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
