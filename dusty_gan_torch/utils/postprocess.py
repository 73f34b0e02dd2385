"""Generator output post-processing (``dusty_gan_tpu/utils/postprocess.py``):
depth maps from the tanh domain to [0, 1], the confidence through a
sigmoid, back-projection to points and a normal map.  Images are
(B, H, W, C)."""

from __future__ import annotations

import torch

from dusty_gan_torch.geometry.lidar import tanh_to_sigmoid
from dusty_gan_torch.geometry.normals import xyz_to_normal


def postprocess(synth: dict, lidar, tol: float = 1e-8,
                normal_mode: str = "closest") -> dict:
    out = {}
    for key, value in synth.items():
        if key in ("depth", "depth_orig"):
            out[key] = torch.clamp(tanh_to_sigmoid(value), 0.0, 1.0)
        elif key == "confidence":
            out[key] = 1.0 / (1.0 + torch.exp(-value.float()))
        else:
            out[key] = value
    out["points"] = lidar.inv_to_xyz(out["depth"], tol)
    out["normals"] = xyz_to_normal(out["points"], mode=normal_mode)
    return out
