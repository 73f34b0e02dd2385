"""Synthetic KITTI-layout dataset for tests and runs without KITTI
(``dusty_gan_tpu/data/synthetic.py``).

Writes raw-format scans (``sequences/NN/velodyne/*.npy`` of (H0, W0, 4))
with a ground plane and random walls, plus the matching ``angles.npy``.
Same seed, same files as ``dusty_gan_tpu/data/synthetic.py``.
"""

from __future__ import annotations

import os
import os.path as osp
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _ray_grids(h0: int, w0: int):
    """Constant per-resolution ray geometry: angle grids + trig products."""
    pitch = np.radians(np.linspace(2.0, -24.8, h0))[:, None] * np.ones((1, w0))
    yaw = np.linspace(np.pi, -np.pi, w0, endpoint=False)[None, :] * np.ones((h0, 1))
    with np.errstate(divide="ignore"):
        ground = np.where(pitch < -1e-3, 1.7 / np.sin(-pitch), np.inf)
    grids = (
        pitch, yaw, ground,
        np.cos(pitch) * np.cos(yaw),  # unit-ray x
        np.cos(pitch) * np.sin(yaw),  # unit-ray y
        np.sin(pitch),                # unit-ray z
    )
    for g in grids:  # shared by every caller: read-only
        g.setflags(write=False)
    return grids


def synthetic_scene_depth(rng, h0: int, w0: int, max_depth: float = 120.0):
    """Depth in meters for each (pitch, yaw) ray, with random dropouts."""
    pitch, yaw, ground, _, _, _ = _ray_grids(h0, w0)
    yaw_row = yaw[0]
    depth = np.minimum(ground, max_depth * 0.8)
    for _ in range(rng.randint(4, 10)):
        c = rng.uniform(-np.pi, np.pi)
        width = rng.uniform(0.05, 0.5)
        dist = rng.uniform(3.0, 60.0)
        sel_row = np.abs(np.mod(yaw_row - c + np.pi, 2 * np.pi) - np.pi) < width
        depth = np.where(sel_row[None, :], np.minimum(depth, dist), depth)
    depth = depth * rng.uniform(0.97, 1.03, depth.shape)  # sensor noise
    drop = rng.uniform(size=depth.shape) < 0.12
    depth = np.where(drop, 0.0, depth)
    return depth.astype(np.float32), pitch, yaw


def build_synthetic_kitti(root: str, n_scans_per_seq: int = 12, h0: int = 64,
                          w0: int = 512, seed: int = 0,
                          sequences=(0, 8, 11)) -> str:
    """Create a dataset tree under ``root`` (train seq 00, val seq 08, test
    seq 11 by default).  Returns root."""
    rng = np.random.RandomState(seed)
    _, _, _, ux, uy, uz = _ray_grids(h0, w0)
    scan = np.empty((h0, w0, 4), dtype=np.float32)
    for seq in sequences:
        d = osp.join(root, "sequences", str(seq).zfill(2), "velodyne")
        os.makedirs(d, exist_ok=True)
        for i in range(n_scans_per_seq):
            depth, _, _ = synthetic_scene_depth(rng, h0, w0)
            np.multiply(depth, ux, out=scan[..., 0])
            np.multiply(depth, uy, out=scan[..., 1])
            np.multiply(depth, uz, out=scan[..., 2])
            scan[..., 3] = rng.uniform(size=depth.shape)
            np.save(osp.join(d, f"{i:06d}.npy"), scan)

    pitch, yaw, _, _, _, _ = _ray_grids(h0, w0)
    angles = np.stack([pitch, yaw], axis=0).astype(np.float32)
    np.save(osp.join(root, "angles.npy"), angles)
    return root
