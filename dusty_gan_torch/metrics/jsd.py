"""Jensen-Shannon divergence between occupancy-grid distributions
(``dusty_gan_tpu/metrics/jsd.py``), on the host with numpy.

A 28^3 unit-cube grid clipped to the unit sphere; each point votes for its
nearest cell; JSD is taken between the two sets' total vote counts.  The
nearest cell of a uniform lattice is per-axis rounding with ties to the
lower index; points whose rounded cell was clipped away take an exact
argmin over the kept cells.  The mixture entropy keeps the reference's
double epsilon, ``(P+eps + Q+eps)/2 + eps``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _grid_tables(resolution: int, clip_sphere: bool):
    """Full-lattice cell centres, keep-mask and full->clipped index table."""
    spacing = 1.0 / float(resolution - 1)
    steps = np.arange(resolution, dtype=np.float32)
    gx, gy, gz = np.meshgrid(steps, steps, steps, indexing="ij")
    grid = (np.stack([gx, gy, gz], axis=-1) * spacing - 0.5).reshape(-1, 3)
    if clip_sphere:
        keep = np.linalg.norm(grid, axis=1) <= 0.5
    else:
        keep = np.ones(len(grid), dtype=bool)
    lut = np.cumsum(keep) - 1  # clipped index of each kept full cell
    for a in (grid, keep, lut):
        a.setflags(write=False)
    return grid, keep, lut


def _nearest_cell(pcs, resolution: int = 28, in_sphere: bool = True) -> np.ndarray:
    """(B, N, 3) -> (B, N) indices into the (clipped) grid."""
    grid, keep, lut = _grid_tables(resolution, in_sphere)
    p = np.asarray(pcs, dtype=np.float32)
    x = (p + 0.5) * np.float32(resolution - 1)
    i = np.clip(np.ceil(x - 0.5).astype(np.int64), 0, resolution - 1)
    full = (i[..., 0] * resolution + i[..., 1]) * resolution + i[..., 2]
    idx = lut[full]
    bad = ~keep[full]
    if bad.any():
        pts = p.reshape(-1, 3)[bad.ravel()]
        clipped = grid[keep]
        out = np.empty(len(pts), dtype=np.int64)
        for s in range(0, len(pts), 4096):
            q = pts[s:s + 4096]
            d = ((q[:, None, :] - clipped[None, :, :]) ** 2).sum(-1)
            out[s:s + 4096] = np.argmin(d, axis=1)
        flat = idx.reshape(-1)
        flat[bad.ravel()] = out
        idx = flat.reshape(idx.shape)
    return idx


def occupancy_counts(pcs, resolution: int = 28, in_sphere: bool = True) -> np.ndarray:
    """Total vote count per cell, float32."""
    _, keep, _ = _grid_tables(resolution, in_sphere)
    idx = _nearest_cell(pcs, resolution, in_sphere)
    return np.bincount(idx.reshape(-1), minlength=int(keep.sum())).astype(np.float32)


def _entropy_bits(p):
    return np.sum(-p * np.log2(p))


def jensen_shannon_divergence(p_counts, q_counts, eps: float = 1e-8):
    p = p_counts / np.sum(p_counts) + np.float32(eps)
    q = q_counts / np.sum(q_counts) + np.float32(eps)
    m = (p + q) / np.float32(2.0) + np.float32(eps)
    return _entropy_bits(m) - (_entropy_bits(p) + _entropy_bits(q)) / np.float32(2.0)


def _host(pcs) -> np.ndarray:
    if hasattr(pcs, "detach"):
        pcs = pcs.detach().cpu().numpy()
    return np.asarray(pcs, dtype=np.float32)


def compute_jsd(pcs_gen, pcs_ref, resolution: int = 28) -> float:
    """Inputs are pre-scaled (callers pass points / 2 so the clouds lie in
    the unit sphere); tensors or arrays of shape (B, N, 3)."""
    gen_counts = occupancy_counts(_host(pcs_gen), resolution, True)
    ref_counts = occupancy_counts(_host(pcs_ref), resolution, True)
    return float(jensen_shannon_divergence(gen_counts, ref_counts))
