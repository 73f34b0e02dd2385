"""The synthesis protocol's stages after generation, plain: range images to
points, furthest point sampling, pairwise Chamfer distances, and COV, MMD
and 1-NNA (Achlioptas et al., 2018; Yang et al., 2019), as the published
DUSty evaluation computes them.

* inverse depth: of a real scan's depth in metres, min-max normalised
  between the inverses of the sensor's range, in [-1, 1];
* points: inverse depth in [-1, 1] to [0, 1], clamped; valid where it
  differs from 0 by more than ``tol``; depth in metres over ``max_depth``;
  polar to Cartesian at the sensor's angles; invalid pixels at the origin;
* FPS: the first index is 0; points within 1e-3 (squared) of the origin
  neither update the running distances (started at 1e10) nor are chosen;
  ties go to the first index.  FPS is a sequence of discrete choices, so
  this module repeats the float32 arithmetic of the published kernel's
  plain form operation for operation (``(x*x + y*y) + z*z``), and the
  check holds a cloud to it exactly;
* Chamfer: ``mean_n min_m |a_n - b_m|^2 + mean_m min_n |a_n - b_m|^2`` from
  explicit coordinate differences, in float32;
* COV, MMD, 1-NNA: over the reference-by-generated matrix M_rg and the two
  symmetric ones; 1-NNA leave-one-out with the diagonal at infinity.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def inverse_depth(depth: torch.Tensor, min_depth: float, max_depth: float,
                  drop: float) -> torch.Tensor:
    """Normalised depth in [0, 1] (0: no return) -> inverse depth in
    [-1, 1], ``drop`` where there is no return."""
    disp = 1.0 / (depth * (max_depth - min_depth) + min_depth)
    inv = (disp - 1.0 / max_depth) / (1.0 / min_depth - 1.0 / max_depth) * 2.0 - 1.0
    return torch.where(depth > 0, inv, torch.full_like(depth, drop))


def inv_to_points(inv: torch.Tensor, angles: torch.Tensor, min_depth: float,
                  max_depth: float, tol: float) -> torch.Tensor:
    """(B, H, W, 1) inverse depth in [-1, 1], (H, W, 2) angles -> (B, H*W, 3)."""
    inv01 = torch.clamp((inv + 1.0) / 2.0, 0.0, 1.0)
    valid = torch.abs(inv01 - 0.0) > tol
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    disp = inv01 * (hi - lo) + lo
    depth = (1.0 / disp - min_depth) / (max_depth - min_depth)
    depth = depth * (max_depth - min_depth) + min_depth
    depth = depth / max_depth
    depth = depth * valid
    pitch, yaw = angles[..., 0], angles[..., 1]
    x = depth[..., 0] * torch.cos(pitch) * torch.cos(yaw)
    y = depth[..., 0] * torch.cos(pitch) * torch.sin(yaw)
    z = depth[..., 0] * torch.sin(pitch)
    return torch.stack([x, y, z], dim=-1).reshape(inv.shape[0], -1, 3)


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


@torch.no_grad()
def fps(xyz: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """(B, N, 3) -> (B, k, 3) furthest point subset.  ``dtype`` is the
    precision of the distances (float32; a control passes a lower one)."""
    b, n, _ = xyz.shape
    pts = xyz.to(dtype)
    valid = _sq_norm(xyz.float()) > 1e-3
    temp = torch.full((b, n), 1e10, dtype=dtype, device=xyz.device)
    neg = torch.full((), -1.0, dtype=dtype, device=xyz.device)
    idx = torch.zeros((b, k), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for j in range(1, k):
        d = _sq_norm(pts - pts[rows, last][:, None, :])
        temp = torch.where(valid, torch.minimum(temp, d), temp)
        last = torch.where(valid, temp, neg).argmax(dim=-1)
        idx[:, j] = last
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))


def chamfer_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, N, 3), (P, M, 3) clouds matched pair by pair -> (P,) Chamfer
    distances, in the clouds' dtype."""
    d = (a[:, :, None, 0] - b[:, None, :, 0]) ** 2
    d = d + (a[:, :, None, 1] - b[:, None, :, 1]) ** 2
    d = d + (a[:, :, None, 2] - b[:, None, :, 2]) ** 2
    return d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)


def scores(m_rr: np.ndarray, m_rg: np.ndarray, m_gg: np.ndarray) -> Dict[str, float]:
    """COV, MMD and 1-NNA of the three matrices (rows reference, columns
    generated), named as the published evaluation names them, suffix -cd."""
    n_ref, n_gen = m_rg.shape
    out = {"mmd-cd": float(m_rg.min(axis=1).mean()),
           "mmd-sample-cd": float(m_rg.min(axis=0).mean()),
           "cov-cd": float(len(np.unique(m_rg.argmin(axis=0)))) / float(n_ref)}
    label = np.concatenate([np.ones(n_ref), np.zeros(n_gen)])
    m = np.concatenate([np.concatenate([m_rr, m_rg], axis=1),
                        np.concatenate([m_rg.T, m_gg], axis=1)], axis=0)
    np.fill_diagonal(m, np.inf)
    nearest = np.argsort(m, axis=0)[:1]
    pred = (label[nearest].sum(axis=0) >= 0.5).astype(np.float64)
    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    out.update({"1-nn-tp-cd": tp, "1-nn-fp-cd": fp, "1-nn-fn-cd": fn, "1-nn-tn-cd": tn,
                "1-nn-precision-cd": tp / (tp + fp + 1e-10),
                "1-nn-recall-cd": tp / (tp + fn + 1e-10),
                "1-nn-accuracy_t-cd": tp / (tp + fn + 1e-10),
                "1-nn-accuracy_f-cd": tn / (tn + fp + 1e-10),
                "1-nn-accuracy-cd": float((pred == label).mean())})
    return out
