"""Point-cloud rendering: bilinear splatting and a soft z-buffer
(``dusty_gan_tpu/geometry/render.py``).

``bilinear_rasterizer`` adds each point's value into its four neighbouring
pixels with bilinear weights, dropping a neighbour outside the image and
any weight below 1e-3 (the reference's stability threshold).  It is
differentiable with respect to the values; the pixel positions are
constants.  ``render_point_clouds`` draws the bird's-eye views of the demo
and of image logging: a pinhole projection, and each pixel the mean of the
colours splatted into it weighted by ``exp(-3 depth)``.  On a CUDA device
``scatter_add`` sums with atomics in no fixed order, so a pixel that
several points reach varies by float32 rounding from run to run.
"""

from __future__ import annotations

import torch


def bilinear_rasterizer(coords: torch.Tensor, values: torch.Tensor, out_shape) -> torch.Tensor:
    """coords (B, N, 2) float (h, w) pixel positions, values (B, N, C) ->
    (B, H, W, C)."""
    b, n, c = values.shape
    h_dim, w_dim = out_shape
    hh, ww = coords[..., 0], coords[..., 1]
    h_t = torch.floor(hh)
    h_b = h_t + 1.0
    w_l = torch.floor(ww)
    w_r = w_l + 1.0
    h_t_safe = torch.clamp(h_t, 0.0, h_dim - 1)
    h_b_safe = torch.clamp(h_b, 0.0, h_dim - 1)
    w_l_safe = torch.clamp(w_l, 0.0, w_dim - 1)
    w_r_safe = torch.clamp(w_r, 0.0, w_dim - 1)
    wt_h_t = (h_b - hh) * (h_t == h_t_safe)
    wt_h_b = (hh - h_t) * (h_b == h_b_safe)
    wt_w_l = (w_r - ww) * (w_l == w_l_safe)
    wt_w_r = (ww - w_l) * (w_r == w_r_safe)

    out = torch.zeros((b, h_dim * w_dim, c), dtype=values.dtype, device=values.device)
    for wt_h, h_safe in ((wt_h_t, h_t_safe), (wt_h_b, h_b_safe)):
        for wt_w, w_safe in ((wt_w_l, w_l_safe), (wt_w_r, w_r_safe)):
            wt = wt_h * wt_w
            wt = wt * (wt >= 1e-3)
            idx = (w_safe + w_dim * h_safe).long()
            out = out.scatter_add(1, idx[..., None].expand(b, n, c), values * wt[..., None])
    return out.reshape(b, h_dim, w_dim, c)


def render_point_clouds(xyz: torch.Tensor, colors: torch.Tensor, L: int = 512,
                        R=None, t=None, focal_length: float = 1.0) -> torch.Tensor:
    """xyz (B, N, 3) in unit space, colors (B, N, C) -> (B, L, L, C).  The
    cloud is flipped in z, rotated by ``R`` (3, 3) (``xyz @ R``) and moved
    by ``t`` (3,); a point projects to ``L * (xy / z + 0.5)`` and counts
    only strictly inside (0, L - 1) on both axes."""
    xyz = xyz * torch.tensor([1.0, 1.0, -1.0], dtype=xyz.dtype, device=xyz.device)
    if R is not None:
        xyz = xyz @ torch.as_tensor(R, dtype=xyz.dtype).to(xyz.device)
    if t is not None:
        xyz = xyz + torch.as_tensor(t, dtype=xyz.dtype).to(xyz.device)
    uv = xyz[..., :2] / (xyz[..., 2:3] + 1e-12) * focal_length + 0.5
    uv = uv * L
    inside = (uv > 0.0) & (uv < L - 1)
    colors = colors * (inside[..., 0:1] & inside[..., 1:2])
    uv = L - uv
    depth = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    weight = torch.exp(-3.0 * depth) * (depth > 1e-8)
    bev = bilinear_rasterizer(uv, weight * colors, (L, L))
    return bev / (bilinear_rasterizer(uv, weight, (L, L)) + 1e-8)
