"""Bilinear splatting of point values into an image
(``dusty_gan_tpu/geometry/render.py``).

``bilinear_rasterizer`` adds each point's value into its four neighbouring
pixels with bilinear weights, dropping a neighbour outside the image and
any weight below 1e-3 (the reference's stability threshold).  It is
differentiable with respect to the values; the pixel positions are
constants.  ``render_point_clouds`` (the bird's-eye views of the demo) is
not yet ported.
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
