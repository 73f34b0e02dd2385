"""Sliced Wasserstein distance over Laplacian-pyramid patch descriptors
(``dusty_gan_tpu/metrics/swd.py``, the ProGAN metric).

[1,4,6,4,1] Gaussian pyramid with reflect padding, 7x7 patches (128 random
per image batch and level), per-level descriptor standardization with a
Bessel-corrected std, 4 repeats of 128 random projections, sorted-L1 sliced
Wasserstein, ``swd-{16<<level}`` names and ``swd-mean``.

Images enter as (B, H, W, 1) like the JAX package's and are convolved as
NCHW.  The random draws come from a ``draws`` object: ``TorchDraws`` (the
default) takes them from a seeded ``torch.Generator``; a test passes an
object with the same two methods that returns the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
_K5 = np.outer(_GAUSS, _GAUSS)
_K5 = _K5 / _K5.sum()


class TorchDraws:
    """Patch indices and projection directions from one seeded generator
    (on the CPU, so every device draws the same numbers)."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def patches(self, start: int, level: int, n: int, count: int) -> torch.Tensor:
        """``count`` distinct patch positions out of ``n``."""
        return torch.randperm(n, generator=self.generator)[:count]

    def directions(self, level: int, repeat: int, dim: int, count: int) -> torch.Tensor:
        """(dim, count) standard normal projection directions."""
        return torch.randn((dim, count), generator=self.generator)


def _depthwise5x5(x, kernel, stride: int):
    c = x.shape[1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    k = k[None, None].expand(c, 1, 5, 5)
    return F.conv2d(x, k, stride=stride, groups=c)


def pyramid_down(x):
    return _depthwise5x5(F.pad(x, (2, 2, 2, 2), mode="reflect"), _K5, 2)


def pyramid_up(x):
    """Zero-dilate by 2 with samples at odd positions, crop the last row and
    column, reflect-pad 2, then the 5x5 Gaussian times 4."""
    b, c, h, w = x.shape
    up = torch.zeros((b, c, 2 * h + 1, 2 * w + 1), dtype=x.dtype, device=x.device)
    up[:, :, 1::2, 1::2] = x
    up = up[:, :, :-1, :-1]
    return _depthwise5x5(F.pad(up, (2, 2, 2, 2), mode="reflect"), _K5 * 4.0, 1)


def laplacian_pyramid(images, num_levels: int):
    pyramid = [images]
    for _ in range(1, num_levels):
        pyramid.append(pyramid_down(pyramid[-1]))
        pyramid[-2] = pyramid[-2] - pyramid_up(pyramid[-1])
    return pyramid


def extract_patches(minibatch, inds, patch_size: int):
    """(B, C, H, W) and flat patch positions (P,) -> (B, P, C, pH, pW)."""
    _, _, h, w = minibatch.shape
    nw = w - patch_size + 1
    inds = inds.to(minibatch.device)
    ih, iw = inds // nw, inds % nw
    ar = torch.arange(patch_size, device=minibatch.device)
    gh = ih[:, None, None] + ar[None, :, None]
    gw = iw[:, None, None] + ar[None, None, :]
    patches = minibatch[:, :, gh, gw]  # (B, C, P, pH, pW)
    return patches.permute(0, 2, 1, 3, 4)


def finalize_descriptors(desc):
    """Standardize over (batch, patch, h, w) per channel."""
    mean = desc.mean(dim=(0, 1, 3, 4), keepdim=True)
    n = desc.shape[0] * desc.shape[1] * desc.shape[3] * desc.shape[4]
    var = ((desc - mean) ** 2).sum(dim=(0, 1, 3, 4), keepdim=True) / max(n - 1, 1)
    desc = (desc - mean) / (torch.sqrt(var) + 1e-8)
    return desc.reshape(-1, desc.shape[2] * desc.shape[3] * desc.shape[4])


def sliced_wasserstein_distance(draws, level: int, desc1, desc2,
                                dir_repeats: int, dirs_per_repeat: int):
    dim = desc1.shape[1]
    vals = []
    for rep in range(dir_repeats):
        dirs = draws.directions(level, rep, dim, dirs_per_repeat)
        dirs = dirs.to(device=desc1.device, dtype=desc1.dtype)
        dirs = dirs / torch.std(dirs, dim=0, keepdim=True, correction=1)
        p1 = torch.sort(desc1 @ dirs, dim=0).values
        p2 = torch.sort(desc2 @ dirs, dim=0).values
        vals.append(torch.mean(torch.abs(p1 - p2)))
    return torch.mean(torch.stack(vals))


def compute_swd(image1, image2, draws=None, num_levels: Optional[int] = None,
                patch_size: int = 7, num_patches: int = 128,
                dir_repeats: int = 4, dirs_per_repeat: int = 128,
                batch_size: int = 128) -> Dict[str, float]:
    """Images (B, H, W, C), identical shapes."""
    if image1.dim() != 4 or image1.shape != image2.shape:
        raise ValueError(f"expected two (B, H, W, C) image sets of one shape, "
                         f"got {tuple(image1.shape)} and {tuple(image2.shape)}")
    b, h, w, _ = image1.shape
    draws = TorchDraws(0) if draws is None else draws
    if num_levels is None:
        num_levels = int(np.log2(min(h, w) // 16) + 1)
    image1 = image1.float().permute(0, 3, 1, 2)
    image2 = image2.float().permute(0, 3, 1, 2)

    desc1 = {i: [] for i in range(num_levels)}
    desc2 = {i: [] for i in range(num_levels)}
    for start in range(0, b, batch_size):
        p1 = laplacian_pyramid(image1[start:start + batch_size], num_levels)
        p2 = laplacian_pyramid(image2[start:start + batch_size], num_levels)
        for lvl in range(num_levels):
            lh, lw = p1[lvl].shape[2:]
            n = (lh - patch_size + 1) * (lw - patch_size + 1)
            inds = draws.patches(start, lvl, n, num_patches)
            desc1[lvl].append(extract_patches(p1[lvl], inds, patch_size))
            desc2[lvl].append(extract_patches(p2[lvl], inds, patch_size))

    result = {}
    for lvl in range(num_levels):
        d1 = finalize_descriptors(torch.cat(desc1[lvl], dim=0))
        d2 = finalize_descriptors(torch.cat(desc2[lvl], dim=0))
        result["swd-" + str(16 << lvl)] = float(sliced_wasserstein_distance(
            draws, lvl, d1, d2, dir_repeats, dirs_per_repeat))
    result["swd-mean"] = float(sum(result.values()) / len(result))
    return result
