"""Scan corruptions of the inversion demo (``dusty_gan_tpu/utils/corruption.py``).

Images are (B, H, W, 1), as in the JAX package.  The random corruptions
(``dropout_noise``, ``random_lines``, ``additive_noise``) take their numbers
from a ``Draws``: one seeded ``torch.Generator`` on the CPU, so that a run on
the card and one on the CPU corrupt a scan alike (a test hands in the JAX
package's draws through the same three methods).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLOSING_MAX_ITERS = 64


class Draws:
    """Uniform, permutation and normal draws from one CPU generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator)


def dropout_noise(draws: Draws, mask: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    """Keeps each pixel with probability ``rate``."""
    keep = (draws.uniform(mask.shape).to(mask.device) < rate).to(mask.dtype)
    return mask * keep


def sparse_hlines(mask: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    sparse = torch.zeros_like(mask)
    sparse[:, ::int(1.0 / rate)] = 1.0
    return mask * sparse


def sparse_vlines(mask: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    sparse = torch.zeros_like(mask)
    sparse[:, :, ::int(1.0 / rate)] = 1.0
    return mask * sparse


def random_lines(draws: Draws, mask: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    """Drops ``int(H * (1 - rate))`` random rows."""
    h = mask.shape[1]
    rows = draws.permutation(h)[:int(h * (1 - rate))].to(mask.device)
    out = mask.clone()
    out[:, rows] = 0.0
    return out


def corrupt_half(mask: torch.Tensor) -> torch.Tensor:
    out = mask.clone()
    out[:, :, mask.shape[2] // 2:] = 0.0
    return out


def corrupt_quarter(mask: torch.Tensor) -> torch.Tensor:
    w = mask.shape[2]
    out = mask.clone()
    out[:, :, :w // 4] = 0.0
    out[:, :, w // 2:w * 3 // 4] = 0.0
    return out


def additive_noise(draws: Draws, depth: torch.Tensor, strength: float = 0.01) -> torch.Tensor:
    return depth + draws.normal(depth.shape).to(depth.device) * strength


def _median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median over reflect padding that excludes the edge; 9 values, so
    the median is the middle one."""
    h, w = x.shape[1:3]
    p = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    stack = torch.stack([p[:, i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return torch.median(stack, dim=0).values


def closing(inv: torch.Tensor, max_iters: int = CLOSING_MAX_ITERS) -> torch.Tensor:
    """Hole filling: a 3x3 median blur, then, while any pixel is <= 1e-8
    (at most ``max_iters`` times), each such pixel takes the 3x3 maximum
    over zero padding."""
    x = _median3x3(inv)
    for _ in range(max_iters):
        invalid = x <= 1e-8
        if not bool(invalid.any()):
            break
        filled = F.max_pool2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)), 3, stride=1)
        x = torch.where(invalid, filled.permute(0, 2, 3, 1), x)
    return x


def apply_corruption(draws: Draws, dep_ref: torch.Tensor, mask_ref: torch.Tensor,
                     corruption: str):
    """(corrupted depth, corrupted mask) of one of the demo's ten
    corruptions ("none" included)."""
    if corruption in (None, "", "none"):
        return dep_ref, mask_ref
    if corruption == "additive noise":
        return additive_noise(draws, dep_ref, 0.01), mask_ref
    if corruption == "low resolution":
        return dep_ref, sparse_hlines(mask_ref, 1 / 8)
    if corruption == "dropout":
        return dep_ref, dropout_noise(draws, mask_ref, rate=0.1)
    if corruption == "closing":
        return closing(dep_ref), torch.ones_like(mask_ref)
    if corruption == "half":
        return dep_ref, corrupt_half(mask_ref)
    if corruption == "quarter":
        return dep_ref, corrupt_quarter(mask_ref)
    if corruption == "vlines":
        return dep_ref, sparse_vlines(mask_ref, 1 / 8)
    if corruption == "hlines":
        return dep_ref, sparse_hlines(mask_ref)
    if corruption in ("random lines", "random_lines"):
        return dep_ref, random_lines(draws, mask_ref)
    raise NotImplementedError(corruption)
