"""GAN inversion as the published DUSty reconstruction benchmark runs it,
and the Chamfer score of its reconstructions, plain.

The latent starts on the sphere (``z / sqrt(mean(z^2) + 1e-9)``); each of
``num_steps`` steps takes the gradient of the summed per-scan loss at a
noise-perturbed latent (noise ``0.05 * max(0, 1 - t / 0.75)^2`` times a
standard normal draw, t = step / num_steps), takes an Adam step (lr 0.1,
betas 0.9 / 0.999, eps 1e-8 outside the square root of the bias-corrected
second moment) scaled by StyleGAN2's schedule (a cosine ramp-down over the
last quarter, a linear ramp-up over the first 5%), and projects back onto
the sphere.  The loss is the masked L1 of the inverse depth in [0, 1]
(``(tanh output + 1) / 2`` before the masker) over the scan's measured
pixels.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def project_sphere(z: torch.Tensor) -> torch.Tensor:
    return z / torch.sqrt(torch.mean(z ** 2, dim=1, keepdim=True) + 1e-9)


def schedule(step: int, num_steps: int) -> float:
    t = step / num_steps
    ramp = min(1.0, (1.0 - t) / 0.25)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    return ramp * min(1.0, t / 0.05)


def noise_strength(step: int, num_steps: int) -> float:
    return 0.05 * max(0.0, 1.0 - (step / num_steps) / 0.75) ** 2


def masked_l1(inv_ref: torch.Tensor, inv_gen: torch.Tensor, mask: torch.Tensor):
    dims = tuple(range(1, inv_ref.dim()))
    return ((inv_ref - inv_gen).abs() * mask).sum(dim=dims) / mask.sum(dim=dims)


def invert(loss_fn: Callable[[torch.Tensor], torch.Tensor], z0: torch.Tensor,
           noise: Callable[[int, torch.Size], torch.Tensor], num_steps: int,
           lr: float = 0.1, stop=None):
    """(z*, per-scan loss at z*); with ``stop``, {step: the latent that
    step's loss took} for the first step and step ``stop``, where it
    stops."""
    z = project_sphere(z0.float())
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    seen = {}
    for i in range(num_steps):
        latent = z.detach().requires_grad_(True)
        x = latent + noise_strength(i, num_steps) * noise(i, z.shape)
        if i in (0, stop):
            seen[i] = x.detach().clone()
            if i == stop:
                return seen
        (g,) = torch.autograd.grad(loss_fn(x).sum(), latent)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t = i + 1
        step = (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        z = project_sphere(z.detach() - lr * step * schedule(i, num_steps))
    with torch.no_grad():
        return z, loss_fn(z)


def nn_sq(a: torch.Tensor, b: torch.Tensor, chunk: int = 2048):
    """(N, 3), (M, 3) -> (N,) squared distance from each a to its nearest b,
    from explicit differences in the clouds' dtype."""
    out = []
    for s in range(0, len(a), chunk):
        x = a[s:s + chunk]
        d = (x[:, None, 0] - b[None, :, 0]) ** 2
        d = d + (x[:, None, 1] - b[None, :, 1]) ** 2
        d = d + (x[:, None, 2] - b[None, :, 2]) ** 2
        out.append(d.amin(dim=1))
    return torch.cat(out)


def chamfer(a: torch.Tensor, b: torch.Tensor) -> float:
    """Symmetric Chamfer score of one pair of clouds: the mean squared
    nearest-neighbour distance each way, summed (in float32 after the
    distances)."""
    return float(nn_sq(a, b).float().mean() + nn_sq(b, a).float().mean())
