"""GAN-inversion optimisation (``dusty_gan_tpu/utils/inversion.py``).

* ``project_sphere``: ``z / sqrt(mean(z^2) + 1e-9)`` per row, the
  reference's spherical optimiser projection;
* ``stylegan2_lr_schedule``: cosine ramp-down with a linear warm-up;
* ``latent_noise_strength``: the decaying latent perturbation;
* ``make_inversion_loop``: Adam (lr 0.1, betas 0.9/0.999, eps 1e-8) on a
  latent re-projected onto the sphere before the first step and after
  every step, with the step size multiplied by the schedule and the loss
  taken at a noise-perturbed latent.

The Adam update is written out so that it is exactly optax's
``adam(lr)`` followed by a multiplication of the update by the schedule:
eps sits outside the square root of the bias-corrected second moment, and
the moments are updated at step 0, where the schedule is 0.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

NoiseFn = Callable[[int, torch.Size], torch.Tensor]


def project_sphere(z: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return z / torch.sqrt(torch.mean(z ** 2, dim=1, keepdim=True) + eps)


def stylegan2_lr_schedule(step: int, num_steps: int, rampup_ratio: float = 0.05,
                          rampdown_ratio: float = 0.25) -> float:
    t = step / num_steps
    gamma = min(1.0, (1.0 - t) / rampdown_ratio)
    gamma = 0.5 - 0.5 * math.cos(gamma * math.pi)
    return gamma * min(1.0, t / rampup_ratio)


def latent_noise_strength(step: int, num_steps: int, noise_ratio: float = 0.75,
                          noise_sigma: float = 1.0) -> float:
    w = max(0.0, 1.0 - (step / num_steps) / noise_ratio)
    return 0.05 * noise_sigma * w ** 2


def make_inversion_loop(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],  # latent -> per-sample loss (B,)
    num_steps: int = 1000,
    lr: float = 0.1,
):
    """Returns ``run(z0, noise) -> (z*, per-sample loss at z*)``.

    ``noise(step, shape)`` gives the standard normal draw of each step
    (from a seeded generator, or numbers handed in by a test).  The gradient is
    taken with respect to the latent alone, of the summed per-sample loss,
    which gives every sample its own gradient."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def run(z0: torch.Tensor, noise: NoiseFn):
        z = project_sphere(z0.float())
        m = torch.zeros_like(z)
        v = torch.zeros_like(z)
        for i in range(num_steps):
            latent = z.detach().requires_grad_(True)
            with torch.enable_grad():
                x = latent + latent_noise_strength(i, num_steps) * noise(i, z.shape)
                (grad,) = torch.autograd.grad(loss_fn(x).sum(), latent)
            t = i + 1
            m.mul_(b1).add_(grad, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
            update = (m / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t)) + eps)
            z = project_sphere(z + (-lr * update) * stylegan2_lr_schedule(i, num_steps))
        with torch.no_grad():
            return z, loss_fn(z)

    return run
