"""GAN-inversion optimisation (``dusty_gan_tpu/utils/inversion.py``).

* ``project_sphere``: ``z / sqrt(mean(z^2) + 1e-9)`` per row, the
  reference's spherical optimiser projection;
* ``stylegan2_lr_schedule``: cosine ramp-down with a linear warm-up;
* ``latent_noise_strength``: the decaying latent perturbation;
* ``make_inversion_loop``: Adam (lr 0.1, betas 0.9/0.999, eps 1e-8) on a
  latent re-projected onto the sphere before the first step and after
  every step, with the step size multiplied by the schedule and the loss
  taken at a noise-perturbed latent;
* ``make_multicode_loop``: multi-code mGANprior, a latent {z, alpha} with
  one Adam each (z at lr 0.1, alpha at 0.001, betas 0.9/0.999, eps 1e-8),
  z re-projected onto the sphere before the first step and after every
  step, no schedule and no latent noise;
* ``lerp`` and ``slerp``: latent interpolation.

The Adam update is written out so that it is exactly optax's
``adam(lr)`` followed by a multiplication of the update by the schedule:
eps sits outside the square root of the bias-corrected second moment, and
the moments are updated at step 0, where the schedule is 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

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

    def run(z0: torch.Tensor, noise: NoiseFn):
        z = project_sphere(z0.float())
        m = torch.zeros_like(z)
        v = torch.zeros_like(z)
        for i in range(num_steps):
            latent = z.detach().requires_grad_(True)
            with torch.enable_grad():
                x = latent + latent_noise_strength(i, num_steps) * noise(i, z.shape)
                (grad,) = torch.autograd.grad(loss_fn(x).sum(), latent)
            update = _adam_update(grad, m, v, i + 1)
            z = project_sphere(z + (-lr * update) * stylegan2_lr_schedule(i, num_steps))
        with torch.no_grad():
            return z, loss_fn(z)

    return run


def _adam_update(grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor, t: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """optax's ``scale_by_adam`` at update ``t`` (1-based): updates the
    moments ``m`` and ``v`` in place and returns the step before the
    learning rate."""
    m.mul_(b1).add_(grad, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
    return (m / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t)) + eps)


def make_multicode_loop(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                        num_steps: int, z_lr: float = 0.1, alpha_lr: float = 0.001):
    """Returns ``run(lat0) -> lat*`` for a latent {"z": (N, I), "alpha": ...};
    ``loss_fn(latent)`` gives a per-sample loss whose sum is minimised."""
    lrs = {"z": z_lr, "alpha": alpha_lr}

    def run(lat0: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        lat = {"z": project_sphere(lat0["z"].float()), "alpha": lat0["alpha"].float()}
        moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in lat.items()}
        for i in range(num_steps):
            leaves = {k: v.detach().requires_grad_(True) for k, v in lat.items()}
            with torch.enable_grad():
                grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves).sum(),
                                                             list(leaves.values()))))
            lat = {k: v + (-lrs[k] * _adam_update(grads[k], *moments[k], i + 1))
                   for k, v in lat.items()}
            lat["z"] = project_sphere(lat["z"])
        return lat

    return run


def lerp(val: float, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    return low + (high - low) * val


def slerp(val: float, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between the rows of (B, I) ``low`` and
    ``high``."""
    low_n = low / torch.linalg.vector_norm(low, dim=1, keepdim=True)
    high_n = high / torch.linalg.vector_norm(high, dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp(torch.sum(low_n * high_n, dim=1), -1.0, 1.0))
    so = torch.sin(omega)
    return ((torch.sin((1.0 - val) * omega) / so)[:, None] * low
            + (torch.sin(val * omega) / so)[:, None] * high)
