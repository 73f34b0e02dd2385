"""Evaluation-time drop-rate calibration for the DUSty Gumbel maskers
(``dusty_gan_tpu/utils/calibration.py``).

The Gumbel-sigmoid keep threshold (reference default 0.5) is a monotone
post-hoc knob over the generated drop rate: the hard mask is
``sigmoid((logit + noise) / tau) > threshold``, so raising the threshold
keeps fewer pixels.  ``calibrate_mask_threshold`` bisects the threshold
until the generated drop rate matches a target (normally the real train
set's), with the model's weights untouched.  The default 0.5 is the
reference path; calibration is opt-in.

A drop rate is the fraction of pixels sitting at ``drop_const`` in the tanh
inverse-depth domain, with a 1e-3 guard band, as the trainer's
``drop_rate/*`` validation scalars measure it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["drop_rate_2d", "calibrate_mask_threshold", "real_drop_rate"]


def drop_rate_2d(inv_depth: torch.Tensor, drop_const: float) -> torch.Tensor:
    """Mean fraction of dropped pixels in a batch of tanh inverse-depth
    images (any layout; dropped pixels sit exactly at ``drop_const`` for
    real scans and for the DUSty hard mask)."""
    return (inv_depth < drop_const + 1e-3).float().mean()


def calibrate_mask_threshold(gen: Callable, latents: torch.Tensor,
                             target_rate: float, drop_const: float, *,
                             lo: float = 1e-3, hi: float = 1.0 - 1e-3,
                             iters: int = 24, batch: int = 0) -> Tuple[float, float]:
    """Bisect the Gumbel keep threshold so that the generated drop rate
    matches ``target_rate``.

    ``gen(z, threshold=t)`` must be a deterministic evaluation generator
    (``utils.setup.make_eval_generator``) returning a dict with ``depth``.
    ``latents`` is the calibration batch, on the generator's device; draw
    it apart from the evaluation latents.  ``batch`` > 0 generates in chunks
    of that many latents to bound device memory.

    Returns ``(threshold, achieved_rate)``.  The rate does not fall as the
    threshold rises; over a finite pixel grid it is a step function, so the
    bisection ends on the step that holds the target, or on the nearest
    rate the interval's ends reach.
    """
    n = latents.shape[0]
    step = n if batch <= 0 else int(batch)

    @torch.no_grad()
    def rate(thr: float) -> float:
        acc = 0.0
        for i in range(0, n, step):
            z = latents[i:i + step]
            acc += float(drop_rate_2d(gen(z, threshold=thr)["depth"], drop_const)) * z.shape[0]
        return acc / n

    lo_f, hi_f = float(lo), float(hi)
    r_lo, r_hi = rate(lo_f), rate(hi_f)
    if target_rate <= r_lo:
        return lo_f, r_lo
    if target_rate >= r_hi:
        return hi_f, r_hi
    for _ in range(int(iters)):
        mid = 0.5 * (lo_f + hi_f)
        if rate(mid) > target_rate:
            hi_f = mid
        else:
            lo_f = mid
    # of the two bracket ends, the one closer to the target
    r_lo, r_hi = rate(lo_f), rate(hi_f)
    if abs(r_lo - target_rate) <= abs(r_hi - target_rate):
        return lo_f, r_lo
    return hi_f, r_hi


def real_drop_rate(real_2d, drop_const: float) -> float:
    """Target rate of real tanh inverse-depth images (a tensor on any device
    or an array), as a float."""
    if isinstance(real_2d, torch.Tensor):
        real_2d = real_2d.cpu().numpy()
    return float(np.mean(np.asarray(real_2d) < drop_const + 1e-3))
