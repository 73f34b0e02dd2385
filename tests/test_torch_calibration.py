"""dusty_gan_torch.utils.calibration against dusty_gan_tpu.utils.calibration:
the same latents and fixed Gumbel noise through the same narrow DUSty-II
generator (JAX weights carried into the port), float32 on both sides.
Drop rates and calibrated thresholds agree within 1e-6: a rate moves only
when a pixel's keep probability crosses a tested threshold, and the two
generators' float32 outputs differ by ~1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.utils import calibration as jcal
from dusty_gan_tpu.utils.setup import make_eval_generator as jax_make_eval_generator

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.utils import calibration as tcal
from dusty_gan_torch.utils.setup import make_eval_generator

from tests.torch_parity import IN_CH, jax_generator, logistic, nchw, port_generator

ARCH, SHAPE, DROP = "dusty2/dcgan_eqlr", (32, 64), -1.0


@pytest.fixture(scope="module")
def gens():
    Gj, params = jax_generator(ARCH, SHAPE)
    Gt = port_generator(ARCH, SHAPE, params, drop_const=DROP).requires_grad_(False)
    rng = np.random.RandomState(3)
    pix, img = logistic(rng, (1,) + SHAPE + (1,)), logistic(rng, (1, 1, 1, 1))
    z = rng.randn(4, IN_CH).astype(np.float32)
    gj = jax_make_eval_generator(Gj, params, {"pixel": jnp.asarray(pix),
                                              "image": jnp.asarray(img)}, compute_dtype=None)
    gt = make_eval_generator(Gt, {"pixel": nchw(pix), "image": nchw(img)}, compute_dtype=None)
    return gj, gt, z


@pytest.mark.parametrize("threshold", [0.2, 0.5, 0.8])
def test_drop_rate_2d_matches_jax(gens, threshold):
    gj, gt, z = gens
    want = float(jcal.drop_rate_2d(gj(jnp.asarray(z), threshold=threshold)["depth"], DROP))
    got = float(tcal.drop_rate_2d(gt(torch.from_numpy(z), threshold=threshold)["depth"], DROP))
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.0 < got < 1.0


def test_real_drop_rate_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (3, 8, 16, 1)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = DROP
    want = jcal.real_drop_rate(x, DROP)
    assert tcal.real_drop_rate(x, DROP) == want
    assert tcal.real_drop_rate(torch.from_numpy(x), DROP) == want


@pytest.mark.parametrize("batch", [0, 3])
def test_calibrate_mask_threshold_matches_jax(gens, batch):
    """A target between the generator's rates at thresholds 0.3 and 0.35, so
    that no bisection step compares two rates that differ only by float32
    rounding (XLA and torch sum a mean in other orders): the same steps,
    threshold and achieved rate; chunked generation too.  12 steps leave a
    2.4e-4 bracket; at 18 (4e-6) the bracket gets as narrow as the two
    generators' float32 disagreement on the pixel it closes in on, and the
    thresholds can part by a step."""
    gj, gt, z = gens
    rates = [float(jcal.drop_rate_2d(gj(jnp.asarray(z), threshold=t)["depth"], DROP))
             for t in (0.3, 0.35)]
    assert rates[1] - rates[0] > 1e-3
    target = 0.5 * sum(rates)
    t_j, r_j = jcal.calibrate_mask_threshold(gj, jnp.asarray(z), target, DROP, iters=12,
                                             batch=batch)
    t_t, r_t = tcal.calibrate_mask_threshold(gt, torch.from_numpy(z), target, DROP,
                                             iters=12, batch=batch)
    assert t_t == pytest.approx(t_j, abs=1e-6)
    assert r_t == pytest.approx(r_j, abs=1e-6)
    assert abs(r_t - target) < rates[1] - rates[0]


def test_calibration_clamps_at_interval_ends(gens):
    _, gt, z = gens
    zt = torch.from_numpy(z)
    thr_lo, r_lo = tcal.calibrate_mask_threshold(gt, zt, -1.0, DROP, iters=4)
    thr_hi, r_hi = tcal.calibrate_mask_threshold(gt, zt, 2.0, DROP, iters=4)
    assert (thr_lo, thr_hi) == (1e-3, 1.0 - 1e-3) and r_hi >= r_lo
