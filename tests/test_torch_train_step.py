"""One train step of the port against ``dusty_gan_tpu.train.step.
make_train_step`` under the float32 policy, on the CPU at tiny sizes, from
identical G, D, G_ema, optimizer state and batch, with the JAX step's draws
reproduced from its key: z and the DiffAugment draws by the same
jax.random calls, the Gumbel noise fields by running the JAX generator
with the round's Gumbel key and recording what ``logistic_noise`` returns.

Covers DUSty-I and DUSty-II, A=2 accumulation, a relativistic mode with
the path-length penalty on, and a decaying learning rate over two steps.

Tolerances (float32 through the R1 double backward):
* every scalar within rtol 1e-5 / atol 1e-6;
* the Adam moments within rtol 1e-5 and an absolute 1e-5 of the model's
  largest moment: a gradient is a sum over the batch's pixels, so its error
  scales with the model's gradients, not with each entry;
* G, D and G_ema within rtol 1e-5 / atol 1e-6 plus the change that the
  moment tolerance can make in Adam's update lr * g / (|g| + 1e-8)
  (``update_slack``): negligible for most entries, up to 2 lr a step where
  the gradient lies below the tolerance (e.g. D's final bias under a
  relativistic loss, whose exact gradient is 0, so either framework may
  take any update in [-lr, lr] there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.train.step import fetch_reals as jax_fetch_reals

from dusty_gan_torch.core.dtypes import FP32_POLICY
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.train.state import LRSchedule, create_train_state, updates_done
from dusty_gan_torch.train.step import TrainStep, fetch_reals, sample_draws

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (BATCH, BETA1, BETA2, IN_CH, LR, SH, SW, check_step_adam,
                          check_step_discriminator, check_step_generators, check_step_scalars,
                          depth_batch, jax_discriminator, jax_generator, nchw, nhwc,
                          port_discriminator, port_generator, run_step_case, step_angles)

H, W = SH, SW


@pytest.fixture(scope="module", params=["dusty2", "dusty1_accum2"])
def case(request):
    return run_step_case(request.param)


def test_scalars_match_jax(case):
    check_step_scalars(case)


def test_generators_match_jax(case):
    check_step_generators(case)


def test_discriminator_matches_jax(case):
    check_step_discriminator(case)


def test_adam_states_match_jax(case):
    check_step_adam(case)


def test_schedule_is_staircase():
    s = LRSchedule(1.0, 0.5, 3)
    assert [s.at(n) for n in range(7)] == [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.25]
    assert LRSchedule(2e-3).at(10 ** 6) == 2e-3


def test_step_counts_updates_and_keeps_d_trainable():
    """After a step: one update each, D's parameters take gradients again,
    G_ema is frozen, and the gradient-free draws checks hold."""
    Gj, pG = jax_generator("dusty2/dcgan_eqlr", (H, W), seed=3)
    _, pD = jax_discriminator((H, W), seed=4)
    G = port_generator("dusty2/dcgan_eqlr", (H, W), pG)
    state = create_train_state(G, port_discriminator((H, W), pD), lr_G=LR, lr_D=LR,
                               beta1=BETA1, beta2=BETA2)
    step = TrainStep(Lidar.from_angle_array(step_angles(), (H, W), 0.9, 120.0), batch_size=BATCH,
                     policy=FP32_POLICY)
    draws = sample_draws(torch.Generator().manual_seed(0), "cpu", G, rounds=1, b=BATCH,
                         in_ch=IN_CH, shape=(H, W))
    with pytest.raises(ValueError):
        step(state, {"depth": nchw(depth_batch(0))}, draws * 2)
    step(state, {"depth": nchw(depth_batch(0))}, draws)
    assert updates_done(state.opt_G) == updates_done(state.opt_D) == 1
    assert all(p.requires_grad for p in state.D.parameters())
    assert not any(p.requires_grad for p in state.G_ema.parameters())
    assert isinstance(state.G, DUSty2) and not isinstance(state.G, DUSty1)


@pytest.mark.parametrize("with_mask", [True, False])
def test_fetch_reals_matches_jax(with_mask):
    depth = depth_batch(5)
    batch = {"depth": depth}
    if with_mask:
        batch["mask"] = (depth > 0).astype(np.float32)
    lidar = Lidar.from_angle_array(step_angles(), (H, W), 0.9, 120.0)
    jlidar = JaxLidar.from_angle_array(step_angles(), (H, W), 0.9, 120.0)
    want_inv, want_mask = jax_fetch_reals({k: jnp.asarray(v) for k, v in batch.items()},
                                          jlidar, -1.0)
    inv, mask = fetch_reals({k: nchw(v) for k, v in batch.items()}, lidar, -1.0)
    np.testing.assert_allclose(nhwc(inv), np.asarray(want_inv), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(nhwc(mask), np.asarray(want_mask))
