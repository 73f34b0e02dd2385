"""The port's training ops and discriminator against the JAX package on
the CPU at tiny sizes: ``blur_vh``, each DiffAugment op with the JAX op's
draws reproduced from the same keys, D's forward and input gradient on
weights carried from a JAX init (float32), ``define_D`` loaded strictly,
and the far-field sensitivity of D's logit under the port's bf16 policy."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.ops import blur as jblur
from dusty_gan_tpu.ops import diff_augment as jaug
from dusty_gan_tpu.utils import torch_export as te

from dusty_gan_torch.config import compose
from dusty_gan_torch.models.factory import define_D
from dusty_gan_torch.ops.blur import BlurVH, blur_vh
from dusty_gan_torch.ops.diff_augment import (DEFAULT_POLICY, diff_augment,
                                              draw_augment)
from dusty_gan_torch.ops.linear import EqualLR

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (TOL_F32, jax_augment_draws, jax_discriminator, nchw, nhwc,
                          port_discriminator)

H, W = 32, 64
# ops that only move, select or zero values are exact; colour ops and the
# blur round in float32 as the JAX ops do (means over an image may sum in
# another order)
TOL_AUG = dict(rtol=1e-6, atol=1e-6)


def _images(b=4, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (b, H, W, 1)).astype(np.float32)


@pytest.mark.parametrize("ring", [True, False])
def test_blur_vh_matches_jax(ring):
    x = _images()
    want = np.asarray(jblur.blur_vh(jnp.asarray(x), ring))
    np.testing.assert_array_equal(nhwc(blur_vh(nchw(x), ring)), want)
    np.testing.assert_array_equal(nhwc(BlurVH(ring)(nchw(x))), want)


def test_blur_buffers_are_the_references():
    sd = BlurVH().state_dict()
    assert tuple(sd["blur_v.kernel"].shape) == (1, 1, 3, 1)
    assert tuple(sd["blur_h.kernel"].shape) == (1, 1, 1, 3)
    np.testing.assert_array_equal(sd["blur_h.kernel"].flatten().numpy(), [0.25, 0.5, 0.25])


@pytest.mark.parametrize("op", DEFAULT_POLICY)
def test_each_augment_op_matches_jax(op):
    """One op of the JAX pipeline against the port's, the draws reproduced
    from the JAX op's key; translation at the shifts' extremes too."""
    x = _images(8, seed=1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.diff_augment(key, jnp.asarray(x), policy=(op,)))
    draws = jax_augment_draws(key, 8, H, W, (op,))
    got = nhwc(diff_augment(nchw(x), draws))
    np.testing.assert_allclose(got, want, **TOL_AUG)


def test_translation_wraps_modulo_w_minus_1():
    """The reference quirk: a shift of 0 maps column W-1 to column 0."""
    x = torch.arange(W, dtype=torch.float32).expand(1, 1, H, W).contiguous()
    draws = [("translation", {"th": torch.tensor([0]), "tw": torch.tensor([0])})]
    y = diff_augment(x, draws)
    assert float(y[0, 0, 0, W - 1]) == 0.0
    assert torch.equal(y[..., :W - 1], x[..., :W - 1])


def test_full_policy_and_its_gradient_match_jax():
    x = _images(4, seed=2)
    key = jax.random.PRNGKey(3)
    cot = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jaug.diff_augment(key, v), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(cot))
    xt = nchw(x).requires_grad_(True)
    got = diff_augment(xt, jax_augment_draws(key, 4, H, W, DEFAULT_POLICY))
    (got_grad,) = torch.autograd.grad(got, xt, nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL_AUG)
    np.testing.assert_allclose(nhwc(got_grad), np.asarray(want_grad), **TOL_AUG)


def test_torch_draws_have_the_jax_ranges():
    g = torch.Generator().manual_seed(0)
    draws = dict(draw_augment(DEFAULT_POLICY, 4096, H, W, g, "cpu"))
    u = draws["brightness"]["u"]
    assert -1.0 <= float(u.min()) < -0.99 and 0.99 < float(u.max()) < 1.0
    t = draws["translation"]
    assert set(t["th"].tolist()) == set(range(-2, 3)) and set(t["tw"].tolist()) == set(range(-4, 5))
    c = draws["cutout"]
    assert set(c["off_h"].tolist()) == set(range(0, H + 1))


def test_equal_lr_conv_scale_is_true_fan_in():
    m = EqualLR(torch.nn.Conv2d(3, 5, (4, 16), bias=True))
    assert m.scale == pytest.approx(1.0 / np.sqrt(3 * 4 * 16))
    with pytest.raises(TypeError):
        EqualLR(torch.nn.Linear(3, 5))


@pytest.fixture(scope="module")
def disc():
    return jax_discriminator((H, W), seed=0)


def test_discriminator_forward_and_input_grad_match_jax(disc):
    D, params = disc
    x = _images(4, seed=5)
    want, vjp = jax.vjp(lambda v: D.apply(params, v), jnp.asarray(x))
    (want_grad,) = vjp(jnp.ones_like(want))
    port = port_discriminator((H, W), params)
    xt = nchw(x).requires_grad_(True)
    got = port(xt)
    (got_grad,) = torch.autograd.grad(got.sum(), xt)
    assert got.shape == (4, 1, 1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy().ravel(), np.asarray(want).ravel(), **TOL_F32)
    np.testing.assert_allclose(nhwc(got_grad), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6 * float(np.abs(want_grad).max()))


def test_discriminator_keys_equal_the_jax_export(disc):
    _, params = disc
    port = port_discriminator((H, W), params)
    assert list(port.state_dict()) == list(te.discriminator_state_dict(params))


def test_define_d_loads_strictly(disc):
    _, params = disc
    cfg = compose(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs"), ["model=dusty2_dcgan_eqlr", "model.dis.ch_base=8",
                              "model.dis.ch_max=16"])
    cfg.model.dis.shape = [H, W]
    D = define_D(cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in te.discriminator_state_dict(params).items()}
    D.load_state_dict(sd, strict=True)
    x = nchw(_images(2, seed=6))
    np.testing.assert_array_equal(D(x).detach().numpy(),
                                  port_discriminator((H, W), params)(x).detach().numpy())


def test_far_field_moves_the_bf16_logit():
    """Under the bf16 policy D's logit still moves when only far-field
    pixels move: a 110 m return (-0.9985) against a dropped pixel (-1.0) is
    inside bf16's half-ulp of -1, so only the float32 input boundary and
    float32 logit keep it; the same images cast to bf16 first are blind."""
    D = define_D({"model": {"dis": {"arch": "dcgan_eqlr", "in_ch": 1, "ch_base": 64,
                                    "ch_max": 512, "shape": [64, 256]}}})
    x0 = torch.full((1, 1, 64, 256), -1.0)
    x1 = x0.clone()
    x1[0, 0, 10:20, 50:200] = -0.9985
    with torch.no_grad():
        y0, y1 = D(x0, torch.bfloat16), D(x1, torch.bfloat16)
        q0 = D(x0.bfloat16(), torch.bfloat16)
        q1 = D(x1.bfloat16(), torch.bfloat16)
    assert float((y1 - y0).abs().max()) > 0.0
    assert float((q1 - q0).abs().max()) == 0.0
