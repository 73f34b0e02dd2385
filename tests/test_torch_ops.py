"""dusty_gan_torch ops against the JAX package on the same numpy inputs:
ring padding, FusedLeakyReLU, equalized-LR ConvT and latent projection,
Gumbel-sigmoid.  Float32 throughout; tolerance rtol 1e-5 / atol 1e-6
(different convolution algorithms sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.ops import activation as jact
from dusty_gan_tpu.ops import gumbel as jgum
from dusty_gan_tpu.ops import linear as jlin
from dusty_gan_tpu.ops import padding as jpad

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.ops.activation import FusedLeakyReLU, fused_leaky_relu
from dusty_gan_torch.ops.gumbel import gumbel_sigmoid, logistic_noise
from dusty_gan_torch.ops.linear import equal_lr_convt, equal_lr_proj
from dusty_gan_torch.ops.padding import pad_ring

from tests.torch_parity import TOL_F32, logistic, nchw, nhwc


@pytest.mark.parametrize("padding", [1, (2, 1, 1, 2), (0, 0, 2, 1), (3, 2, 0, 0)])
@pytest.mark.parametrize("vertical", ["reflect", "constant", "replicate"])
@pytest.mark.parametrize("horizontal", ["circular", "reflect"])
def test_pad_ring(padding, vertical, horizontal):
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jpad.pad_ring(jnp.asarray(x), padding, horizontal, vertical))
    got = nhwc(pad_ring(nchw(x), padding, horizontal, vertical))
    np.testing.assert_array_equal(got, want)


def test_fused_leaky_relu():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jact.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    m = FusedLeakyReLU(5)
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(b))
        got = nhwc(m(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL_F32)
    # no bias: the activation alone
    want = np.asarray(jact.fused_leaky_relu(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(fused_leaky_relu(nchw(x))), want, **TOL_F32)


@pytest.mark.parametrize("bias", [False, True])
def test_equal_lr_convt(bias):
    """k4 s2 p3 ConvT after a ring pad, the Up/Head block of G; the
    fan-in quirk scales by 1/sqrt(O*kh*kw)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 8, 6).astype(np.float32)
    mod = jlin.EqualLRConvTranspose(3, (4, 4), (2, 2), (3, 3), use_bias=bias)
    xp = jpad.pad_ring(jnp.asarray(x), 1)
    params = mod.init(jax.random.PRNGKey(0), xp)
    if bias:
        params = {"params": {"kernel": params["params"]["kernel"],
                             "bias": jnp.asarray(rng.randn(3).astype(np.float32))}}
    want = np.asarray(mod.apply(params, xp))
    m = equal_lr_convt(6, 3, 4, 2, 3, bias=bias)
    with torch.no_grad():
        k = np.asarray(params["params"]["kernel"])  # (kh, kw, I, O)
        m.module.weight.copy_(torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()))
        if bias:
            m.module.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        got = nhwc(m(pad_ring(nchw(x), 1)))
    assert got.shape == (2, 8, 16, 3)
    np.testing.assert_allclose(got, want, **TOL_F32)


def test_equal_lr_proj():
    rng = np.random.RandomState(3)
    z = rng.randn(3, 16).astype(np.float32)
    mod = jlin.EqualLRProj(8, (4, 16))
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(z))
    want = np.asarray(mod.apply(params, jnp.asarray(z)))
    m = equal_lr_proj(16, 8, (4, 16))
    with torch.no_grad():
        k = np.asarray(params["params"]["kernel"])  # (h0, w0, I, O)
        m.module.weight.copy_(torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()))
        got = nhwc(m(torch.from_numpy(z)[:, :, None, None]))
    assert got.shape == (3, 4, 16, 8)
    np.testing.assert_allclose(got, want, **TOL_F32)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("tau", [1.0, 0.5, None])
def test_gumbel_sigmoid_same_noise(tau, threshold):
    """Same logits and noise -> the same straight-through values,
    bit for bit (hard - soft + soft keeps its 1 +- ulp)."""
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(2, 6, 10, 1)).astype(np.float32)
    noise = logistic(rng, (2, 6, 10, 1))
    inv_tau = None if tau is not None else jnp.float32(1.3)
    want = np.asarray(jgum.gumbel_sigmoid(jnp.asarray(logits), jnp.asarray(noise),
                                          tau=tau, inverse_tau=inv_tau,
                                          threshold=threshold))
    got = nhwc(gumbel_sigmoid(nchw(logits), nchw(noise), tau=tau,
                              inverse_tau=None if tau is not None else torch.tensor(1.3),
                              threshold=threshold))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(np.round(got, 3))) <= {0.0, 1.0}


def test_logistic_noise_shapes_and_law():
    g = torch.Generator().manual_seed(0)
    pix = logistic_noise(g, 2, (8, 16), pixelwise=True)
    img = logistic_noise(g, 3, (8, 16), pixelwise=False)
    assert pix.shape == (2, 1, 8, 16) and img.shape == (3, 1, 1, 1)
    big = logistic_noise(g, 1, (256, 256))
    # a standard logistic variable has mean 0 and variance pi^2 / 3
    assert abs(float(big.mean())) < 0.05
    assert abs(float(big.var()) - np.pi ** 2 / 3) < 0.15
