"""dusty_gan_torch.metrics.chamfer_cuda's nearest-neighbour functions (the
plain versions of kernels K2 and K3) and dusty_gan_torch.metrics.chamfer
against the JAX package on the CPU.

* ``nn_reference`` is held against ``nn_pallas(..., interpret=True)``, the
  TPU kernel run in interpret mode, which forms distances from explicit
  coordinate differences as the port does: distances within rtol 1e-5 /
  atol 1e-6 (the sums run in other orders), indices exactly equal, also on
  clouds with many duplicate points at the origin and duplicated partner
  points, where the first occurrence of a tied minimum must win.
* ``chamfer_distance``, its gradients and ``compute_cd`` are held against
  the JAX functions, which on the CPU compute distances as
  x^2 + y^2 - 2xy (``_nn_chunked``): on unit-scale clouds that loses up to
  a few 1e-7 absolute to cancellation, so values and gradients are held
  within atol 1e-5 / rtol 1e-4, on clouds without ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.metrics import chamfer as jax_chamfer
from dusty_gan_tpu.metrics.chamfer_pallas import nn_pallas

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch import kernels
from dusty_gan_torch.metrics import chamfer_cuda
from dusty_gan_torch.metrics.chamfer import (chamfer_distance, chamfer_distance_eval,
                                             compute_cd)
from dusty_gan_torch.metrics.chamfer_cuda import nn_argmin, nn_dist, nn_reference

TOL_NN = dict(rtol=1e-5, atol=1e-6)
TOL_XLA = dict(rtol=1e-4, atol=1e-5)


def _clouds(seed, b, n, origin=0.0, dup=0.0):
    """Unit-scale clouds; a share ``origin`` of the points sits exactly at
    the origin and a share ``dup`` repeats an earlier point of its cloud."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    p[rng.uniform(size=(b, n)) < origin] = 0.0
    if dup:
        for i in range(b):
            src = rng.randint(0, n // 2, int(dup * n))
            dst = rng.randint(n // 2, n, int(dup * n))
            p[i, dst] = p[i, src]
    return p


def _near_origin(seed, b, n):
    """Query clouds close to the origin, so that the duplicated origin points
    of the partner cloud are often the nearest."""
    return (0.05 * _clouds(seed, b, n)).astype(np.float32)


CASES = {
    "ragged": lambda: (_clouds(0, 2, 100), _clouds(1, 2, 77)),
    "n_ne_m": lambda: (_clouds(2, 3, 300), _clouds(3, 3, 1000)),
    "m_over_4096": lambda: (_clouds(4, 1, 64), _clouds(5, 1, 9000)),
    "duplicates_at_origin": lambda: (
        np.concatenate([_near_origin(6, 2, 200), _clouds(7, 2, 200, origin=0.3)], axis=1),
        _clouds(8, 2, 5000, origin=0.3, dup=0.1)),
}


@pytest.mark.parametrize("need_idx", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nn_reference_matches_pallas_interpret(case, need_idx):
    x, y = CASES[case]()
    want_d, want_i = nn_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True,
                               need_idx=need_idx)
    got_d, got_i = nn_reference(torch.from_numpy(x), torch.from_numpy(y), need_idx)
    assert got_d.shape == x.shape[:2] and got_d.dtype == torch.float32
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL_NN)
    if need_idx:
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        assert got_i is None


def test_duplicate_case_has_ties():
    """The duplicate case really exercises the tie rule: many queries have
    a tied minimum, and the first occurrence is not always the only one."""
    x, y = CASES["duplicates_at_origin"]()
    d = ((x[:, :, None].astype(np.float64) - y[:, None].astype(np.float64)) ** 2).sum(-1)
    ties = (d == d.min(axis=2, keepdims=True)).sum(axis=2)
    assert (ties > 1).mean() > 0.2


def test_nn_reference_chunks(monkeypatch):
    """A small distance budget splits both the batch and M; the result,
    indices included, equals the unchunked one."""
    x, y = (torch.from_numpy(a) for a in CASES["duplicates_at_origin"]())
    full_d, full_i = nn_reference(x, y)
    monkeypatch.setattr(chamfer_cuda, "_REFERENCE_BUDGET", 400 * 700)
    d, i = nn_reference(x, y)
    np.testing.assert_array_equal(d.numpy(), full_d.numpy())
    np.testing.assert_array_equal(i.numpy(), full_i.numpy())


def test_wrappers_on_cpu_use_plain_version():
    x, y = (torch.from_numpy(a) for a in CASES["ragged"]())
    before = (nn_dist.launches, nn_argmin.launches)
    want_d, want_i = nn_reference(x, y)
    np.testing.assert_array_equal(nn_dist(x, y).numpy(), want_d.numpy())
    d, i = nn_argmin(x, y)
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    assert (nn_dist.launches, nn_argmin.launches) == before  # no kernel on the CPU


@pytest.mark.parametrize("fn", [nn_dist, nn_argmin])
def test_wrappers_never_fall_back_off_the_cpu(fn):
    """A tensor that is not on the CPU never takes the plain version: here a
    meta tensor, which is neither CPU nor CUDA, raises."""
    x = torch.empty((2, 10, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(x, x)


@pytest.mark.parametrize("bad", [
    lambda a, b: (a.double(), b.double()),
    lambda a, b: (a[..., :2], b[..., :2]),
    lambda a, b: (a[0], b[0]),
    lambda a, b: (a[:1], b),        # batch sizes differ
    lambda a, b: (a[:, :0], b),
    lambda a, b: (a, b[:, :0]),
])
@pytest.mark.parametrize("fn", [nn_dist, nn_argmin])
def test_wrappers_reject_bad_inputs(fn, bad):
    a, b = torch.from_numpy(_clouds(11, 2, 8)), torch.from_numpy(_clouds(12, 2, 9))
    with pytest.raises((ValueError, TypeError)):
        fn(*bad(a, b))


def test_nn_library_is_declared():
    assert set(kernels.SIGNATURES["nn"]) == {"nn_dist_launch", "nn_argmin_launch",
                                            "nn_count_launch", "nn_points_per_thread",
                                            "nn_error_string"}
    assert kernels.library_path("nn").name.startswith("libnn-")
    src = (kernels.CSRC / "nn.cu").read_text()
    for fn in kernels.SIGNATURES["nn"]:
        assert f" {fn}(" in src, fn


def _weights(seed, b, n, m):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 1.5, (b, n)).astype(np.float32),
            rng.uniform(0.5, 1.5, (b, m)).astype(np.float32))


@pytest.mark.parametrize("shapes", [((2, 150), (2, 90)), ((3, 64), (3, 200))])
def test_chamfer_distance_and_grads_match_jax(shapes):
    (b, n), (_, m) = shapes
    x, y = _clouds(20 + n, b, n), _clouds(30 + m, b, m)
    w1, w2 = _weights(n + m, b, n, m)

    def jax_loss(xx, yy):
        d1, d2 = jax_chamfer.chamfer_distance(xx, yy)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2), (d1, d2)

    (_, (jd1, jd2)), (jgx, jgy) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                     has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    d1, d2 = chamfer_distance(tx, ty)
    ((d1 * torch.from_numpy(w1)).sum() + (d2 * torch.from_numpy(w2)).sum()).backward()
    np.testing.assert_allclose(d1.detach().numpy(), np.asarray(jd1), **TOL_XLA)
    np.testing.assert_allclose(d2.detach().numpy(), np.asarray(jd2), **TOL_XLA)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL_XLA)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), **TOL_XLA)


def test_chamfer_backward_equals_autograd_of_brute_force():
    """The analytic backward equals autograd through the dense distance
    matrix (same explicit differences, so rtol 1e-5 / atol 1e-6)."""
    x, y = _clouds(40, 2, 120), _clouds(41, 2, 70)
    w1, w2 = (torch.from_numpy(w) for w in _weights(42, 2, 120, 70))
    grads = []
    for analytic in (True, False):
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = torch.from_numpy(y).requires_grad_(True)
        if analytic:
            d1, d2 = chamfer_distance(tx, ty)
        else:
            d = ((tx[:, :, None] - ty[:, None]) ** 2).sum(-1)
            d1, d2 = d.amin(dim=2), d.amin(dim=1)
        ((d1 * w1).sum() + (d2 * w2).sum()).backward()
        grads.append((tx.grad.numpy(), ty.grad.numpy()))
    for got, want in zip(grads[0], grads[1]):
        np.testing.assert_allclose(got, want, **TOL_NN)


def test_chamfer_distance_eval_and_compute_cd_match_jax():
    x, y = _clouds(50, 3, 256), _clouds(51, 3, 300, origin=0.2)
    jd1, jd2 = jax_chamfer.chamfer_distance_eval(jnp.asarray(x), jnp.asarray(y))
    d1, d2 = chamfer_distance_eval(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), **TOL_XLA)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), **TOL_XLA)
    want = np.asarray(jax_chamfer.compute_cd(jnp.asarray(x), jnp.asarray(y)))
    got = compute_cd(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, **TOL_XLA)
