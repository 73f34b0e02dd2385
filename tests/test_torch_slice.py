"""The synthesis-evaluation slice as a whole: the same generator weights, z,
fixed Gumbel noise, real scans and SWD draws through the JAX pipeline
(make_eval_generator -> to_pts -> score, as dusty_gan_tpu/cli/
evaluate_synthesis.py runs them) and through dusty_gan_torch's, compared
score by score, with COV/MMD/1-NNA over CD and EMD (``--metrics cd,emd``).
Float32 generators on both sides.  SWD, JSD, MMD and the CD- and EMD-based
rates within rtol 1e-4; COV and 1-NNA counts equal."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.data import datasets as jds
from dusty_gan_tpu.geometry import lidar as jl
from dusty_gan_tpu.metrics.cov_mmd_1nna import compute_cov_mmd_1nna as jax_cov
from dusty_gan_tpu.metrics.fps import downsample_point_clouds as jax_downsample
from dusty_gan_tpu.metrics.jsd import compute_jsd as jax_jsd
from dusty_gan_tpu.metrics.swd import compute_swd as jax_swd
from dusty_gan_tpu.utils.setup import make_eval_generator as jax_make_eval_generator

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.cli import evaluate_synthesis as es
from dusty_gan_torch.data import datasets as tds
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry import lidar as tl
from dusty_gan_torch.utils.setup import make_eval_generator

from tests.torch_parity import (IN_CH, JaxDraws, jax_generator, logistic, nchw,
                                port_generator)

ARCH = "dusty2/dcgan_eqlr"
SHAPE = (64, 256)
B, NUM_POINTS, CD_BATCH, DROP = 4, 128, 3, -1.0
METRICS = ("cd", "emd")
COUNT_KEYS = tuple(f"{k}-{m}" for m in METRICS for k in (
    "cov", "1-nn-tp", "1-nn-fp", "1-nn-fn", "1-nn-tn", "1-nn-accuracy",
    "1-nn-accuracy_t", "1-nn-accuracy_f", "1-nn-precision", "1-nn-recall"))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    root = build_synthetic_kitti(str(tmp_path_factory.mktemp("slice")),
                                 n_scans_per_seq=B, w0=512, sequences=(11,))
    angles = np.load(osp.join(root, "angles.npy"))
    rng = np.random.RandomState(0)
    z = rng.randn(B, IN_CH).astype(np.float32)
    pix, img = logistic(rng, (1,) + SHAPE + (1,)), logistic(rng, (1, 1, 1, 1))
    Gj, params = jax_generator(ARCH, SHAPE)
    Gt = port_generator(ARCH, SHAPE, params).requires_grad_(False)  # as setup returns it
    key = jax.random.PRNGKey(0)

    # ---- JAX package
    jlid = jl.Lidar.from_angle_array(angles, SHAPE, 0.9, 120.0)
    js = jds.KITTIOdometry(root, "test", shape=SHAPE)
    depth = jnp.asarray(np.stack([js.item(i)["depth"] for i in range(B)]))
    mask = jnp.asarray(np.stack([js.item(i)["mask"] for i in range(B)]))
    inv = jl.sigmoid_to_tanh(jlid.invert_depth(depth))
    ref_2d_j = mask * inv + (1 - mask) * DROP

    def to_pts(inv, tol):
        xyz = jlid.inv_to_xyz(jnp.clip(jl.tanh_to_sigmoid(inv), 0.0, 1.0), tol)
        return jax_downsample(xyz.reshape(xyz.shape[0], -1, 3), NUM_POINTS)

    gen_j = jax_make_eval_generator(
        Gj, params, {"pixel": jnp.asarray(pix), "image": jnp.asarray(img)},
        compute_dtype=None)
    fake_2d_j = gen_j(jnp.asarray(z))["depth"]
    ref_3d_j, fake_3d_j = to_pts(ref_2d_j, es.REAL_TOL), to_pts(fake_2d_j, 0.0)
    scores_j = dict(jax_swd(fake_2d_j, ref_2d_j, key=key))
    scores_j["jsd"] = jax_jsd(fake_3d_j / 2.0, ref_3d_j / 2.0)
    scores_j.update(jax_cov(fake_3d_j, ref_3d_j, CD_BATCH, METRICS))

    # ---- port
    tlid = tl.Lidar.from_angle_array(angles, SHAPE, 0.9, 120.0)
    ts = tds.KITTIOdometry(root, "test", shape=SHAPE)
    depth = torch.from_numpy(np.stack([ts.item(i)["depth"] for i in range(B)]))
    mask = torch.from_numpy(np.stack([ts.item(i)["mask"] for i in range(B)]))
    inv = tl.sigmoid_to_tanh(tlid.invert_depth(depth))
    ref_2d_t = mask * inv + (1 - mask) * DROP
    gen_t = make_eval_generator(Gt, {"pixel": nchw(pix), "image": nchw(img)},
                                compute_dtype=None)
    fake_2d_t = gen_t(torch.from_numpy(z))["depth"]
    ref_3d_t = es.to_points(tlid, ref_2d_t, es.REAL_TOL, NUM_POINTS)
    fake_3d_t = es.to_points(tlid, fake_2d_t, 0.0, NUM_POINTS)
    scores_t = es.score(fake_2d_t, fake_3d_t, ref_2d_t, ref_3d_t, CD_BATCH,
                        draws=JaxDraws(key), metrics=METRICS)
    return {
        "jax": dict(ref_2d=ref_2d_j, fake_2d=fake_2d_j, ref_3d=ref_3d_j,
                    fake_3d=fake_3d_j, scores=scores_j),
        "torch": dict(ref_2d=ref_2d_t, fake_2d=fake_2d_t, ref_3d=ref_3d_t,
                      fake_3d=fake_3d_t, scores=scores_t),
    }


# generated images pass five float32 convolution layers whose sums run in
# other orders on each side: 1.5e-5 absolute seen at 64x256
@pytest.mark.parametrize("name,tol", [
    ("ref_2d", dict(rtol=1e-5, atol=1e-6)), ("ref_3d", dict(rtol=1e-5, atol=1e-6)),
    ("fake_2d", dict(rtol=1e-4, atol=1e-5)), ("fake_3d", dict(rtol=1e-4, atol=1e-5)),
])
def test_intermediates(pipelines, name, tol):
    """Images and FPS clouds (the FPS picks are the same points)."""
    want = np.asarray(pipelines["jax"][name])
    got = pipelines["torch"][name].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def test_fake_images_have_drops(pipelines):
    fake = pipelines["torch"]["fake_2d"].numpy()
    assert 0.0 < np.mean(fake == DROP) < 1.0


def test_scores_key_by_key(pipelines):
    want, got = pipelines["jax"]["scores"], pipelines["torch"]["scores"]
    assert set(got) == set(want)
    for k in sorted(want):
        if k in COUNT_KEYS:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
