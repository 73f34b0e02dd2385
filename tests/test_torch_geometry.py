"""dusty_gan_torch LiDAR geometry and data pipeline against the JAX package
on the same numpy inputs.  Float32; rtol 1e-5 / atol 1e-6 where trig or
resampling is involved, exact where the arithmetic is the same."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.data import datasets as jds
from dusty_gan_tpu.data.loader import Loader as JaxLoader
from dusty_gan_tpu.data.synthetic import build_synthetic_kitti as jax_build
from dusty_gan_tpu.geometry import lidar as jl

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.data import datasets as tds
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry import lidar as tl

from tests.torch_parity import TOL_F32


def _angles(h0, w0, seed=0):
    """A smooth random (2, h0, w0) angle grid around a KITTI-like layout."""
    rng = np.random.RandomState(seed)
    pitch = np.radians(np.linspace(2.0, -24.8, h0))[:, None] * np.ones((1, w0))
    yaw = np.linspace(np.pi, -np.pi, w0, endpoint=False)[None, :] * np.ones((h0, 1))
    wobble = 1e-3 * np.cumsum(rng.randn(h0, w0), axis=1) / np.sqrt(w0)
    return np.stack([pitch + wobble, yaw + wobble], 0).astype(np.float32)


@pytest.mark.parametrize("src,dst", [((64, 512), (64, 256)), ((64, 256), (64, 256)),
                                     ((32, 100), (64, 256)), ((64, 2048), (64, 256))])
def test_angle_grid_resize(src, dst):
    """Antialiased bilinear on shrink, plain bilinear on growth: the same
    grid as jax.image.resize."""
    a = _angles(*src)
    want = np.asarray(jl.Lidar.from_angle_array(a, dst, 0.9, 120.0).angle)
    got = tl.Lidar.from_angle_array(a, dst, 0.9, 120.0).angle.numpy()
    assert got.shape == dst + (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_bilinear_would_differ():
    """Why the port antialiases: on the synthetic KITTI grid shrunk
    64x2048 -> 64x256, plain align_corners=False bilinear is 2.4e-3 rad off
    the JAX package's grid, the antialiased one 7e-7."""
    import torch.nn.functional as F

    from dusty_gan_torch.data.synthetic import _ray_grids

    a = np.stack(_ray_grids(64, 2048)[:2]).astype(np.float32)
    want = np.asarray(jl.Lidar.from_angle_array(a, (64, 256), 0.9, 120.0).angle)
    plain = F.interpolate(torch.from_numpy(a)[None], size=(64, 256), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(plain - want).max() > 1e-3
    got = tl.Lidar.from_angle_array(a, (64, 256), 0.9, 120.0).angle.numpy()
    assert np.abs(got - want).max() < 1e-6


def test_angle_file_npy_and_pt(tmp_path):
    a = _angles(8, 32)
    np.save(tmp_path / "angles.npy", a)
    torch.save(torch.from_numpy(a), tmp_path / "angles.pt")
    for name in ("angles.npy", "angles.pt"):
        got = tl.Lidar.from_angle_file(str(tmp_path / name), (8, 16), 0.9, 120.0)
        want = jl.Lidar.from_angle_array(a, (8, 16), 0.9, 120.0)
        np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), **TOL_F32)


@pytest.mark.parametrize("tol", [1e-8, 0.008])
def test_depth_maps_and_projection(tol):
    rng = np.random.RandomState(1)
    a = _angles(16, 64)
    jlid = jl.Lidar.from_angle_array(a, (16, 64), 0.9, 120.0)
    tlid = tl.Lidar.from_angle_array(a, (16, 64), 0.9, 120.0)
    depth = rng.uniform(0, 1, (3, 16, 64, 1)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    inv_j = jlid.invert_depth(jnp.asarray(depth))
    inv_t = tlid.invert_depth(torch.from_numpy(depth))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), **TOL_F32)
    np.testing.assert_allclose(tlid.revert_depth(inv_t).numpy(),
                               np.asarray(jlid.revert_depth(inv_j)), **TOL_F32)
    np.testing.assert_allclose(tlid.revert_depth(inv_t, norm=False).numpy(),
                               np.asarray(jlid.revert_depth(inv_j, norm=False)),
                               **TOL_F32)
    inv01 = np.clip(rng.uniform(-0.1, 1.0, depth.shape), 0, 1).astype(np.float32)
    inv01[depth == 0] = 0.0
    np.testing.assert_allclose(
        tlid.inv_to_xyz(torch.from_numpy(inv01), tol).numpy(),
        np.asarray(jlid.inv_to_xyz(jnp.asarray(inv01), tol)), **TOL_F32)
    np.testing.assert_allclose(
        tlid.pol_to_xyz(torch.from_numpy(depth)).numpy(),
        np.asarray(jlid.pol_to_xyz(jnp.asarray(depth))), **TOL_F32)
    x = rng.uniform(-1, 1, (5,)).astype(np.float32)
    np.testing.assert_array_equal(tl.sigmoid_to_tanh(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.sigmoid_to_tanh(jnp.asarray(x))))
    np.testing.assert_array_equal(tl.tanh_to_sigmoid(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.tanh_to_sigmoid(jnp.asarray(x))))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic KITTI tree written by both packages."""
    a = str(tmp_path_factory.mktemp("torch_tree"))
    b = str(tmp_path_factory.mktemp("jax_tree"))
    build_synthetic_kitti(a, n_scans_per_seq=5, w0=512, seed=3)
    jax_build(b, n_scans_per_seq=5, w0=512, seed=3)
    return a, b


def test_synthetic_tree_identical(trees):
    a, b = trees
    ta = tds.KITTIOdometry(a, "test")
    jb = jds.KITTIOdometry(b, "test")
    assert len(ta) == len(jb) == 5
    for pa, pb in zip(ta.datalist, jb.datalist):
        np.testing.assert_array_equal(np.load(pa), np.load(pb))
    np.testing.assert_array_equal(np.load(f"{a}/angles.npy"), np.load(f"{b}/angles.npy"))


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("flip", [False, True])
def test_dataset_items(trees, split, flip):
    """The numpy value pipeline gives the JAX package's items (its native
    fast path is bit-equivalent to its numpy path)."""
    root = trees[0]
    ts = tds.KITTIOdometry(root, split, shape=(64, 256))
    js = jds.KITTIOdometry(root, split, shape=(64, 256))
    assert ts.datalist == js.datalist and len(ts) == 5
    for i in range(len(ts)):
        got, want = ts.item(i, flip=flip), js.item(i, flip=flip)
        for k in ("depth", "mask", "xyz"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(got["mask"], want["mask"])


def test_define_dataset_and_sequential_loader(trees):
    cfg = {"name": "kitti_odometry", "root": trees[0], "shape": [64, 256],
           "min_depth": 0.9, "max_depth": 120.0, "flip": True}
    ts = tds.define_dataset(cfg, "train")
    js = jds.define_dataset(cfg, "train")
    assert ts.datalist == js.datalist
    assert tds.define_dataset(cfg, "test").datalist == jds.define_dataset(cfg, "test").datalist
    got = list(Loader(ts, batch_size=2).epoch())
    # the train split draws its flips from the same per-item streams in both
    want = list(JaxLoader(js, batch_size=2, shuffle=False, drop_last=False).epoch(0))
    assert len(got) == len(want) == 3 and len(Loader(ts, 2)) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["depth"], w["depth"], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g["mask"], w["mask"])
