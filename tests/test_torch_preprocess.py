"""KITTI preprocessing and point re-projection against the JAX package, on
the CPU, on scans the test writes.

* ``project_scan``: native, numpy and the JAX package's (its native path)
  bit for bit.
* ``compute_avg_angles`` bit for bit (the same float64 operations).
* ``process_kitti_root`` serial and on a pool of 2 against the JAX
  package's serial build: every ``.npy`` bit for bit, the label PNGs with
  the same palette and pixel for pixel wherever the JAX package's label
  grid shows its own image's point (``_hold_labels``), ``angles.npy`` bit
  for bit serial and within 1e-7 rad on the pool (float64 shard sums
  reassociate), and
  ``angles.pt`` equal to ``angles.npy``.
* ``Lidar.points_to_depth``: value within atol 1e-6 and its gradient for
  ``xyz`` within rtol 1e-5 / atol 1e-5 of ``jax.grad``'s (the splat sums
  duplicates in another order); validity equal; every chunk size gives the
  same image bit for bit; ``bilinear_rasterizer`` within atol 1e-6."""

import os
import os.path as osp
from glob import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dusty_gan_tpu.data import native as jax_native
from dusty_gan_tpu.data import preprocess as jp
from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.geometry.render import bilinear_rasterizer as jax_rasterizer

from dusty_gan_torch.cli.process_kitti import main as process_kitti_main
from dusty_gan_torch.data import preprocess as tp
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.geometry.render import bilinear_rasterizer


def velodyne_scan(seed: int, rings: int = 16, per_ring: int = 700) -> np.ndarray:
    """A raw (N, 4) stream: ``rings`` counterclockwise revolutions, ranges
    2-80 m, a few points at the origin and a few exact duplicates."""
    rng = np.random.RandomState(seed)
    th = np.sort(rng.uniform(0.0, 2 * np.pi, per_ring))
    out = []
    for ring in range(rings):
        r = rng.uniform(2, 80, per_ring)
        z = (-0.4 + 0.42 * ring / rings) * r
        out.append(np.stack([r * np.cos(th), r * np.sin(th), z, rng.uniform(size=per_ring)], -1))
    pts = np.concatenate(out).astype(np.float32)
    pts[rng.choice(len(pts), 5, replace=False)] = 0
    dup = rng.choice(len(pts), 5, replace=False)
    pts[dup + 1 - (dup == len(pts) - 1) * 2] = pts[dup]
    return pts


@pytest.mark.parametrize("hw", [(64, 2048), (16, 128), (64, 512)])
@pytest.mark.parametrize("seed", [0, 1])
def test_project_scan_native_numpy_and_jax_agree(hw, seed):
    assert jax_native.available()
    pts = velodyne_scan(seed)
    got = tp.project_scan(pts, *hw)
    np.testing.assert_array_equal(got, tp.project_scan(pts, *hw, native=False))
    np.testing.assert_array_equal(got, jp.project_scan(pts, *hw))
    assert got.shape == hw + (4,) and (got[..., 0] != 0).mean() > 0.05


def test_project_scan_empty():
    for native in (True, False):
        out = tp.project_scan(np.zeros((0, 4), np.float32), 4, 8, native=native)
        assert out.shape == (4, 8, 4) and not out.any()


def test_compute_avg_angles_equals_jax():
    scans = [tp.project_scan(velodyne_scan(s), 16, 128) for s in range(4)]
    scans[0][:, :5] = 0  # columns never valid: filled from the column mean
    scans[1][2] *= 500  # a row beyond max_depth in one scan
    got = tp.compute_avg_angles(iter(scans))
    want = jp.compute_avg_angles(iter(scans))
    assert got.shape == (2, 16, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _kitti_tree(base, seqs=(0, 8, 11), per_seq=3, labels=True):
    for s in seqs:
        d = osp.join(base, "dataset", "sequences", f"{s:02d}")
        os.makedirs(osp.join(d, "velodyne"))
        os.makedirs(osp.join(d, "labels"))
        for i in range(per_seq):
            pts = velodyne_scan(100 * s + i, rings=16, per_ring=400)
            pts.tofile(osp.join(d, "velodyne", f"{i:06d}.bin"))
            if labels and i == 0:
                ids = np.array(list(tp.SEMANTIC_KITTI_LABELMAP), np.int32)
                lab = ids[np.random.RandomState(i).randint(0, len(ids), len(pts))]
                (lab | (7 << 16)).astype(np.int32).tofile(
                    osp.join(d, "labels", f"{i:06d}.label"))
    return str(base)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    root = _kitti_tree(tmp_path_factory.mktemp("jax_kitti"))
    jp.process_kitti_root(root, 16, 128, verbose=False, n_jobs=1)
    return root


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_process_kitti_root_equals_jax(jax_tree, tmp_path, n_jobs):
    root = _kitti_tree(tmp_path)
    if n_jobs == 1:
        angles = process_kitti_main(["--root-dir", root, "--height", "16", "--width", "128",
                                     "--n-jobs", "1"])
    else:
        angles = tp.process_kitti_root(root, 16, 128, verbose=False, n_jobs=n_jobs)
    rel = lambda p: osp.relpath(p, root)  # noqa: E731
    got = sorted(glob(osp.join(root, "dusty-gan", "**", "*.*"), recursive=True))
    want = sorted(glob(osp.join(jax_tree, "dusty-gan", "**", "*.*"), recursive=True))
    assert [rel(p) for p in got] == [osp.relpath(p, jax_tree) for p in want]
    assert sum(p.endswith(".png") for p in got) == 3 and len(got) == 12
    for a, b in zip(got, want):
        if a.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=rel(a))
        else:
            ia, ib = Image.open(a), Image.open(b)
            assert ia.mode == ib.mode == "P" and ia.getpalette() == ib.getpalette()
            _hold_labels(np.asarray(ia), np.asarray(ib), root, rel(a))
    want_angles = np.load(osp.join(jax_tree, "angles.npy"))
    np.testing.assert_array_equal(np.load(osp.join(root, "angles.npy")), angles)
    np.testing.assert_array_equal(torch.load(osp.join(root, "angles.pt")).numpy(), angles)
    if n_jobs == 1:
        np.testing.assert_array_equal(angles, want_angles)
    else:
        np.testing.assert_allclose(angles, want_angles, rtol=0, atol=1e-7)


def _winners(grid_h, grid_w, order, h, w):
    """Index of the point each pixel shows (-1: none): the last write."""
    win = np.full((h, w), -1)
    win[grid_h[order], grid_w[order]] = order
    return win


def _hold_labels(got, want, root, rel_png):
    """The port labels each pixel with the point its range image shows.  The
    JAX package forms its label grid apart from its image (an unstable sort
    and numpy's arctan2), so at an exact depth tie or a column edge its
    label may come from another point than its own image's: outside those
    pixels the two PNGs are equal, and on them the port's label is the
    image's point's."""
    bin_path = osp.join(root, rel_png.replace("dusty-gan", "dataset")
                        .replace("labels", "velodyne").replace(".png", ".bin"))
    pts = np.fromfile(bin_path, np.float32).reshape(-1, 4)
    lab = np.fromfile(bin_path.replace("velodyne", "labels").replace(".bin", ".label"),
                      np.int32) & 0xFFFF
    lab = np.vectorize(tp.SEMANTIC_KITTI_LABELMAP.__getitem__)(lab)
    h, w = got.shape
    ours = _winners(*tp.project_grid(pts, h, w), h, w)
    theirs = _winners(*jp._project_grid(pts, h, w), h, w)
    apart = ours != theirs
    np.testing.assert_array_equal(got[~apart], want[~apart], err_msg=rel_png)
    np.testing.assert_array_equal(got[ours >= 0], lab[ours[ours >= 0]], err_msg=rel_png)
    image = tp.project_scan(pts, h, w)
    np.testing.assert_array_equal(image[ours >= 0], pts[ours[ours >= 0]])
    assert apart.sum() <= 3


def _grid(h, w):
    pitch = np.radians(np.linspace(2.0, -24.8, h))[:, None] * np.ones((1, w))
    yaw = np.linspace(np.pi, -np.pi, w, endpoint=False)[None, :] * np.ones((h, 1))
    return np.stack([pitch, yaw]).astype(np.float32)


def _points(rng, b, n, pitch_rows):
    d = rng.uniform(0.5, 110, (b, n)) / 120.0
    p = pitch_rows[rng.randint(0, len(pitch_rows), (b, n))] + rng.normal(0, 0.005, (b, n))
    y = rng.uniform(-np.pi, np.pi, (b, n))
    return np.stack([d * np.cos(p) * np.cos(y), d * np.cos(p) * np.sin(y),
                     d * np.sin(p)], -1).astype(np.float32)


@pytest.mark.parametrize("hw,n", [((16, 64), 300), ((32, 256), 2000)])
def test_points_to_depth_value_and_gradient_equal_jax(hw, n):
    rng = np.random.RandomState(0)
    ang = _grid(*hw)
    jl = JaxLidar.from_angle_array(ang, hw, 0.9, 120.0)
    tl = Lidar.from_angle_array(ang, hw, 0.9, 120.0)
    pts = _points(rng, 2, n, ang[0, :, 0])
    wts = rng.randn(2, *hw, 1).astype(np.float32)
    jd, jv = jl.points_to_depth(jnp.asarray(pts), chunk=500)
    jg = jax.grad(lambda x: (jl.points_to_depth(x, chunk=500)[0] * wts).sum())(
        jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_()
    td, tv = tl.points_to_depth(x, chunk=500)
    (td * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0.05 < tv.float().mean() < 0.95
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    assert float(x.grad.abs().max()) > 1e-2


def test_points_to_depth_is_chunk_invariant():
    rng = np.random.RandomState(1)
    hw = (16, 64)
    ang = _grid(*hw)
    ang[:, 3, 7] = ang[:, 3, 8]  # a tie between grid angles inside a chunk
    ang[:, 9, 0] = ang[:, 2, 5]  # and across chunks
    tl = Lidar.from_angle_array(ang, hw, 0.9, 120.0)
    pts = torch.from_numpy(_points(rng, 2, 400, ang[0, :, 0]))
    # points on the tied angles, and on the grid's first and last
    on_grid = np.stack([ang[:, 3, 7], ang[:, 2, 5], ang[:, 0, 0], ang[:, 15, 63]])
    p, y = on_grid[:, 0], on_grid[:, 1]
    pts[0, :4] = torch.from_numpy(0.3 * np.stack(
        [np.cos(p) * np.cos(y), np.cos(p) * np.sin(y), np.sin(p)], -1).astype(np.float32))
    want_ids = None
    want = tl.points_to_depth(pts, chunk=hw[0] * hw[1])
    for chunk in (1, 7, 64, 100, 1023):
        got = tl.points_to_depth(pts, chunk=chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), chunk
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        ids = tl.nearest_angle(torch.atan2(z, torch.sqrt(x ** 2 + y ** 2 + 1e-24)),
                               torch.atan2(y, x), chunk)
        if want_ids is None:
            want_ids = ids
        assert torch.equal(ids, want_ids), chunk
    # ties go to the first occurrence: the earlier of two equal grid angles
    assert int(want_ids[0, 0]) == 3 * 64 + 7 and int(want_ids[0, 1]) == 2 * 64 + 5


def test_bilinear_rasterizer_equals_jax():
    rng = np.random.RandomState(2)
    coords = rng.uniform(-1.5, 17.5, (2, 500, 2)).astype(np.float32)
    coords[0, :10] = np.floor(coords[0, :10])  # on the grid: weights of exactly 0 and 1
    values = rng.randn(2, 500, 3).astype(np.float32)
    got = bilinear_rasterizer(torch.from_numpy(coords), torch.from_numpy(values), (16, 16))
    want = jax_rasterizer(jnp.asarray(coords), jnp.asarray(values), (16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
