"""Offline KITTI preprocessing (``dusty_gan_tpu/data/preprocess.py``): raw
``.bin`` scans -> (64, 2048, 4) range images, and the dataset-mean angle
grid.

* scan lines by quadrant transitions: the velodyne stream runs
  counterclockwise per revolution, so a jump from the 4th quadrant back to
  the 1st starts a new laser ring;
* yaw binning to W columns;
* painter's order: points sorted far to near (stable), so the nearest
  point wins each pixel;
* the mean per-pixel (pitch, yaw) over the train split, NaN-free by row
  and column means.

``project_scan`` runs the native library (``data/native.py``) unless
``native=False``; the numpy version repeats its float32 operations, and
takes the C library's ``atan2f`` for the points whose column numpy's own
float32 ``arctan2`` (SIMD on some hosts, a few ulps apart) could move, so
the two give the same image bit for bit.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import multiprocessing
import os
import os.path as osp
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from glob import glob

import numpy as np

from dusty_gan_torch import kernels
from dusty_gan_torch.data import native as native_lib
from dusty_gan_torch.utils.video import write_png

TRAIN_SEQUENCES = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
# a point within this many columns of a column edge takes its yaw from the
# C library (numpy's float32 arctan2 and atan2f differ by a few ulps, which
# is < 1e-3 columns at W = 2048)
EDGE_COLUMNS = 1e-2

_libm = None


def _atan2f(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The C library's float32 atan2, element by element."""
    global _libm
    if _libm is None:
        _libm = ctypes.CDLL(ctypes.util.find_library("m"))
        _libm.atan2f.restype = ctypes.c_float
        _libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.array([_libm.atan2f(float(a), float(b)) for a, b in zip(y, x)], np.float32)


def _column_position(yaw: np.ndarray, W: int) -> np.ndarray:
    """u * W of each yaw, u = ((yaw / pi + 1) / 2) mod 1, in float32; its
    floor is the column."""
    u = (yaw / np.float32(np.pi) + np.float32(1)) * np.float32(0.5)
    return (u - np.floor(u)) * np.float32(W)


def project_grid(points: np.ndarray, H: int, W: int):
    """(row, column, painter's order) of each point, as the native library
    forms them."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    depth = np.sqrt(x * x + y * y + z * z)
    order = np.argsort(-depth, kind="stable")  # far first, ties in index order
    quads = np.where(x >= 0, np.where(y >= 0, 0, 3), np.where(y >= 0, 1, 2)).astype(np.int32)
    (starts,) = np.nonzero(np.roll(quads, 1) - quads == 3)  # 4th -> 1st quadrant
    seg = np.searchsorted(starts, np.arange(len(quads)), side="right") - 1
    grid_h = np.clip(np.where(seg < 0, 0, (H - len(starts)) + seg), 0, H - 1)
    pos = _column_position(-np.arctan2(y, x), W)
    edge = np.abs(pos - np.round(pos)) < EDGE_COLUMNS
    if edge.any():
        pos[edge] = _column_position(-_atan2f(y[edge], x[edge]), W)
    grid_w = np.clip(np.floor(pos).astype(np.int64), 0, W - 1)
    return grid_h, grid_w, order


def project_scan(points: np.ndarray, H: int = 64, W: int = 2048,
                 native: bool = True) -> np.ndarray:
    """(N, C >= 3) points -> (H, W, C) float32 range image; the nearest
    point wins each pixel."""
    points = np.ascontiguousarray(points, np.float32)
    if native:
        return native_lib.project_scan(points, H, W)
    grid_h, grid_w, order = project_grid(points, H, W)
    proj = np.zeros((H, W, points.shape[1]), np.float32)
    proj[grid_h[order], grid_w[order]] = points[order]  # the last write, the nearest, wins
    return proj


# SemanticKITTI raw label -> train id
SEMANTIC_KITTI_LABELMAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
# the turbo colour map at the 20 train ids, i / 19, as 8-bit RGB
LABEL_PALETTE = (
    (48, 18, 59), (61, 55, 145), (69, 91, 206), (70, 127, 246), (59, 160, 252),
    (35, 194, 228), (23, 220, 194), (44, 239, 157), (89, 251, 114), (142, 254, 72),
    (179, 248, 53), (214, 229, 53), (239, 205, 57), (252, 174, 52), (252, 137, 38),
    (242, 96, 20), (224, 64, 8), (197, 38, 2), (163, 18, 1), (122, 4, 2),
)


def process_bin_file(point_path: str, save_path: str, H: int = 64, W: int = 2048,
                     label_path: str = None, label_save_path: str = None,
                     native: bool = True) -> np.ndarray:
    """One ``.bin`` scan -> ``save_path`` (.npy); with a SemanticKITTI
    ``.label`` beside it, its train ids on the same grid -> a paletted PNG."""
    points = np.fromfile(point_path, dtype=np.float32).reshape(-1, 4)
    proj = project_scan(points, H, W, native=native)
    os.makedirs(osp.dirname(save_path), exist_ok=True)
    np.save(save_path, proj)
    if label_path and osp.exists(label_path) and label_save_path:
        labels = np.fromfile(label_path, dtype=np.int32) & 0xFFFF
        labels = np.vectorize(SEMANTIC_KITTI_LABELMAP.__getitem__)(labels)
        gh, gw, order = project_grid(points, H, W)
        lab_img = np.zeros((H, W), labels.dtype)
        lab_img[gh[order], gw[order]] = labels[order]
        os.makedirs(osp.dirname(label_save_path), exist_ok=True)
        write_png(label_save_path, lab_img, LABEL_PALETTE)
    return proj


def _nan_mean(arr: np.ndarray, axis: int) -> np.ndarray:
    valid = np.isfinite(arr)
    s = np.where(valid, arr, 0.0).sum(axis=axis, keepdims=True)
    c = valid.sum(axis=axis, keepdims=True)
    return s / np.maximum(c, 1)


def _angle_partials(scan_iter, min_depth: float, max_depth: float):
    """(valid count, pitch sum, yaw sum) per pixel in float64; shards add."""
    total_valid = sum_pitch = sum_yaw = None
    for xyz in scan_iter:
        xyz = np.asarray(xyz, np.float64)
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        depth = np.sqrt(x ** 2 + y ** 2 + z ** 2)
        valid = ((depth > min_depth) & (depth < max_depth)).astype(np.float64)
        pitch = np.arctan2(z, np.sqrt(x ** 2 + y ** 2))
        yaw = np.arctan2(y, x)
        if total_valid is None:
            total_valid, sum_pitch, sum_yaw = (np.zeros_like(valid) for _ in range(3))
        total_valid += valid
        sum_pitch += pitch * valid
        sum_yaw += yaw * valid
    return total_valid, sum_pitch, sum_yaw


def _angle_partials_for_paths(paths, min_depth: float, max_depth: float):
    return _angle_partials((np.load(p)[..., :3] for p in paths), min_depth, max_depth)


def _finalize_angles(total_valid, sum_pitch, sum_yaw) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        pitch = sum_pitch / total_valid
        yaw = sum_yaw / total_valid
    angles = np.stack([pitch, yaw], axis=0)
    mean_angles = np.stack([np.broadcast_to(_nan_mean(pitch, axis=1), pitch.shape),
                            np.broadcast_to(_nan_mean(yaw, axis=0), yaw.shape)], axis=0)
    valid_pix = (total_valid > 0).astype(np.float64)[None]
    angles = np.nan_to_num(angles, nan=0.0)
    angles = valid_pix * angles + (1.0 - valid_pix) * mean_angles
    if not np.isfinite(angles).all():
        raise ValueError("angle grid has non-finite entries")
    return angles.astype(np.float32)


def compute_avg_angles(scan_iter, min_depth: float = 0.9,
                       max_depth: float = 120.0) -> np.ndarray:
    """Mean per-pixel (pitch, yaw) of (H, W, >= 3) xyz range images in
    meters over the pixels inside (min_depth, max_depth) -> (2, H, W);
    pixels never valid take their row's mean pitch and column's mean yaw."""
    return _finalize_angles(*_angle_partials(scan_iter, min_depth, max_depth))


def _process_one(task) -> str:
    point_path, save_path, H, W, label_path, label_save, native = task
    process_bin_file(point_path, save_path, H, W, label_path, label_save, native=native)
    return save_path


def _shards(items, n: int):
    return [items[i::n] for i in range(n) if items[i::n]]


def process_kitti_root(root_dir: str, H: int = 64, W: int = 2048, verbose: bool = True,
                       n_jobs: int = None, native: bool = True) -> np.ndarray:
    """Project every ``<root>/dataset/sequences/NN/velodyne/*.bin`` into
    ``<root>/dusty-gan/sequences`` and write the train split's mean angle
    grid to ``<root>/angles.npy`` and ``angles.pt``.  Scans fan out over
    ``n_jobs`` spawned processes (default: every core; 1 runs inline), and
    so does the angle accumulation, whose float64 shard sums then differ
    from a serial sum by reassociation only.  Returns the angle grid."""
    n_jobs = os.cpu_count() if n_jobs is None else max(1, int(n_jobs))
    tasks = []
    for split_dir in sorted(glob(osp.join(root_dir, "dataset/sequences", "*"))):
        for point_path in sorted(glob(osp.join(split_dir, "velodyne", "*.bin"))):
            save_path = point_path.replace("dataset/sequences", "dusty-gan/sequences")
            save_path = save_path.replace(".bin", ".npy")
            label_path = point_path.replace("/velodyne", "/labels").replace(".bin", ".label")
            label_save = (label_path.replace("dataset/sequences", "dusty-gan/sequences")
                          .replace(".label", ".png"))
            tasks.append((point_path, save_path, H, W, label_path, label_save, native))

    # spawn, not fork: the caller may hold threads (torch's), and a fork
    # from a threaded process can deadlock its children
    mp_ctx = multiprocessing.get_context("spawn")
    if n_jobs > 1 and len(tasks) > 1:
        if native:
            kernels.build(["rangeproj"])  # once, before the workers load it
        with ProcessPoolExecutor(max_workers=n_jobs, mp_context=mp_ctx) as pool:
            for done, _ in enumerate(pool.map(_process_one, tasks, chunksize=8), 1):
                if verbose and done % 1000 == 0:
                    print(f"projected: {done}/{len(tasks)}")
    else:
        for task in tasks:
            _process_one(task)
    if verbose:
        print(f"projected: {len(tasks)} scans ({n_jobs} workers)")

    paths = []
    for seq in TRAIN_SEQUENCES:
        seq_dir = osp.join(root_dir, "dusty-gan/sequences", str(seq).zfill(2))
        paths.extend(sorted(glob(osp.join(seq_dir, "velodyne/*.npy"))))
    if n_jobs > 1 and len(paths) > n_jobs:
        with ProcessPoolExecutor(max_workers=n_jobs, mp_context=mp_ctx) as pool:
            parts = list(pool.map(partial(_angle_partials_for_paths, min_depth=0.9,
                                          max_depth=120.0), _shards(paths, n_jobs)))
        angles = _finalize_angles(*(sum(p[i] for p in parts) for i in range(3)))
    else:
        angles = compute_avg_angles(np.load(p)[..., :3] for p in paths)
    np.save(osp.join(root_dir, "angles.npy"), angles)
    import torch  # here: the pool's workers import this module without torch

    torch.save(torch.from_numpy(angles), osp.join(root_dir, "angles.pt"))
    return angles
