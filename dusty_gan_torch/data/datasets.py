"""KITTI Odometry and Sparse MPO range-image datasets
(``dusty_gan_tpu/data/datasets.py``), numpy value path only.

Pre-projected (H0, W0, 4) ``.npy`` scans become {depth [0,1], mask, xyz
(unit space)} at the model resolution by NEAREST subsampling: depth =
||xyz||, gated to (min_depth, max_depth), invalid pixels zeroed, optional
horizontal flip at full resolution before the resize.  A train split
with ``dataset.flip`` draws each item's flip from the loader's per-item
stream (``get``), as the JAX package does; evaluation splits read items
unflipped.  The JAX package's resized-array caches are not ported: every
item is processed from its raw scan.
"""

from __future__ import annotations

import os.path as osp
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np

KITTI_SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "val": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
    "custom": [16],
}

MPO_SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6],
    "val": [7],
    "test": [8, 9, 10],
}


def nearest_resize_indices(in_size: int, out_size: int) -> np.ndarray:
    """``F.interpolate(mode="nearest")`` source index of each output index."""
    return np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)


class RangeImageDataset:
    """A list of ``.npy`` scan paths and the value pipeline."""

    def __init__(self, root: str, split: str, shape=(64, 256),
                 min_depth: float = 0.9, max_depth: float = 120.0,
                 flip: bool = False):
        self.root = root
        self.split = split
        self.flip = bool(flip)
        self.shape = tuple(shape)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.datalist = self._load_datalist()

    def _load_datalist(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.datalist)

    def _load_raw(self, index: int) -> np.ndarray:
        return np.load(self.datalist[index]).astype(np.float32)

    def _process(self, points: np.ndarray, flip: bool) -> Dict[str, np.ndarray]:
        out = {"xyz": points[..., :3]}
        depth = np.linalg.norm(out["xyz"], ord=2, axis=2)
        mask = (depth > 0.0) & (depth > self.min_depth) & (depth < self.max_depth)
        depth = (depth - self.min_depth) / (self.max_depth - self.min_depth)
        out["depth"] = depth
        out["mask"] = mask.astype(np.float32)
        out["xyz"] = out["xyz"] / self.max_depth
        for key in out:
            out[key] = np.where(
                mask[..., None] if out[key].ndim == 3 else mask, out[key], 0
            ).astype(np.float32)

        h0, w0 = out["depth"].shape
        if flip:
            out = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in out.items()}
        hi = nearest_resize_indices(h0, self.shape[0])
        wi = nearest_resize_indices(w0, self.shape[1])
        out = {k: v[hi][:, wi] for k, v in out.items()}
        for k in ("depth", "mask"):
            out[k] = out[k][..., None]
        return out

    def item(self, index: int, flip: bool = False) -> Dict[str, np.ndarray]:
        return self._process(self._load_raw(index), flip)

    def get(self, index: int, rng: Optional[np.random.Generator] = None,
            keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Item ``index``, flipped when ``flip`` is set and the first draw of
        ``rng`` exceeds 0.5 (None: the stream ``default_rng([0, index])``, the
        JAX package's for its default seed); ``keys`` restricts the dict."""
        if rng is None:
            rng = np.random.default_rng([0, index])
        item = self.item(index, flip=self.flip and rng.random() > 0.5)
        return item if keys is None else {k: item[k] for k in keys}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get(index)

    def __repr__(self):
        return (f"{self.__class__.__name__}(n={len(self)}, root={self.root}, "
                f"split={self.split}, shape={self.shape})")


class KITTIOdometry(RangeImageDataset):
    """Sequences 00-10 train (minus 08 = val), 11-21 test."""

    def _load_datalist(self):
        datalist = []
        for subset in KITTI_SPLIT[self.split]:
            subset_dir = osp.join(self.root, "sequences", str(subset).zfill(2))
            datalist += sorted(glob(osp.join(subset_dir, "velodyne/*")))
        return datalist


class SparseMPO(RangeImageDataset):
    """File glob ``Data/*_set{NNN}_*.npy``."""

    def _load_datalist(self):
        datalist = []
        for subset in MPO_SPLIT[self.split]:
            pattern = "*_set{}_*.npy".format(str(subset).zfill(3))
            datalist += sorted(glob(osp.join(self.root, "Data", pattern)))
        return datalist


def define_dataset(cfg, phase: str = "train"):
    get = (lambda k: cfg[k]) if isinstance(cfg, dict) else (lambda k: getattr(cfg, k))
    name = get("name")
    cls = {"kitti_odometry": KITTIOdometry, "sparse_mpo": SparseMPO}.get(name)
    if cls is None:
        raise NotImplementedError(name)
    return cls(
        root=get("root"),
        split=phase,
        shape=tuple(get("shape")),
        min_depth=get("min_depth"),
        max_depth=get("max_depth"),
        flip=phase == "train" and bool(get("flip")),
    )
