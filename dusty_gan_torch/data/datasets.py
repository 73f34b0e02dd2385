"""KITTI Odometry and Sparse MPO range-image datasets
(``dusty_gan_tpu/data/datasets.py``).

Pre-projected (H0, W0, 4) ``.npy`` scans become {depth [0,1], mask, xyz
(unit space)[, reflectance]} at the model resolution by NEAREST
subsampling: depth = ||xyz||, gated to (min_depth, max_depth), invalid
pixels zeroed, optional horizontal flip at full resolution before the
resize.  A depth-only dataset runs the native library
(``data/native.py``); ``_process(..., native=False)`` runs numpy, with the
library's float32 operations, so the two give the same bits, and both give
the JAX package's (whose default path is the same C++).

With ``cache_dir`` the resized arrays of the whole split are built once
into a directory of ``.npy`` files, read back as read-only memmaps, plus
the flipped depth and mask when the split flips (``FLIP_CACHE_KEYS``).
Its name signs the class, split, shape, depth range, modality, scan count
and flip exactly as the JAX package does, and its format is the same, so a
cache that either package built serves the other.  A train split with
``dataset.flip`` draws each item's flip from the loader's per-item stream
(``get``); evaluation splits read items unflipped.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
from numpy.lib.format import open_memmap

from dusty_gan_torch.data import native as native_lib

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
    """A list of ``.npy`` scan paths, the value pipeline and the optional
    resized cache."""

    # what the training step reads of a flipped draw: depth (and the mask);
    # evaluation splits never flip
    FLIP_CACHE_KEYS = ("depth", "mask")

    def __init__(self, root: str, split: str, shape=(64, 256),
                 min_depth: float = 0.9, max_depth: float = 120.0,
                 flip: bool = False, modality: Sequence[str] = ("depth",),
                 cache_dir: Optional[str] = None):
        self.root = root
        self.split = split
        self.flip = bool(flip)
        self.shape = tuple(shape)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        if "depth" not in modality:
            raise ValueError(f"modality {tuple(modality)} lacks \"depth\"")
        self.modality = tuple(modality)
        self.datalist = self._load_datalist()
        self._cache = None
        self._flip_cache = None
        if cache_dir is not None and len(self.datalist) > 0:
            self._build_cache(cache_dir)

    def _load_datalist(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.datalist)

    def _load_raw(self, index: int) -> np.ndarray:
        return np.load(self.datalist[index]).astype(np.float32)

    def _process(self, points: np.ndarray, flip: bool,
                 native: bool = True) -> Dict[str, np.ndarray]:
        """(H0, W0, C) scan -> the item's (h, w, c) arrays.  A depth-only
        dataset runs the native library unless ``native`` is False; numpy
        repeats its float32 operations: the pixel's nearest source, d =
        sqrt((x*x + y*y) + z*z), (d - min) * (1 / (max - min)) and
        xyz * (1 / max)."""
        if native and self.modality == ("depth",):
            return native_lib.preprocess_item(points, self.min_depth, self.max_depth,
                                              flip, self.shape)
        h0, w0 = points.shape[:2]
        rows = nearest_resize_indices(h0, self.shape[0])
        cols = nearest_resize_indices(w0, self.shape[1])
        if flip:
            cols = w0 - 1 - cols
        p = np.asarray(points, np.float32)[rows][:, cols]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        d = np.sqrt(x * x + y * y + z * z)
        lo, hi = np.float32(self.min_depth), np.float32(self.max_depth)
        valid = (d > 0) & (d > lo) & (d < hi)
        zero = np.float32(0)
        out = {
            "depth": np.where(valid, (d - lo) * (np.float32(1) / (hi - lo)), zero)[..., None],
            "mask": valid.astype(np.float32)[..., None],
            "xyz": np.where(valid[..., None], p[..., :3] * (np.float32(1) / hi), zero),
        }
        if "reflectance" in self.modality:
            out["reflectance"] = np.where(valid[..., None], p[..., 3:4], zero)
        return out

    def item(self, index: int, flip: bool = False,
             keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Item ``index`` with an explicit flip bit, from the resized cache
        where it holds the keys asked for, else processed from the raw scan
        (a flipped draw outside ``FLIP_CACHE_KEYS``: flipping at full
        resolution before the subsample cannot be derived from the cached
        unflipped image)."""
        if self._cache is not None:
            if not flip:
                src = self._cache
                return {k: src[k][index] for k in (src if keys is None else keys)}
            fc = self._flip_cache
            if fc is not None and keys is not None and set(keys) <= set(fc):
                return {k: fc[k][index] for k in keys}
        out = self._process(self._load_raw(index), flip)
        return out if keys is None else {k: out[k] for k in keys}

    def get(self, index: int, rng: Optional[np.random.Generator] = None,
            keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Item ``index``, flipped when ``flip`` is set and the first draw of
        ``rng`` exceeds 0.5 (None: the stream ``default_rng([0, index])``, the
        JAX package's for its default seed); ``keys`` restricts the dict."""
        if rng is None:
            rng = np.random.default_rng([0, index])
        return self.item(index, flip=self.flip and rng.random() > 0.5, keys=keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get(index)

    # ------------------------------------------------------------------
    def _cache_key(self) -> str:
        """The JAX package's signature: the shape as a tuple's string and
        the depths as floats' (a list or an int would sign another cache)."""
        sig = "|".join(
            [self.__class__.__name__, self.split, str(self.shape), str(self.min_depth),
             str(self.max_depth), ",".join(self.modality), str(len(self.datalist))]
            + (["flip"] if self.flip else []))
        return hashlib.sha1(sig.encode()).hexdigest()[:16]

    def cache_path(self, cache_dir: str) -> str:
        return osp.join(cache_dir, f"resized_{self._cache_key()}")

    def _build_cache(self, cache_dir: str) -> None:
        """Build the cache directory unless it exists, then map it read-only:
        resident memory is the pages a run touches."""
        os.makedirs(cache_dir, exist_ok=True)
        path = self.cache_path(cache_dir)
        keys = ["depth", "mask", "xyz"] + (
            ["reflectance"] if "reflectance" in self.modality else [])
        flip_keys = list(self.FLIP_CACHE_KEYS) if self.flip else []
        if not osp.isdir(path):
            self._write_cache_dir(path, keys, flip_keys)
        self._cache = {k: np.load(osp.join(path, k + ".npy"), mmap_mode="r") for k in keys}
        flipped = {k: np.load(osp.join(path, "flip_" + k + ".npy"), mmap_mode="r")
                   for k in flip_keys if osp.exists(osp.join(path, "flip_" + k + ".npy"))}
        self._flip_cache = flipped or None

    def _write_cache_dir(self, path: str, keys, flip_keys) -> None:
        """Each processed scan goes straight into a preallocated memmap, by a
        thread pool (rows are disjoint).  Every writer builds its own
        ``<path>.tmp.<uuid>`` tree and renames it into place: concurrent
        writers (ranks sharing a dataset root, on hosts with separate pid
        spaces) race harmlessly, since the content is deterministic."""
        n = len(self.datalist)
        tmp = f"{path}.tmp.{uuid.uuid4().hex}"
        os.makedirs(tmp, exist_ok=False)
        try:
            first = self._process(self._load_raw(0), flip=False)
            mm = {k: open_memmap(osp.join(tmp, k + ".npy"), mode="w+", dtype=first[k].dtype,
                                 shape=(n,) + first[k].shape) for k in keys}
            for k in flip_keys:
                mm["flip_" + k] = open_memmap(osp.join(tmp, "flip_" + k + ".npy"), mode="w+",
                                              dtype=first[k].dtype,
                                              shape=(n,) + first[k].shape)

            def work(i: int) -> None:
                raw = self._load_raw(i)
                out = self._process(raw, flip=False)
                for k in keys:
                    mm[k][i] = out[k]
                if flip_keys:
                    out = self._process(raw, flip=True)
                    for k in flip_keys:
                        mm["flip_" + k][i] = out[k]

            with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 16)) as ex:
                list(ex.map(work, range(n)))
            for v in mm.values():
                v.flush()
            del mm
            try:
                os.rename(tmp, path)
            except OSError:
                if not osp.isdir(path):
                    raise  # not another writer's win
        finally:
            if osp.isdir(tmp):
                shutil.rmtree(tmp)

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


def define_dataset(cfg, phase: str = "train", modality=("depth",), cache_dir=None):
    """The dataset class named by ``cfg.name`` (a dict or an attribute
    config); only the train split flips."""
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
        modality=modality,
        cache_dir=cache_dir,
    )
