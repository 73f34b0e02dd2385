"""ctypes bindings of the port's host-side range-image library
(``csrc/rangeproj.cpp``; ``dusty_gan_tpu/data/native.py``).

``kernels.py`` builds the source with the host C++ compiler at first use
and loads it, as it does the CUDA sources; nothing is built at import.  A
missing compiler or a failed build raises: no caller falls back to numpy
on its own.  The numpy versions (``data/datasets.py``,
``data/preprocess.py``) run only when a caller asks for them with
``native=False``, and give the same bits.

ctypes releases the GIL around each call, so a thread pool scales the
calls with the host's cores (the resized-cache build relies on it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dusty_gan_torch import kernels


def project_scan(points: np.ndarray, h: int = 64, w: int = 2048) -> np.ndarray:
    """(N, C >= 3) points -> (h, w, C) range image, nearest point wins."""
    points = np.ascontiguousarray(points, np.float32)
    n, c = points.shape
    out = np.zeros((h, w, c), np.float32)
    kernels.load("rangeproj").rangeproj_project_scan(points, n, c, h, w, out)
    return out


def preprocess_item(scan: np.ndarray, min_depth: float, max_depth: float, flip: bool,
                    shape: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """(H0, W0, C >= 3) scan in meters -> {"depth": (h, w, 1) in [0, 1],
    "mask": (h, w, 1), "xyz": (h, w, 3) / max_depth}, flipped at full
    resolution before the nearest subsample when ``flip``."""
    scan = np.ascontiguousarray(scan, np.float32)
    h0, w0, c = scan.shape
    h, w = shape
    depth = np.empty((h, w), np.float32)
    mask = np.empty((h, w), np.float32)
    xyz = np.empty((h, w, 3), np.float32)
    kernels.load("rangeproj").rangeproj_preprocess_item(
        scan, h0, w0, c, min_depth, max_depth, int(flip), h, w, depth, mask, xyz)
    return {"depth": depth[..., None], "mask": mask[..., None], "xyz": xyz}
