"""ctypes bindings of the port's host-side range-image library
(``csrc/rangeproj.cpp``; ``dusty_gan_tpu/data/native.py``).

The source is compiled with ``g++`` at first use into
``<repo>/build/dusty_gan_torch/librangeproj-<hash>.so``, the hash taken
over the source and the flags, as ``kernels.py`` does for the CUDA
sources; nothing is built at import.  A missing compiler or a failed build
raises: no caller falls back to numpy on its own.  The numpy versions
(``data/datasets.py``, ``data/preprocess.py``) run only when a caller asks
for them with ``native=False``, and give the same bits.

ctypes releases the GIL around each call, so a thread pool scales the
calls with the host's cores (the resized-cache build relies on it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dusty_gan_torch.kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "rangeproj.cpp"
# no -march=native, and no FMA contraction: the library's float32
# operations must round as numpy's do
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-Wall")

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) found: dusty_gan_torch builds "
                       "csrc/rangeproj.cpp at first use")


def library_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librangeproj-{tag}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    out = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for csrc/rangeproj.cpp (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.rangeproj_project_scan.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
            lib.rangeproj_project_scan.restype = ctypes.c_int
            lib.rangeproj_preprocess_item.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
            lib.rangeproj_preprocess_item.restype = None
            _lib = lib
        return _lib


def project_scan(points: np.ndarray, h: int = 64, w: int = 2048) -> np.ndarray:
    """(N, C >= 3) points -> (h, w, C) range image, nearest point wins."""
    points = np.ascontiguousarray(points, np.float32)
    n, c = points.shape
    out = np.zeros((h, w, c), np.float32)
    load().rangeproj_project_scan(points, n, c, h, w, out)
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
    load().rangeproj_preprocess_item(scan, h0, w0, c, min_depth, max_depth, int(flip), h, w,
                                     depth, mask, xyz)
    return {"depth": depth[..., None], "mask": mask[..., None], "xyz": xyz}
