"""Build and load the port's native libraries: the hand-written CUDA
kernels and the host-side range-image library.

Each source under ``csrc/`` has a plain C interface.  A ``.cu`` is compiled
with ``nvcc`` for ``sm_90a``, a ``.cpp`` with the host C++ compiler
(``$CXX``, else ``g++``), into a shared library under
``<repo>/build/dusty_gan_torch/``, named by a hash of its source and flags,
at the first call that needs it, and loaded with ``ctypes``; ``ptxas``'s
report of each CUDA kernel's registers and spills is kept beside it
(``ptxas_info``).  Nothing is built when a module is imported: the CPU
tests import every module on a host without ``nvcc``.  A missing compiler
or a failed build raises; no caller falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "dusty_gan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no -march=native, and no FMA contraction: the host library's float32
# operations must round as numpy's do
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-Wall")

# each library's source under csrc/ and its compiler: "nvcc" (NVCC_FLAGS)
# or "c++", the host compiler (CXX_FLAGS)
SOURCES = {
    "cd_block": ("cd_block.cu", "nvcc"),
    "nn": ("nn.cu", "nvcc"),
    "emd": ("emd.cu", "nvcc"),
    "fps": ("fps.cu", "nvcc"),
    "rangeproj": ("rangeproj.cpp", "c++"),
}

# C signatures of each library: name -> {function: (restype, argtypes)}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
SIGNATURES = {
    "cd_block": {
        "cd_block_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
        "cd_block_error_string": (ctypes.c_char_p, [_I]),
    },
    "nn": {
        "nn_dist_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
        "nn_argmin_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
        "nn_count_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "nn_points_per_thread": (_I, [_I, _I]),
        "nn_error_string": (ctypes.c_char_p, [_I]),
    },
    "emd": {
        "emd_block_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _LL, _P]),
        "emd_pair_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _LL, _P]),
        "emd_error_string": (ctypes.c_char_p, [_I]),
    },
    "fps": {
        "fps_launch": (_I, [_P, _P, _P, _I, _I, _I, _P]),
        "fps_staged_points": (_I, []),
        "fps_error_string": (ctypes.c_char_p, [_I]),
    },
    "rangeproj": {
        "rangeproj_project_scan": (_I, [_F32, ctypes.c_int64, _I, _I, _I, _F32]),
        "rangeproj_preprocess_item": (None, [_F32, _I, _I, _I, ctypes.c_float,
                                             ctypes.c_float, _I, _I, _I, _F32, _F32, _F32]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels of dusty_gan_torch are built from source at first use"
    )


def cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) found: dusty_gan_torch builds "
                       "csrc/rangeproj.cpp at first use")


def flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if SOURCES[name][1] == "nvcc" else CXX_FLAGS


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes()
    tag = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def ptxas_info(name: str) -> str:
    """ptxas's lines (registers, shared memory, spills per kernel) from the
    nvcc build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log").read_text()
    return "\n".join(line for line in log.splitlines()
                     if "ptxas" in line or "spill" in line)


def _start_build(name: str):
    """Start the compiler for one source; returns (process, tmp, target) or
    None if the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    src, compiler = SOURCES[name]
    cmd = [nvcc() if compiler == "nvcc" else cxx(), *flags(name), "-o", str(tmp),
           str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    proc, tmp, target = started
    log, _ = proc.communicate()
    src, compiler = SOURCES[name]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed for csrc/{src} "
                           f"(exit {proc.returncode}):\n{log}")
    if compiler == "nvcc":
        target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly


def build(names: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile the given libraries, one compiler process per source, all
    started together."""
    started = {n: _start_build(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _loaded[name] = lib
        return lib
