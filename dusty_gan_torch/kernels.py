"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under
``<repo>/build/dusty_gan_torch/``, named by a hash of its source and flags,
at the first call that needs it, and loaded with ``ctypes``; ``ptxas``'s
report of each kernel's registers and spills is kept beside it
(``ptxas_info``).  Nothing is built when a module is imported: the CPU
tests import every module on a host without ``nvcc``.  A missing ``nvcc``
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "dusty_gan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library: name -> {function: (restype, argtypes)}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
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


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def ptxas_info(name: str) -> str:
    """ptxas's lines (registers, shared memory, spills per kernel) from the
    build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log").read_text()
    return "\n".join(line for line in log.splitlines()
                     if "ptxas" in line or "spill" in line)


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, target) or None if
    the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile the given kernels, one nvcc process per source, all started
    together."""
    started = {n: _start_build(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
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
