"""Build and load the native greedy boundary matcher (``native/
boundary_match.cpp``, the JAX package's source copied).

The matcher is a host-side loop with no device mapping: a sort of the
candidate pairs and one pass over them. At first use ``g++`` compiles it
into the package's git-ignored ``_build/`` (beside the CUDA kernels' build)
under a name that carries a hash of the source and flags, and ``ctypes``
loads it. A missing or failing ``g++`` raises: there is no quiet fallback.
The Python version of the same loop, ``metrics/boundary.py::
_match_one_greedy_plain``, is what the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "boundary_match.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the build of the current source lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libboundary_match_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded matcher library, built first if this source hash has no
    build yet. Raises RuntimeError when g++ is missing or fails."""
    out = library_path()
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("the native boundary matcher needs g++ to build; none was "
                               "found on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed on boundary_match.cpp:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.greedy_match.restype = ctypes.c_int64
    lib.greedy_match.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def greedy_match_native(pred_pts: np.ndarray, gt_pts: np.ndarray, tol: float):
    """One-to-one greedy boundary matching by the C++ matcher.

    pred_pts/gt_pts: (n, 2) int (y, x). Returns (pred_matched, gt_matched)
    bool arrays."""
    lib = get_lib()
    pred = np.ascontiguousarray(pred_pts, np.int32)
    gt = np.ascontiguousarray(gt_pts, np.int32)
    if pred.ndim != 2 or pred.shape[1] != 2 or gt.ndim != 2 or gt.shape[1] != 2:
        raise ValueError(f"points must be (n, 2), got {pred.shape} and {gt.shape}")
    pm = np.zeros(len(pred), np.uint8)
    gm = np.zeros(len(gt), np.uint8)
    if len(pred) and len(gt):
        lib.greedy_match(
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(pred),
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(gt),
            float(tol),
            pm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    return pm.astype(bool), gm.astype(bool)
