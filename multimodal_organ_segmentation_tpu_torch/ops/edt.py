"""Euclidean distance transform through a native C++ kernel (port of the JAX
package's ``ops/edt.py``).

scipy-compatible: ``distance_transform_edt(input, sampling)`` returns, for
each voxel, the distance to the nearest **zero** voxel of ``input``. The
kernel is ``native/edt.cc`` of this package (Felzenszwalb lower envelope,
multi-threaded over scan lines). At first use ``g++`` builds it into
``build/host/`` at the root of the checkout, under a name that carries a
hash of the source and the flags; it is loaded with ``ctypes``. Where the
JAX module falls back to scipy, this one raises: a failed build or load is
an error, not a slower path. ``scipy.ndimage.distance_transform_edt`` is the
plain version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "edt.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"edt-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; raises with the
    compiler's output when ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("edt: no C++ compiler (g++) to build native/edt.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"edt: g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.edt_3d.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_int,
            ]
            lib.edt_3d.restype = None
            _lib = lib
    return _lib


def distance_transform_edt(
    input_array: np.ndarray,
    sampling: Optional[Sequence[float]] = None,
    n_threads: int = 4,
) -> np.ndarray:
    """Distance to the nearest zero voxel of a 3D array (scipy semantics),
    float64."""
    arr = np.ascontiguousarray(input_array)
    if arr.ndim != 3:
        raise ValueError(f"edt: the native kernel takes 3D arrays, got {arr.ndim}D")
    lib = _load()
    if sampling is None:
        sampling = (1.0, 1.0, 1.0)
    elif np.isscalar(sampling):
        sampling = (float(sampling),) * 3
    # seeds (distance 0) are the ZERO voxels of input → mask = (input == 0)
    mask = np.ascontiguousarray((arr == 0).astype(np.uint8))
    out = np.empty(arr.shape, dtype=np.float64)
    lib.edt_3d(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], arr.shape[2],
        float(sampling[0]), float(sampling[1]), float(sampling[2]),
        int(n_threads),
    )
    return out
