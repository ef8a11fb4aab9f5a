"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, at first use. A library's file name carries a hash of
its source, every shared header and the flags, so an edited kernel or
header is rebuilt and an unchanged one is reused. Libraries are loaded
with ``ctypes``; every launching entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("window_attention", "flash_attention", "conv3x3x3")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)

Signature = Tuple[object, Sequence[object]]  # (restype, argtypes)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path under ``BUILD_DIR``: its name and a hash of its
    ``.cu``, every header under ``csrc/`` and the flags, so an edit to any
    of them rebuilds it."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named kernel library not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: nvcc output}`` for the
    libraries it built; raises after every compiler has exited if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        detail = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with ``restype``
    and ``argtypes`` set for each function in ``signatures``."""
    lib = _libs.get(name)
    if lib is not None:  # the launch path: no lock once loaded
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.error_string(err).decode()})")
