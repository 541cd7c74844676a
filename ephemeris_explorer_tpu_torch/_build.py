"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The kernels are compiled by ``nvcc`` into one shared library with a plain C
interface, ``build/kernels/<digest>/libeet_cuda.so`` under the checkout root
(or under ``$EET_CUDA_BUILD_DIR`` when that is set), and loaded with
``ctypes``.  ``<digest>`` hashes the sources and the flags, so a changed
source builds a new library beside the old one, and a library, once moved
into place, is never replaced by a different one.  The package is meant to
be run from its checkout; an installed copy should set
``EET_CUDA_BUILD_DIR`` to a directory of its own.  Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.

Arithmetic flags are part of correctness: ``--fmad=false``, no fast math, no
flush-to-zero (see ``csrc/twofloat.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(
    os.environ.get("EET_CUDA_BUILD_DIR")
    or Path(__file__).resolve().parent.parent / "build" / "kernels"
)
LIB_NAME = "libeet_cuda.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc/ptxas output of this process's build ("" if it was cached)

_vp, _int = ctypes.c_void_p, ctypes.c_int


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build the CUDA kernels")
    return str(nvcc)


def _compile(lib_path: Path) -> str:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    lib_path.with_name("build.log").write_text(log)
    return log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.eet_accel_df64.argtypes = [_vp] * 8 + [_int, _int, _vp]
    lib.eet_accel_df64.restype = _int
    lib.eet_accel_df64_tile.argtypes = []
    lib.eet_accel_df64_tile.restype = _int
    lib.eet_elm2f_update.argtypes = [_vp, _vp, _int] + [_vp] * 6 + [_int, _vp]
    lib.eet_elm2f_update.restype = _int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if it is missing or stale."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_ROOT / _source_hash()[:16] / LIB_NAME
        if not lib_path.exists():
            build_log = _compile(lib_path)
        _lib = _bind(ctypes.CDLL(str(lib_path)))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
