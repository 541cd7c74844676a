"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc``, all of them started
together, and the objects are linked into one shared library with a plain C
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
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(
    os.environ.get("EET_CUDA_BUILD_DIR")
    or Path(__file__).resolve().parent.parent / "build" / "kernels"
)
LIB_NAME = "libeet_cuda.so"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every process; their output, or raise if any failed."""
    logs, failed = [], []
    for what, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {what}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{what} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return log


def _compile(lib_path: Path) -> str:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f"tmp.{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = _nvcc()
    try:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = _run(procs)
        so = tmp / LIB_NAME
        log += _run([("link", subprocess.Popen(
            [nvcc, "-shared", *ARCH, "-o", str(so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))])
        os.replace(so, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib_path.with_name("build.log").write_text(log)
    return log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.eet_accel_df64.argtypes = [_vp] * 8 + [_int, _int, _vp]
    lib.eet_accel_df64.restype = _int
    lib.eet_accel_df64_ensemble.argtypes = [_vp] * 8 + [_int] * 3 + [_vp]
    lib.eet_accel_df64_ensemble.restype = _int
    lib.eet_accel_df64_rows.argtypes = [_vp] * 10 + [_int] * 4 + [_vp]
    lib.eet_accel_df64_rows.restype = _int
    lib.eet_accel_df64_tile.argtypes = []
    lib.eet_accel_df64_tile.restype = _int
    lib.eet_accel_f64.argtypes = [_vp] * 5 + [_int] * 3 + [_vp]
    lib.eet_accel_f64.restype = _int
    lib.eet_accel_f64_rows.argtypes = [_vp] * 6 + [_int] * 5 + [_vp]
    lib.eet_accel_f64_rows.restype = _int
    lib.eet_accel_f64_ensemble.argtypes = [_vp] * 5 + [_int] * 4 + [_vp]
    lib.eet_accel_f64_ensemble.restype = _int
    lib.eet_accel_f64_tile.argtypes = []
    lib.eet_accel_f64_tile.restype = _int
    lib.eet_accel_f64_recv.argtypes = []
    lib.eet_accel_f64_recv.restype = _int
    lib.eet_elm2f_update.argtypes = [_vp, _vp, _int] + [_vp] * 6 + [_int, _vp]
    lib.eet_elm2f_update.restype = _int
    lib.eet_elm2f_update_shift.argtypes = [_vp, _vp, _int] + [_vp] * 8 + [_int, _vp]
    lib.eet_elm2f_update_shift.restype = _int
    lib.eet_elm2_f64_update_shift.argtypes = [_vp, _int] + [_vp] * 4 + [ctypes.c_longlong, _vp]
    lib.eet_elm2_f64_update_shift.restype = _int
    lib.eet_elm2_f64_max_order.argtypes = []
    lib.eet_elm2_f64_max_order.restype = _int
    lib.eet_accel_limbs3.argtypes = [_vp] * 9 + [_int, _int, _vp]
    lib.eet_accel_limbs3.restype = _int
    lib.eet_accel_limbs3_rows.argtypes = [_vp] * 12 + [_int] * 4 + [_vp]
    lib.eet_accel_limbs3_rows.restype = _int
    lib.eet_accel_limbs3_tile.argtypes = []
    lib.eet_accel_limbs3_tile.restype = _int
    lib.eet_accel_limbs3_f64.argtypes = [_vp] * 9 + [_int] * 3 + [_vp]
    lib.eet_accel_limbs3_f64.restype = _int
    lib.eet_accel_limbs3_f64_rows.argtypes = [_vp] * 11 + [_int] * 5 + [_vp]
    lib.eet_accel_limbs3_f64_rows.restype = _int
    lib.eet_accel_limbs3_f64_tile.argtypes = []
    lib.eet_accel_limbs3_f64_tile.restype = _int
    lib.eet_accel_limbs3_f64_recv.argtypes = []
    lib.eet_accel_limbs3_f64_recv.restype = _int
    lib.eet_elm2q_update.argtypes = [_vp, _int, _vp, _int, ctypes.c_uint] + [_vp] * 10 + [_int, _vp]
    lib.eet_elm2q_update.restype = _int
    lib.eet_elm2q_step.argtypes = ([_vp, _vp, _int, _int, ctypes.c_uint] + [_vp] * 7
                                   + [ctypes.c_longlong, _vp])
    lib.eet_elm2q_step.restype = _int
    lib.eet_accel_f32.argtypes = [_vp] * 5 + [_int] * 3 + [_vp]
    lib.eet_accel_f32.restype = _int
    lib.eet_accel_f32_masked.argtypes = [_vp] * 7 + [_int] * 5 + [_vp]
    lib.eet_accel_f32_masked.restype = _int
    lib.eet_accel_mixed.argtypes = [_vp] * 6 + [_int] * 3 + [_vp]
    lib.eet_accel_mixed.restype = _int
    lib.eet_f32_pair_tile.argtypes = []
    lib.eet_f32_pair_tile.restype = _int
    lib.eet_f32_pair_group.argtypes = []
    lib.eet_f32_pair_group.restype = _int
    lib.eet_strong_corr.argtypes = [_vp] * 9 + [_int, _int, _int, _vp]
    lib.eet_strong_corr.restype = _int
    lib.eet_strong_corr_f64.argtypes = [_vp] * 6 + [_int] * 3 + [_vp]
    lib.eet_strong_corr_f64.restype = _int
    lib.eet_strong_corr_dd.argtypes = [_vp] * 5 + [_int, _int, _vp]
    lib.eet_strong_corr_dd.restype = _int
    lib.eet_strong_corr_dd_f64.argtypes = [_vp] * 5 + [_int, _int, _vp]
    lib.eet_strong_corr_dd_f64.restype = _int
    lib.eet_accel_sym.argtypes = [_vp] * 10 + [_int, _vp]
    lib.eet_accel_sym.restype = _int
    lib.eet_gen_scan.argtypes = [_vp, _vp, _int] + [_vp] * 12 + [_int, _int, _vp]
    lib.eet_gen_scan.restype = _int
    lib.eet_gen_scan_f64.argtypes = [_vp, _vp, _int, ctypes.c_double] + [_vp] * 6 + [_int, _int, _vp]
    lib.eet_gen_scan_f64.restype = _int
    lib.eet_gen_scan_q.argtypes = ([_vp, _vp, _int, _int, ctypes.c_uint, _int] + [_vp] * 9
                                   + [_int, _int, _vp])
    lib.eet_gen_scan_q.restype = _int
    lib.eet_gen_scan_q_max_bodies.argtypes = []
    lib.eet_gen_scan_q_max_bodies.restype = _int
    lib.eet_gen_scan_q_src_tile.argtypes = []
    lib.eet_gen_scan_q_src_tile.restype = _int
    lib.eet_fleet_scan.argtypes = ([_int, _vp, ctypes.c_longlong, _int, _int, _int]
                                   + [_vp] * 6 + [_int] + [_vp] * 4 + [_int] + [_vp] * 4
                                   + [_int] * 3 + [_vp])
    lib.eet_fleet_scan.restype = _int
    lib.eet_accel_full3.argtypes = [_vp] * 6 + [ctypes.c_longlong, _int, _vp]
    lib.eet_accel_full3.restype = _int
    lib.eet_accel_full3_smem_bodies.argtypes = []
    lib.eet_accel_full3_smem_bodies.restype = _int
    lib.eet_accel_full3_scratch_floats.argtypes = [_int]
    lib.eet_accel_full3_scratch_floats.restype = ctypes.c_longlong
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
