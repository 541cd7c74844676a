"""ctypes bridge to the native host runtime (native/eet_native.cpp).

Builds the shared library on first use (g++, cached next to the source) and
exposes numpy-friendly wrappers.  Every entry point has a pure-Python
fallback elsewhere in the package (ephemeris.py / spacecraft.py / plot.py);
the native path exists for the host serving loop - per-frame scene
evaluation, polyline generation and picking at UI rates - the role the
reference's compiled runtime plays.

Port of ``ephemeris_explorer_tpu.native``, a host helper and not a device
path: it shares ``native/eet_native.cpp`` (backend-free C++) with the JAX
package by path and builds it into ``native/eet_native_torch.so``, its own
file, so it never loads a library the JAX package is still writing.  The
build writes a temporary file and renames it into place, so processes that
build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "eet_native.cpp"
_SO = _SRC.with_name("eet_native_torch.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path:
    """The library next to native/eet_native.cpp, built on first use."""
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-o", tmp, str(_SRC), "-lpthread",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return None
        d = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.POINTER(ctypes.c_int64)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.eet_spline_eval_batch.argtypes = [
            d, d, i64, i64, d, ctypes.c_int64, d, ctypes.c_int64, d, d, u8, ctypes.c_int
        ]
        lib.eet_hermite_eval_batch.argtypes = [
            d, d, d, ctypes.c_int64, d, ctypes.c_int64, d, d, u8, ctypes.c_int
        ]
        lib.eet_plot_polyline.restype = ctypes.c_int64
        lib.eet_plot_polyline.argtypes = [
            d, d, i64, i64, d, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, d, ctypes.c_double,
            ctypes.c_int64, d, d,
        ]
        lib.eet_ray_distances.argtypes = [
            d, d, ctypes.c_int64, d, d, ctypes.c_double, d, u8
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeEphemeris:
    """Host-side packed view of an :class:`..ephemeris.Ephemeris`."""

    def __init__(self, eph):
        self.names = list(eph.names)
        self.starts = np.array([eph.bodies[n].start_s for n in self.names])
        self.intervals = np.array([eph.bodies[n].interval_s for n in self.names])
        ns = np.array([eph.bodies[n].segment_count for n in self.names], dtype=np.int64)
        self.nsegs = ns
        self.offsets = np.concatenate([[0], np.cumsum(ns)[:-1]]).astype(np.int64)
        self.coeffs = np.ascontiguousarray(
            np.concatenate([eph.bodies[n].coeffs for n in self.names])
        )
        self.n_bodies = len(self.names)

    def eval_batch(self, times, velocities: bool = True, n_threads: int = 8):
        """(pos (T, N, 3), vel (T, N, 3) | None, ok (T, N) bool)."""
        lib = _load()
        times = np.ascontiguousarray(times, dtype=np.float64)
        t = len(times)
        pos = np.empty((t, self.n_bodies, 3))
        vel = np.empty((t, self.n_bodies, 3)) if velocities else None
        ok = np.empty((t, self.n_bodies), dtype=np.uint8)
        lib.eet_spline_eval_batch(
            _dp(self.starts), _dp(self.intervals), _ip(self.offsets), _ip(self.nsegs),
            _dp(self.coeffs), self.n_bodies, _dp(times), t,
            _dp(pos), _dp(vel) if velocities else None, _up(ok), n_threads,
        )
        return pos, vel, ok.astype(bool)

    def plot_polyline(self, body, t_min, t_max, cam, tan2_res, max_points=10_000):
        """Native PlotMethod3: (times (P,), points (P, 3))."""
        lib = _load()
        b = self.names.index(body) if isinstance(body, str) else int(body)
        cam = np.ascontiguousarray(cam, dtype=np.float64)
        out_t = np.empty(max_points)
        out_p = np.empty((max_points, 3))
        n = lib.eet_plot_polyline(
            _dp(self.starts), _dp(self.intervals), _ip(self.offsets), _ip(self.nsegs),
            _dp(self.coeffs), self.n_bodies, b,
            float(t_min), float(t_max), _dp(cam), float(tan2_res),
            max_points, _dp(out_t), _dp(out_p),
        )
        if n < 0:
            raise ValueError("trajectory does not cover the requested span")
        return out_t[:n].copy(), out_p[:n].copy()


def hermite_eval_batch(traj, times, n_threads: int = 8):
    """Native cubic-Hermite evaluation over a HermiteTrajectory."""
    lib = _load()
    ts = np.ascontiguousarray(traj.ts, dtype=np.float64)
    pos = np.ascontiguousarray(traj.pos, dtype=np.float64)
    vel = np.ascontiguousarray(traj.vel, dtype=np.float64)
    times = np.ascontiguousarray(times, dtype=np.float64)
    t = len(times)
    out_p = np.empty((t, 3))
    out_v = np.empty((t, 3))
    ok = np.empty(t, dtype=np.uint8)
    lib.eet_hermite_eval_batch(
        _dp(ts), _dp(pos), _dp(vel), len(ts), _dp(times), t,
        _dp(out_p), _dp(out_v), _up(ok), n_threads,
    )
    return out_p, out_v, ok.astype(bool)


def ray_distances(times, points, origin, direction, max_ray=np.inf):
    """Native polyline picking: [(time, separation, t_ray)]."""
    lib = _load()
    times = np.ascontiguousarray(times, dtype=np.float64)
    points = np.ascontiguousarray(points, dtype=np.float64)
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    direction = np.ascontiguousarray(direction, dtype=np.float64)
    n = len(times)
    out = np.empty((max(n - 1, 0), 3))
    mask = np.zeros(max(n - 1, 0), dtype=np.uint8)
    lib.eet_ray_distances(
        _dp(times), _dp(points), n, _dp(origin), _dp(direction),
        float(max_ray), _dp(out), _up(mask),
    )
    return [tuple(out[i]) for i in np.nonzero(mask)[0]]
