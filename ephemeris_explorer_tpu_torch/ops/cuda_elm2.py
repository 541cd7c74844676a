"""Kernel 2: the two-float ELM2 position update, its plain version and wrapper.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_elm2.elm2f_update`` (TPU
kernel ``_update_kernel2``) and ``elm2_update_coeffs``.  The CUDA source is
``csrc/elm2f_update.cu``; its header note says what bounds it on an H100
and how the design answers that.

:func:`elm2f_update` takes the plain PyTorch version
(:func:`elm2f_update_plain`) only for CPU tensors; on CUDA tensors it
launches the kernel or raises.  ``elm2f_update.launches`` counts its kernel
launches.  The kernel and the plain version run the same ops in the same
order, so they agree bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from . import eft
from .eft import TwoFloat
from .cuda_nbody import _check_f32, on_device


def _split_const(x: float) -> tuple[float, float]:
    """Exact f64 -> (hi, lo) f32 split, done on the host."""
    hi = np.float32(x)
    lo = np.float32(x - np.float64(hi))
    return float(hi), float(lo)


def elm2_update_coeffs(tab, h: float) -> np.ndarray:
    """The (order + 1, 2) split-coefficient table: c_dy rows, then h^2/beta_d."""
    rows = [_split_const(float(c)) for c in tab.c_dy]
    rows.append(_split_const(float(h) * float(h) / float(tab.beta_d)))
    return np.asarray(rows, dtype=np.float32)


_TABLES: dict = {}


def _tables(tab, h: float) -> tuple[np.ndarray, np.ndarray]:
    """(coefficient table, f32 c_y) for a tableau and step, cached: the
    update runs every step and its host work should stay small."""
    key = (tab.name, tab.c_y.tobytes(), tab.c_dy.tobytes(), float(tab.beta_d), float(h))
    out = _TABLES.get(key)
    if out is None:
        assert all(abs(c) in (0.0, 1.0, 2.0) for c in tab.c_y), tab.name
        out = (elm2_update_coeffs(tab, h), np.asarray(tab.c_y, dtype=np.float32))
        _TABLES[key] = out
    return out


def elm2f_update_plain(coef: np.ndarray, c_y: np.ndarray, ys: TwoFloat, dd: TwoFloat) -> TwoFloat:
    """Plain PyTorch version of kernel 2, on any device.

    coef: (order + 1, 2) f32 table (:func:`elm2_update_coeffs`); c_y:
    (order,) f32 alpha weights; ys/dd: TwoFloat of (order, ...) f32 rings,
    newest first.  Returns the TwoFloat y_{n+1} of shape (...).
    """
    order = ys.hi.shape[0]
    cf = torch.from_numpy(np.ascontiguousarray(coef, dtype=np.float32))
    acc = None
    for j in range(order):
        if coef[j, 0] == 0.0:
            continue
        term = eft.mul(TwoFloat(dd.hi[j], dd.lo[j]), TwoFloat(cf[j, 0], cf[j, 1]))
        acc = term if acc is None else eft.add(acc, term)
    inc = eft.mul(acc, TwoFloat(cf[order, 0], cf[order, 1]))
    # alpha combination: exact +-1/+-2 scalings, accurate adds (2y_n - y_{n-1}
    # cancels by construction)
    total = None
    for j in range(order):
        if c_y[j] == 0.0:
            continue
        c = eft.const(float(c_y[j]), torch.float32)
        term = TwoFloat(ys.hi[j] * c, ys.lo[j] * c)
        total = term if total is None else eft.add(total, term)
    return eft.add(total, inc)


def elm2f_update(tab, h: float, ys: TwoFloat, dd: TwoFloat) -> TwoFloat:
    """y_{n+1} pair from TwoFloat position/acceleration rings (kernel 2).

    ys/dd: TwoFloat of (ORDER, ..., 3) f32, newest first, aligned.  Returns
    a TwoFloat of shape (..., 3).  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    coef, c_y = _tables(tab, h)
    dev = ys.hi.device
    if dev.type == "cpu":
        return elm2f_update_plain(coef, c_y, ys, dd)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    shape = tuple(ys.hi.shape)
    order, m = shape[0], math.prod(shape[1:])
    if order != len(tab.c_y):
        raise ValueError(f"ring depth {order} != method order {len(tab.c_y)}")
    for name, x in (("ys.hi", ys.hi), ("ys.lo", ys.lo), ("dd.hi", dd.hi), ("dd.lo", dd.lo)):
        _check_f32(name, x, shape, dev)
    out_hi = torch.empty(shape[1:], dtype=torch.float32, device=dev)
    out_lo = torch.empty(shape[1:], dtype=torch.float32, device=dev)
    if m == 0:
        return TwoFloat(out_hi, out_lo)
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_elm2f_update(
            coef.ctypes.data, c_y.ctypes.data, order,
            ys.hi.data_ptr(), ys.lo.data_ptr(), dd.hi.data_ptr(), dd.lo.data_ptr(),
            out_hi.data_ptr(), out_lo.data_ptr(), m, stream,
        )
    _build.check(err, "elm2f_update")
    elm2f_update.launches += 1
    return TwoFloat(out_hi, out_lo)


elm2f_update.launches = 0
