"""Kernel 4: the 4-limb expansion ELM2 update, its plain version and wrapper.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_elm2.elm2q_update`` (TPU
kernel ``_update_kernel``) in both of its modes, and of
``elm2_update_coeffs_precise``.  The CUDA source is ``csrc/elm2q_update.cu``;
its header note says what bounds it on an H100 and how the design answers
that.

:func:`elm2q_update` and its packed entry point :func:`elm2q_update_packed`
(``elm2q_update_packed``, the rings stored (ORDER, SUB, M/SUB)) take the
plain PyTorch version (:func:`elm2q_update_plain`) only for CPU tensors; on
CUDA tensors they launch the kernel or raise.  ``elm2q_update.launches`` and
``elm2q_update_packed.launches`` count their kernel launches.  The kernel
and the plain version run the same ops in the same order, so they agree
bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from . import eft
from . import expansion as ex
from .cuda_elm2 import elm2_update_coeffs
from .cuda_nbody import _check_input, on_device
from .eft import TwoFloat


def elm2_update_coeffs_precise(tab, h: float) -> np.ndarray:
    """The (order, 3) pre-scaled 3-limb weight table of the precise beta sum:
    w_j = c_dy[j] * h^2/beta_d rounded once on the host, split exactly into
    three f32 limbs (multistep._precise_weights, shared with the unfused
    step's precise sums)."""
    from ..integrators.multistep import _precise_weights

    return np.asarray(_precise_weights(tab.c_dy, float(h) * float(h), float(tab.beta_d)),
                      dtype=np.float32)


_TABLES: dict = {}


def _tables(tab, h: float, precise: bool):
    """(coefficient table, f32 c_y, nonzero c_dy rows) for a tableau, step
    and mode, cached: the update runs every step and its host work should
    stay small."""
    key = (tab.name, tab.c_y.tobytes(), tab.c_dy.tobytes(), float(tab.beta_d), float(h), precise)
    out = _TABLES.get(key)
    if out is None:
        assert all(abs(c) in (0.0, 1.0, 2.0) for c in tab.c_y), tab.name
        coef = elm2_update_coeffs_precise(tab, h) if precise else elm2_update_coeffs(tab, h)
        nonzero = tuple(j for j, c in enumerate(tab.c_dy) if float(c) != 0.0)
        out = (np.ascontiguousarray(coef), np.asarray(tab.c_y, dtype=np.float32), nonzero)
        _TABLES[key] = out
    return out


def elm2q_update_plain(coef: np.ndarray, c_y: np.ndarray, nonzero, ys: tuple, dd: TwoFloat,
                       precise: bool = False) -> tuple:
    """Plain PyTorch version of kernel 4, on any device.

    coef: (order + 1, 2) f32 split table (plain, :func:`elm2_update_coeffs`)
    or (order, 3) f32 weight limbs (precise, :func:`elm2_update_coeffs_precise`);
    c_y: (order,) f32 alpha weights; nonzero: the rows with c_dy != 0;
    ys: 4-tuple of (order, ...) f32 limb rings; dd: TwoFloat of (order, ...)
    f32 rings; newest first.  Returns the 4-tuple of limbs of y_{n+1}.
    """
    order = ys[0].shape[0]
    cf = torch.from_numpy(coef)  # rows of 0-dim CPU constants
    if precise:
        inc = None
        for j in nonzero:
            hi_j, lo_j = dd.hi[j], dd.lo[j]
            b0, b1, b2 = cf[j, 0], cf[j, 1], cf[j, 2]
            p, pe = eft.two_prod(hi_j, b0)
            q, qe = eft.two_prod(lo_j, b0)
            r, re = eft.two_prod(hi_j, b1)
            s = qe + re + lo_j * b1 + hi_j * b2
            term = ex.renorm(p, pe, q, r, s)
            inc = term if inc is None else ex.add(inc, term)
    else:
        acc = None
        for j in nonzero:
            term = eft.mul(TwoFloat(dd.hi[j], dd.lo[j]), TwoFloat(cf[j, 0], cf[j, 1]))
            acc = term if acc is None else eft.add(acc, term)
        acc = eft.mul(acc, TwoFloat(cf[order, 0], cf[order, 1]))
        inc = ex.from_two(acc.hi, acc.lo)
    total = None
    for j in range(order):
        if c_y[j] == 0.0:
            continue
        term = ex.scale_pow2i(tuple(l[j] for l in ys), float(c_y[j]))
        total = term if total is None else ex.add(total, term)
    return ex.add(total, inc)


def _update(tab, h: float, ys: tuple, dd: TwoFloat, precise: bool):
    """(y_{n+1} limbs, launched): the plain version on CPU tensors, kernel 4
    on CUDA tensors of any trailing shape, flattened to M elements."""
    coef, c_y, nonzero = _tables(tab, h, precise)
    dev = ys[0].device
    if dev.type == "cpu":
        return elm2q_update_plain(coef, c_y, nonzero, ys, dd, precise), False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    shape = tuple(ys[0].shape)
    order, m = shape[0], math.prod(shape[1:])
    if order != len(tab.c_y):
        raise ValueError(f"ring depth {order} != method order {len(tab.c_y)}")
    if len(ys) != ex.K:
        raise ValueError(f"expected {ex.K} limbs, got {len(ys)}")
    for name, x in (*((f"ys[{i}]", l) for i, l in enumerate(ys)),
                    ("dd.hi", dd.hi), ("dd.lo", dd.lo)):
        _check_input(name, x, shape, dev)
    out = tuple(torch.empty(shape[1:], dtype=torch.float32, device=dev) for _ in range(ex.K))
    if m == 0:
        return out, False
    mask = sum(1 << j for j in nonzero)
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_elm2q_update(
            coef.ctypes.data, int(precise), c_y.ctypes.data, order, mask,
            *(l.data_ptr() for l in ys), dd.hi.data_ptr(), dd.lo.data_ptr(),
            *(o.data_ptr() for o in out), m, stream,
        )
    _build.check(err, "elm2q_update")
    return out, True


def elm2q_update(tab, h: float, ys: tuple, dd: TwoFloat, precise: bool = False) -> tuple:
    """y_{n+1} limbs from the aligned position/acceleration rings (kernel 4).

    ys: 4-tuple of (ORDER, ..., 3) f32 limb tensors; dd: TwoFloat of the same
    shape, dd[j] = f(ys[j]); newest first.  Returns a 4-tuple of (..., 3)
    limbs.  ``precise``: the pair-precision beta sum.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    y, launched = _update(tab, h, ys, dd, precise)
    elm2q_update.launches += launched
    return y


elm2q_update.launches = 0


def elm2q_update_packed(tab, h: float, ys: tuple, dd: TwoFloat, precise: bool = False) -> tuple:
    """y_{n+1} limbs from packed rings (kernel 4 through its packed entry
    point, the JAX package's ``elm2q_update_packed``).

    ys: 4-tuple of (ORDER, SUB, M/SUB) f32 limb rings; dd: TwoFloat of the
    same packed shape; newest first.  Returns a 4-tuple of (SUB, M/SUB)
    limbs, bitwise equal to :func:`elm2q_update` on the unpacked view.  As
    for kernel 2's packed entry point (``cuda_elm2.elm2f_update_packed``),
    the TPU's sublane packing has no counterpart in a flat CUDA grid and the
    packed ring is the flat ring's memory, so kernel 4's launch serves both
    layouts.  ``elm2q_update_packed.launches`` counts this entry point's
    launches apart from :func:`elm2q_update`'s.
    """
    y, launched = _update(tab, h, ys, dd, precise)
    elm2q_update_packed.launches += launched
    return y


elm2q_update_packed.launches = 0
