"""Error-free transforms and two-float ("double-word") arithmetic in torch.

Port of ``ephemeris_explorer_tpu.ops.eft``: the subset the two hand-written
kernels' plain versions use.  A ``TwoFloat`` over f32 tensors carries ~49
bits; over f64 tensors ~106 bits.

Every function is eager elementwise torch, one rounding per op: nothing here
may be fused into a multiply-add, so there is no ``addcmul`` and this module
must never run under ``torch.compile``.  Constants are 0-dim CPU tensors of
the operand's dtype (:func:`const`), never Python floats, so each product
with a constant is rounded in that dtype; a 0-dim CPU tensor combines with
tensors on any device as a scalar, without a host-to-device copy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch


class TwoFloat(NamedTuple):
    """An unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype


@lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-dim CPU tensor holding ``value`` rounded once to ``dtype``."""
    return torch.tensor(value, dtype=dtype)


# ----------------------------------------------------------------------------
# Error-free transforms
# ----------------------------------------------------------------------------

def two_sum(a, b):
    """s + err == a + b exactly (Knuth/Moller, 6 flops, no branch)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err == a + b exactly, REQUIRES |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Dekker split of a into hi + lo, each with <= p/2 mantissa bits (exact)."""
    # 2^ceil(p/2) + 1 where p = mantissa bits (24 / 53)
    c = const(4097.0 if a.dtype == torch.float32 else 134217729.0, a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + err == a * b exactly (Dekker, FMA-free)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def two_sqr(a):
    """p + err == a * a exactly (one split, fewer cross terms)."""
    p = a * a
    hi, lo = split(a)
    err = ((hi * hi - p) + const(2.0, a.dtype) * (hi * lo)) + lo * lo
    return p, err


def two_prod_presplit(a, a_hi, a_lo, b, b_hi, b_lo):
    """two_prod with both operands' Dekker splits supplied (shared splits)."""
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


# ----------------------------------------------------------------------------
# TwoFloat arithmetic (Bailey/Hida QD-style, "accurate" variants)
# ----------------------------------------------------------------------------

def add(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return TwoFloat(*quick_two_sum(s, e))


def add_sloppy(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    """Cheaper two-float add: error ~3 ulp^2 instead of ~1 (no cancellation)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return TwoFloat(*quick_two_sum(s, e))


def add_float(x: TwoFloat, b) -> TwoFloat:
    """TwoFloat + plain float (tensor or 0-dim constant of x's dtype)."""
    s, e = two_sum(x.hi, b)
    e = e + x.lo
    return TwoFloat(*quick_two_sum(s, e))


def sub(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    return add(x, TwoFloat(-y.hi, -y.lo))


def mul(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return TwoFloat(*quick_two_sum(p, e))


def mul_float(x: TwoFloat, b) -> TwoFloat:
    """TwoFloat * plain float (tensor or 0-dim constant of x's dtype)."""
    p, e = two_prod(x.hi, b)
    e = e + x.lo * b
    return TwoFloat(*quick_two_sum(p, e))


def sqr(x: TwoFloat) -> TwoFloat:
    """x * x with the squaring shortcut."""
    p, e = two_sqr(x.hi)
    e = e + const(2.0, x.dtype) * (x.hi * x.lo)
    return TwoFloat(*quick_two_sum(p, e))


def mul_presplit(x: TwoFloat, xs, y: TwoFloat, ys) -> TwoFloat:
    """x * y where xs/ys are the precomputed splits of x.hi / y.hi."""
    p, e = two_prod_presplit(x.hi, xs[0], xs[1], y.hi, ys[0], ys[1])
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return TwoFloat(*quick_two_sum(p, e))


def where(cond, x: TwoFloat, y: TwoFloat) -> TwoFloat:
    return TwoFloat(torch.where(cond, x.hi, y.hi), torch.where(cond, x.lo, y.lo))
