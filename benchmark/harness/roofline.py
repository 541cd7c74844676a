"""Peaks of the card and the operations and bytes each kernel's work needs.

Counts are the algorithm's own, from shapes and from what the inputs need,
never from the program: an add, a multiply, a divide or a square root is
one operation, a fused multiply-add two; each input byte is read once and
each output byte written once.  A share of the roofline is the least time
the card could take (the larger of operations over the f64 peak and bytes
over the memory bandwidth) over the time the kernel took.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: f64 outside the
# tensor cores, and HBM3.
PEAK_F64 = 34e12          # FLOP/s
PEAK_BYTES = 3.35e12      # bytes/s
F64 = 8

# a pair's force: d = r_j - r_i (3), r^2 (3 multiplies, 2 adds), 1/sqrt(r^2)
# (a square root and a divide), 1/r^3 (2), mu_j / r^3 (1), a_i += d w (3 + 3)
PAIR_OPS = 19


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(ops / PEAK_F64, nbytes / PEAK_BYTES)


def share_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The roofline share in %, or None where nothing was measured."""
    if seconds <= 0.0 or ops <= 0.0:
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds


def accel_ensemble(members: int, bodies: int) -> tuple[float, float]:
    """(ops, bytes) of one force evaluation of every member: N (N - 1)
    pairs a member; positions and mu in, the forces out."""
    ops = members * bodies * (bodies - 1) * PAIR_OPS
    nbytes = (2 * members * bodies * 3 + bodies) * F64
    return float(ops), float(nbytes)


def elm2_update(c_y: list[float], c_dy: list[float], elements: int) -> tuple[float, float]:
    """(ops, bytes) of one multistep position update of ``elements`` values:
    a product and an add a nonzero coefficient of each sum (less the first
    add), then one product and one add to join them; the ring rows with a
    nonzero coefficient in, the new position out."""
    ny = sum(1 for c in c_y if c != 0.0)
    nd = sum(1 for c in c_dy if c != 0.0)
    ops = elements * ((2 * ny - 1) + (2 * nd - 1) + 2)
    nbytes = elements * (ny + nd + 1) * F64
    return float(ops), float(nbytes)


def ship_step_ops(stages: int, a_nonzero: int, b_nonzero: int, e_nonzero: int,
                  degrees: list[int]) -> float:
    """Operations of one accepted adaptive step of one ship, burns aside.

    Each stage: its state (6 components, a product and an add a nonzero
    a_sj), and the ship's gravity: every body's segment (t - start, a
    divide, ceil, less one; tau: a multiply, a subtract, a divide: 6), its
    position by Horner (2 a degree a component), then the pair terms
    (PAIR_OPS).  Then the new state and the error estimate (a product and an
    add a nonzero b_s or e_s, a component), and the error norm (12 divides,
    compares as none).  A burn's frame, over a few minutes of the plan, is
    left out: the count is a floor of what the step needs."""
    body = sum(6 + 6 * d + PAIR_OPS for d in degrees)
    per_stage = stages * body + 6 * 2 * a_nonzero
    return float(per_stage + 6 * 2 * (b_nonzero + e_nonzero) + 12)
