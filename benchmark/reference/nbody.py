"""Plain N-body stepping: the pair force, the SRKN startup and the ELM2 step.

The semantics the program is held to, written from the method's equations
in plain PyTorch, in any dtype and on any device:

* the Newtonian force a_i = sum_{j != i} mu_j (r_j - r_i) / |r_j - r_i|^3;
* Quinlan-Tremaine 12 (a second-order explicit linear multistep method,
  ``y_{n+1} = sum_j -alpha_{j+1} y_{n-j} + h^2 / beta_d sum_j beta_{j+1}
  a_{n-j}`` over a ring of the last 12 positions and forces, newest first),
  started by 12 steps of Blanes-Moan 6B (a symplectic kick-drift method,
  first-same-as-last) at h / 4;
* the Cowell velocity ``(y_n - y_{n-1}) / h + h / beta_d' sum_j beta'_j a_{n-j}``.

Every function takes numpy arrays (the 32-body scenes, stepped on the host,
where a call costs a microsecond) or torch tensors (the clusters, on the
card); nothing here reads the program.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from . import tableaux

ORDER = 12
SUBSTEPS = 4


def _floats(xs) -> list[float]:
    return [float(Fraction(x)) for x in xs]


_QT = tableaux.METHODS["QuinlanTremaine12"]
C_Y = [-a for a in _floats(_QT["alpha"][1:])]
C_DY = _floats(_QT["beta_n"][1:])
BETA_D = float(_QT["beta_d"])
COWELL_N = _floats(tableaux.COWELL[ORDER]["beta_n"])
COWELL_D = float(tableaux.COWELL[ORDER]["beta_d"])
_BM = tableaux.METHODS["BlanesMoan6B"]
BM_A = _floats(_BM["a"])
BM_B = _floats(_BM["b"])


def _stack(xs):
    return np.stack(xs) if isinstance(xs[0], np.ndarray) else torch.stack(xs)


def _shift(new, ring):
    """[new, ring[:-1]]: the ring after a step, newest first."""
    if isinstance(ring, np.ndarray):
        return np.concatenate([new[None], ring[:-1]])
    return torch.cat([new[None], ring[:-1]])


def _wsum(coef: list[float], ring):
    """sum_j coef[j] ring[j], folded from row 0 in ring order (newest
    first), rows with a zero coefficient skipped.  The order is part of the
    method's result: QT12's beta terms cancel ~1e9-fold, so another order's
    one-ulp differences grow to kilometres at Neptune within a year."""
    acc = ring[0] * coef[0]
    for j in range(1, len(coef)):
        if coef[j] != 0.0:
            acc = acc + ring[j] * coef[j]
    return acc


def accel(pos, mu, rows: int = 2048):
    """The pair force on every body of ``pos`` (..., N, 3), mu (N,): the
    direct sum over the other bodies, in blocks of ``rows`` receivers."""
    if pos.ndim > 2:
        return _stack([accel(p, mu, rows) for p in pos])
    if isinstance(pos, np.ndarray):
        d = pos[None, :, :] - pos[:, None, :]                # d[i, j] = r_j - r_i
        r2 = np.einsum("ijk,ijk->ij", d, d)
        np.fill_diagonal(r2, np.inf)                          # no self term
        inv = 1.0 / np.sqrt(r2)
        return np.einsum("ijk,ij->ik", d, mu * (inv * inv * inv))
    n = pos.shape[0]
    out = torch.empty_like(pos)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        d = pos[None, :, :] - pos[r0:r1, None, :]
        r2 = (d * d).sum(-1)
        i = torch.arange(r1 - r0, device=pos.device)
        r2[i, i + r0] = float("inf")
        inv = torch.rsqrt(r2)
        w = mu[None, :] * (inv * inv * inv)
        out[r0:r1] = (d * w[..., None]).sum(1)
    return out


def startup(pos, vel, mu, h: float, force=accel):
    """Twelve Blanes-Moan 6B steps of SUBSTEPS sub-steps: (ys, ddys, vel),
    the rings newest first ([y_12 .. y_1]) and the velocity at y_12."""
    hs = h / SUBSTEPS
    y, dy = pos, vel
    ddy = force(y, mu)
    ys, ddys = [], []
    for _ in range(ORDER):
        for _ in range(SUBSTEPS):
            for s in range(len(BM_A)):
                if s > 0:
                    ddy = force(y, mu)
                if BM_B[s] != 0.0:
                    dy = dy + ddy * (hs * BM_B[s])
                if BM_A[s] != 0.0:
                    y = y + dy * (hs * BM_A[s])
        ys.append(y)
        ddys.append(ddy)
    return _stack(ys[::-1]), _stack(ddys[::-1]), dy


def step(ys, ddys, mu, h: float, force=accel):
    """One QT12 step on rings (ORDER, ...): the shifted rings."""
    y = _wsum(C_Y, ys) + _wsum(C_DY, ddys) * (h * h / BETA_D)
    return _shift(y, ys), _shift(force(y, mu), ddys)


def velocity(ys, ddys, h: float):
    """The Cowell velocity at the ring's newest position."""
    return (ys[0] - ys[1]) / h + _wsum(COWELL_N, ddys) * (h / COWELL_D)
