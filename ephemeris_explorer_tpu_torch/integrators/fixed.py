"""Fixed-step Runge-Kutta steppers on torch tensors.

Port of ``ephemeris_explorer_tpu.integrators.fixed`` (the subset the
generation path runs): :func:`erk_step` (explicit.rs:73-106) and
:func:`srkn_step`, the symplectic kick-drift Nystrom step
(symplectic.rs:70-102) with FSAL handled by threading the last acceleration
through the caller.  ``y`` is a tensor or a tuple of tensors; the time ``t``
is a host Python float.
"""

from __future__ import annotations

from .methods import ERKTableau, SRKNTableau


def _axpy(c, x, y):
    """y + c * x over a tensor or a tuple of tensors (c a scalar)."""
    c = float(c)
    if isinstance(y, tuple):
        return tuple(yi + c * xi for xi, yi in zip(x, y))
    return y + c * x


def eval_accel(accel, t, y, dy):
    """Evaluate a second-order RHS; an ``accel`` marked ``needs_velocity``
    also receives the current velocity."""
    if getattr(accel, "needs_velocity", False):
        return accel(t, y, dy)
    return accel(t, y)


def erk_step(tab: ERKTableau, f, t, y, h, k0=None):
    """One explicit RK step; returns (t_next, y_next, ks)."""
    ks = []
    for s in range(tab.stages):
        if s == 0 and tab.fsal and k0 is not None:
            ks.append(k0)
            continue
        yi = y
        for j in range(s):
            if tab.a[s, j] != 0.0:
                yi = _axpy(h * tab.a[s, j], ks[j], yi)
        ks.append(f(t + h * tab.c[s], yi))
    y_next = y
    for s in range(tab.stages):
        if tab.b[s] != 0.0:
            y_next = _axpy(h * tab.b[s], ks[s], y_next)
    return t + h, y_next, ks


def srkn_step(tab: SRKNTableau, accel, t, y, dy, h, ddy0=None):
    """One symplectic kick-drift step for y'' = accel(t, y).

    Per stage s: optionally ddy = accel(t + c_s h, y), then dy += ddy h B[s];
    y += dy h A[s].  With ``tab.fsal`` and ``ddy0`` given, stage 0 reuses
    ``ddy0``.  Returns (t_next, y_next, dy_next, ddy_last).
    """
    ddy = None
    for s in range(tab.stages):
        if s == 0 and tab.fsal and ddy0 is not None:
            ddy = ddy0
        else:
            ddy = eval_accel(accel, t + h * tab.c[s], y, dy)
        if tab.b[s] != 0.0:
            dy = _axpy(h * tab.b[s], ddy, dy)
        if tab.a[s] != 0.0:
            y = _axpy(h * tab.a[s], dy, y)
    return t + h, y, dy, ddy
