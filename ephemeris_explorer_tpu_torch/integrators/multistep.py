"""Explicit second-order linear multistep (ELM2) steps on torch tensors.

Port of the ELM2 subset of ``ephemeris_explorer_tpu.integrators.multistep``
(``integration/src/multistep/second_order``):

* ELM2 position update  y_{n+1} = sum_j c_y[j] y_{n-j}
                                 + h^2/beta_d * sum_j c_dy[j] ddy_{n-j}
                                              (second_order/mod.rs:91-131)
* Cowell velocity  dy_n = (y_n - y_{n-1})/h + h/cbeta_d * sum_j cbeta[j] ddy_{n-j}
                                              (second_order/cowell.rs:19-53)

The ring of past states is a dense (ORDER, ...) tensor, newest first.  The
JAX ``lax.scan`` loops become Python step loops; the time ``t`` is a host
Python float, and nothing in a step synchronises with the device.

The two-float carry :class:`ELM2CarryF` keeps positions and the force ring
as (hi, lo) f32 pairs and updates them with kernel 2
(:func:`..ops.cuda_elm2.elm2f_update`).  The JAX package's sublane-packed
``ELM2CarryFP`` is a TPU layout of the same numbers and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.eft import TwoFloat
from .fixed import eval_accel, srkn_step
from .methods import ELMTableau, get

_COEF_CACHE: dict = {}


def _coef(values, like: torch.Tensor) -> torch.Tensor:
    """Tableau coefficients as a tensor on ``like``'s device and dtype, cached
    so a step never copies from the host."""
    values = np.asarray(values, dtype=np.float64)
    key = (values.tobytes(), like.dtype, like.device)
    t = _COEF_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(values, dtype=like.dtype, device=like.device)
        _COEF_CACHE[key] = t
    return t


def _wsum(coeffs: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    shape = (-1,) + (1,) * (stack.dim() - 1)
    return (coeffs.reshape(shape) * stack).sum(0)


class ELM2Carry(NamedTuple):
    t: float                # current time (seconds)
    ys: torch.Tensor        # (ORDER, ...) positions, most recent first
    ddys: torch.Tensor      # (ORDER, ...) accelerations at those positions
    dy: torch.Tensor        # current velocity

    @property
    def y(self) -> torch.Tensor:
        return self.ys[0]


def elm2_startup_scan(tab: ELMTableau, accel, t0, y0, dy0, h):
    """ORDER starter full steps of ``tab.substeps`` sub-steps each.

    Returns (t, dy, ys_fwd, ddys_fwd) with ys_fwd[k] = y_{k+1} in FORWARD
    order.  For FSAL SRKN starters the carried acceleration IS accel(t, y)
    at the full-step boundary, so it is recorded without a re-evaluation.
    """
    assert tab.kind == "elm2"
    starter = get(tab.starter)
    hs = h / tab.substeps
    t, y, dy = float(t0), y0, dy0
    ddy = eval_accel(accel, t, y, dy)
    ys, ddys = [], []
    for _ in range(tab.order):
        for _ in range(tab.substeps):
            t, y, dy, ddy = srkn_step(
                starter, accel, t, y, dy, hs, ddy if starter.fsal else None
            )
        ys.append(y)
        ddys.append(ddy if starter.fsal else eval_accel(accel, t, y, dy))
    return t, dy, torch.stack(ys), torch.stack(ddys)


def elm2_init(tab: ELMTableau, accel, t0, y0, dy0, h) -> ELM2Carry:
    """Startup: ORDER starter steps; the carry holds [y_ORDER .. y_1]."""
    t, dy, ys, ddys = elm2_startup_scan(tab, accel, t0, y0, dy0, h)
    return ELM2Carry(t=t, ys=ys.flip(0), ddys=ddys.flip(0), dy=dy)


def elm2_step(
    tab: ELMTableau, accel, h, carry: ELM2Carry, with_velocity: bool = True
) -> ELM2Carry:
    """One fixed multistep step (one force evaluation).

    ``with_velocity=False`` leaves ``dy`` stale (the position update never
    reads it); :func:`elm2_velocity` restores it at sample/chunk boundaries.
    """
    assert with_velocity or not getattr(accel, "needs_velocity", False), (
        "with_velocity=False requires a velocity-independent force"
    )
    ys = carry.ys
    sum1 = _wsum(_coef(tab.c_y, ys), ys)
    sum2 = _wsum(_coef(tab.c_dy, ys), carry.ddys)
    y_new = sum1 + sum2 * (h * h / tab.beta_d)
    t_new = carry.t + h
    ddy_new = eval_accel(accel, t_new, y_new, carry.dy)

    ddys_new = torch.cat([ddy_new[None], carry.ddys[: tab.order - 1]])
    if with_velocity:
        vel_sum = _wsum(_coef(tab.cowell_beta_n, ys), ddys_new)
        dy_new = (y_new - ys[0]) / h + vel_sum * (h / tab.cowell_beta_d)
    else:
        dy_new = carry.dy
    ys_new = torch.cat([y_new[None], ys[: tab.order - 1]])
    return ELM2Carry(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


def elm2_velocity(tab: ELMTableau, carry: ELM2Carry, h) -> torch.Tensor:
    """Cowell velocity at the carry's current step, from positions + forces."""
    vel_sum = _wsum(_coef(tab.cowell_beta_n, carry.ddys), carry.ddys)
    return (carry.ys[0] - carry.ys[1]) / h + vel_sum * (h / tab.cowell_beta_d)


# ---------------------------------------------------------------------------
# Two-float carry: the f64-equivalent state as (hi, lo) f32 pairs
# ---------------------------------------------------------------------------


class ELM2CarryF(NamedTuple):
    t: float
    ys: TwoFloat            # (ORDER, ..., 3) f32 pair ring, newest first
    dd: TwoFloat            # (ORDER, ..., 3) f32 pair ring, dd[j] = f(ys[j])
    dy: torch.Tensor        # base-precision velocity (stale during scans)


def _split_pair(x: torch.Tensor) -> TwoFloat:
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return TwoFloat(hi, lo)


def elm2_f_from(carry: ELM2Carry) -> ELM2CarryF:
    """Exact conversion of an f64 carry (hi + lo == the f64 values)."""
    return ELM2CarryF(
        t=carry.t, ys=_split_pair(carry.ys), dd=_split_pair(carry.ddys), dy=carry.dy
    )


def elm2_f_to(carry: ELM2CarryF) -> ELM2Carry:
    def comb(p: TwoFloat) -> torch.Tensor:
        return p.hi.to(torch.float64) + p.lo.to(torch.float64)

    return ELM2Carry(t=carry.t, ys=comb(carry.ys), ddys=comb(carry.dd), dy=carry.dy)


def elm2_step_f(tab: ELMTableau, accel_pair, h, carry: ELM2CarryF) -> ELM2CarryF:
    """One fused two-float multistep step: kernel 2 for the position update.

    ``accel_pair(t, y: TwoFloat) -> TwoFloat`` evaluates the force from a
    pair-state position of shape (..., 3) (e.g. kernel 1 through
    :func:`..ops.cuda_nbody.pairwise_accel_df64`).  Velocity is deferred
    (:func:`elm2_velocity_f`).
    """
    from ..ops.cuda_elm2 import elm2f_update

    y_new = elm2f_update(tab, h, carry.ys, carry.dd)
    t_new = carry.t + h
    f_new = accel_pair(t_new, y_new)

    def shift(new, ring):
        return torch.cat([new[None], ring[: tab.order - 1]])

    return ELM2CarryF(
        t=t_new,
        ys=TwoFloat(shift(y_new.hi, carry.ys.hi), shift(y_new.lo, carry.ys.lo)),
        dd=TwoFloat(shift(f_new.hi, carry.dd.hi), shift(f_new.lo, carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_velocity_f(tab: ELMTableau, carry: ELM2CarryF, h) -> torch.Tensor:
    return elm2_velocity(tab, elm2_f_to(carry), h)
