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
(:func:`..ops.cuda_elm2.elm2f_update`).  The expansion-state carries keep
positions as 4-limb f32 expansions: :class:`ELM2CarryQ` (f64 force ring,
:func:`elm2_step_q`, the extended generation precisions) and
:class:`ELM2CarryQF` (pair force ring, :func:`elm2_step_qf`, the position
update in kernel 4, :func:`..ops.cuda_elm2q.elm2q_update`).  The packed
carries :class:`ELM2CarryFP` and :class:`ELM2CarryQFP` store the same rings
as (ORDER, SUB, M/SUB), the JAX package's sublane layout, and step through
the packed entry points of kernels 2 and 4.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import eft
from ..ops import expansion as ex
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


# ---------------------------------------------------------------------------
# Packed carries: rings stored (ORDER, SUB, M/SUB) across steps
# ---------------------------------------------------------------------------
#
# The JAX package stores these rings with every logical row split over the
# TPU's 8 sublanes.  On the card the packed ring is the same contiguous
# memory as the flat (ORDER, M) ring, so the packed update entry points
# launch kernels 2 and 4 unchanged.  The step is the reference's: the ring
# shift is a cat in packed layout, and only y_new and f_new cross the
# packed <-> logical boundary, one row each way per step.

_PACK_SUB = 8


def _pack_ring(x: torch.Tensor, sub: int) -> torch.Tensor:
    """(ORDER, ...) ring -> (ORDER, SUB, M/SUB)."""
    return x.reshape(x.shape[0], sub, -1)


class ELM2CarryFP(NamedTuple):
    t: float
    ys: TwoFloat            # (ORDER, SUB, M/SUB) f32 pair ring, newest first
    dd: TwoFloat            # (ORDER, SUB, M/SUB) f32 pair ring
    dy: torch.Tensor        # base-precision velocity (stale during scans)


def elm2_fp_from(carry: ELM2CarryF, sub: int = _PACK_SUB) -> ELM2CarryFP:
    """Pack an ELM2CarryF's rings (a reshape; exact)."""
    return ELM2CarryFP(
        t=carry.t,
        ys=TwoFloat(_pack_ring(carry.ys.hi, sub), _pack_ring(carry.ys.lo, sub)),
        dd=TwoFloat(_pack_ring(carry.dd.hi, sub), _pack_ring(carry.dd.lo, sub)),
        dy=carry.dy,
    )


def elm2_fp_to(carry: ELM2CarryFP, shape: tuple) -> ELM2CarryF:
    """Unpack back to the logical row shape (e.g. (N, 3) or (E, N, 3))."""
    o = carry.ys.hi.shape[0]

    def unp(x):
        return x.reshape((o, *shape))

    return ELM2CarryF(
        t=carry.t,
        ys=TwoFloat(unp(carry.ys.hi), unp(carry.ys.lo)),
        dd=TwoFloat(unp(carry.dd.hi), unp(carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_step_fp(tab: ELMTableau, accel_pair, h, carry: ELM2CarryFP, shape: tuple) -> ELM2CarryFP:
    """One fused two-float step on the packed carry: kernel 2 through its
    packed entry point (:func:`..ops.cuda_elm2.elm2f_update_packed`).

    ``shape`` is the logical row shape the force expects;
    ``accel_pair(t, y: TwoFloat(shape)) -> TwoFloat(shape)`` as in
    :func:`elm2_step_f`.  Bitwise equal to :func:`elm2_step_f` on the
    unpacked view.  Velocity is deferred (:func:`elm2_velocity_fp`).
    """
    from ..ops.cuda_elm2 import elm2f_update_packed

    y_new = elm2f_update_packed(tab, h, carry.ys, carry.dd)
    t_new = carry.t + h
    f_rows = accel_pair(t_new, TwoFloat(y_new.hi.reshape(shape), y_new.lo.reshape(shape)))
    psh = y_new.hi.shape
    f_new = TwoFloat(f_rows.hi.reshape(psh), f_rows.lo.reshape(psh))

    def shift(new, ring):
        return torch.cat([new[None], ring[: tab.order - 1]])

    return ELM2CarryFP(
        t=t_new,
        ys=TwoFloat(shift(y_new.hi, carry.ys.hi), shift(y_new.lo, carry.ys.lo)),
        dd=TwoFloat(shift(f_new.hi, carry.dd.hi), shift(f_new.lo, carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_velocity_fp(tab: ELMTableau, carry: ELM2CarryFP, h, shape: tuple) -> torch.Tensor:
    return elm2_velocity_f(tab, elm2_fp_to(carry, shape), h)


# ---------------------------------------------------------------------------
# Expansion state: positions as 4-limb f32 expansions (ops.expansion)
# ---------------------------------------------------------------------------
#
# The position ring is a K-tuple of (ORDER, ..., 3) f32 limb tensors (~2^-90);
# the ELM2 alpha combination uses exact +-2^k scalings and expansion adds, and
# only the h^2 increment passes through base precision (or, with precise
# sums, through an error-free cascade).  The three leading limbs feed the
# 3-limb force (kernel 3, ops.cuda_limbs).


class ELM2CarryQ(NamedTuple):
    t: float
    ys: tuple               # K-tuple of (ORDER, ..., 3) f32 limb tensors
    ddys: torch.Tensor      # (ORDER, ..., 3) base-precision accelerations
    dy: torch.Tensor        # base-precision velocity


def _exp_wsum_alpha(c_y, ys: tuple) -> tuple:
    """sum_j c_y[j] * ys[j] with c_y in {+-1, +-2} (exact scalings)."""
    acc = None
    for j in range(ys[0].shape[0]):
        c = float(c_y[j])
        if c == 0.0:
            continue
        term = ex.scale_pow2i(tuple(l[j] for l in ys), c)
        acc = term if acc is None else ex.add(acc, term)
    return acc


def _srkn_step_q(tab, accel_q, t, y: tuple, dy, h, ddy0):
    """Symplectic kick-drift startup step: y an expansion, dy base f64.

    The drift increment dy*(h*A) is formed in base precision and
    expansion-added, so the position itself is never rounded to f64.
    ``accel_q(t, y_expansion, dy)`` evaluates the force from the expansion.
    """
    ddy = None
    for s in range(tab.stages):
        if s == 0 and tab.fsal and ddy0 is not None:
            ddy = ddy0
        else:
            ddy = accel_q(t + h * tab.c[s], y, dy)
        if tab.b[s] != 0.0:
            dy = dy + ddy * (h * tab.b[s])
        if tab.a[s] != 0.0:
            y = ex.add(y, ex.from_f64(dy * (h * tab.a[s])))
    return t + h, y, dy, ddy


def elm2_init_q(
    tab: ELMTableau, accel, t0, y0, dy0, h, accel_limbs=None, y0_limbs=None
) -> ELM2CarryQ:
    """Expansion-state startup: starter sub-steps with expansion positions.

    ``y0_limbs`` (a K-tuple of f32 limb tensors, e.g. from
    :func:`..ops.expansion.from_f64_host`) supplies the initial position
    exactly; without it ``y0`` is lifted with ``ex.from_f64``.  When
    ``accel_limbs(t, (l0, l1, l2))`` (velocity-independent; perturbations are
    not ported) is given, every startup force sees the
    three leading limbs instead of the f64-rounded position (the same limb
    force the main scan uses); otherwise ``accel(t, y_f64)``.
    """
    starter = get(tab.starter)
    hs = h / tab.substeps
    y = tuple(y0_limbs) if y0_limbs is not None else ex.from_f64(y0)

    if accel_limbs is not None:
        def accel_q(t, y_exp, dy):
            return accel_limbs(t, (y_exp[0], y_exp[1], y_exp[2]))
    else:
        def accel_q(t, y_exp, dy):
            return eval_accel(accel, t, ex.to_f64(y_exp), dy)

    t, dy = float(t0), dy0
    ddy = accel_q(t, y, dy)
    ys, ddys = [], []
    for _ in range(tab.order):
        for _ in range(tab.substeps):
            t, y, dy, ddy = _srkn_step_q(
                starter, accel_q, t, y, dy, hs, ddy if starter.fsal else None
            )
        ys.append(y)
        ddys.append(ddy if starter.fsal else accel_q(t, y, dy))
    return ELM2CarryQ(
        t=t,
        ys=tuple(torch.stack([yk[i] for yk in ys[::-1]]) for i in range(ex.K)),
        ddys=torch.stack(ddys[::-1]),
        dy=dy,
    )


def _split3_host(w: float):
    """Exact host-side split of one f64 value into three f32 limbs."""
    c0 = np.float32(w)
    r = w - float(c0)
    c1 = np.float32(r)
    c2 = np.float32(r - float(c1))
    return float(c0), float(c1), float(c2)


def _prescale_f128(coeffs, num: float, den: float) -> list:
    """w_j = coeffs[j] * num / den with ONE f64 rounding each (the host's
    extended ``longdouble``), folding h^2/beta_d (or h/cowell_beta_d) into
    the weights so the weighted sum yields the increment directly."""
    n128, d128 = np.longdouble(num), np.longdouble(den)
    return [float(np.float64(np.longdouble(float(c)) * n128 / d128)) for c in coeffs]


def _dekker_split_f32_host(v: float):
    """Host twin of eft.split for f32 (splitter 2^12 + 1), exact."""
    a = np.float32(v)
    c = np.float32(4097.0) * a
    hi = c - (c - a)
    lo = a - hi
    return float(hi), float(lo)


def _two_sum_reduce(vals: torch.Tensor):
    """Error-free tree sum along axis 0: (root, error terms).

    ``root + sum(errs) == sum(vals)`` exactly: every two_sum rounding is kept
    in ``errs`` (a list of tensors totalling M-1 rows for M inputs); each
    tree level is one vectorised two_sum on a halved tensor.
    """
    errs = []
    cur = vals
    while cur.shape[0] > 1:
        half = cur.shape[0] // 2
        s, e = eft.two_sum(cur[:half], cur[half : 2 * half])
        errs.append(e)
        cur = torch.cat([s, cur[2 * half :]]) if cur.shape[0] % 2 else s
    return cur[0], errs


_PRECISE_WEIGHTS: dict = {}


def _precise_weights(coeffs, num: float, den: float) -> tuple:
    """The weights coeffs[j] * num / den rounded once (_prescale_f128), each
    split exactly into three f32 limbs (_split3_host): one (b0, b1, b2) per
    row, cached per (coefficients, num, den).  Both precise beta sums build
    from it: _wsum_precise's device constants and kernel 4's table
    (ops.cuda_elm2q.elm2_update_coeffs_precise)."""
    key = (np.asarray(coeffs, np.float64).tobytes(), float(num), float(den))
    limbs = _PRECISE_WEIGHTS.get(key)
    if limbs is None:
        limbs = tuple(_split3_host(w) for w in _prescale_f128(coeffs, num, den))
        _PRECISE_WEIGHTS[key] = limbs
    return limbs


_WEIGHT_LIMBS: dict = {}


def _weight_limbs(weight_limbs: tuple, ndim: int, device):
    """(rows, constants) for _wsum_precise, cached per device so that a step
    never copies from the host: ``rows`` indexes the nonzero weights (None
    when all are), ``constants`` are their (J, 1, ...) f32 limbs b0, b1, b2
    and the Dekker splits of b0 and b1."""
    key = (weight_limbs, ndim, device)
    out = _WEIGHT_LIMBS.get(key)
    if out is None:
        idx = [j for j, w in enumerate(weight_limbs) if any(w)]
        rows = None if len(idx) == len(weight_limbs) else torch.as_tensor(idx, device=device)
        limbs = [weight_limbs[j] for j in idx]
        bshape = (len(idx),) + (1,) * (ndim - 1)

        def dev(vals):
            return torch.as_tensor(np.array(vals, np.float32).reshape(bshape), device=device)

        b0h, b0l = zip(*(_dekker_split_f32_host(l[0]) for l in limbs))
        b1h, b1l = zip(*(_dekker_split_f32_host(l[1]) for l in limbs))
        out = rows, tuple(dev(v) for v in ([l[0] for l in limbs], [l[1] for l in limbs],
                                           [l[2] for l in limbs], b0h, b0l, b1h, b1l))
        _WEIGHT_LIMBS[key] = out
    return out


def _wsum_precise(weight_limbs, dd_hi: torch.Tensor, dd_lo: torch.Tensor) -> tuple:
    """sum_j w_j * (dd_hi[j] + dd_lo[j]) as a 4-limb f32 expansion, for
    weights w_j given as their exact three-f32-limb splits ``weight_limbs``
    (one (b0, b1, b2) per row, :func:`_precise_weights`).

    The beta rows cancel ~29x (QT12 c_dy), so an f64 dot loses ~2^-53 x 29
    of the result per step.  Here each term is formed with exact f32
    two_prods against the weight limbs and the terms
    accumulate through a cascaded error-free reduction by magnitude class:

      level 1: exact tree sum of the leading products p          (~|term|)
      level 2: exact tree sum of {level-1 roundings, pe, q, r}   (~2^-24)
      level 3: exact tree sum of {level-2 roundings, s}          (~2^-48)
      level 4: plain f32 sum of the level-3 roundings            (~2^-62)

    so the only rounding is level 4's, ~2^-80 of the largest term.  The JAX
    package routes its XLA:CPU traces to a native-f64 dot because that
    compiler folds the cascade; eager torch rounds each op on its own, so
    the cascade runs as written on every device.
    """
    rows, consts = _weight_limbs(tuple(weight_limbs), dd_hi.dim(), dd_hi.device)
    if rows is not None:
        dd_hi, dd_lo = dd_hi.index_select(0, rows), dd_lo.index_select(0, rows)
    b0, b1, b2, b0h, b0l, b1h, b1l = consts

    hi_h, hi_l = eft.split(dd_hi)
    lo_h, lo_l = eft.split(dd_lo)
    p, pe = eft.two_prod_presplit(dd_hi, hi_h, hi_l, b0, b0h, b0l)
    q, qe = eft.two_prod_presplit(dd_lo, lo_h, lo_l, b0, b0h, b0l)
    r, re = eft.two_prod_presplit(dd_hi, hi_h, hi_l, b1, b1h, b1l)
    s = qe + re + dd_lo * b1 + dd_hi * b2

    s1, e1 = _two_sum_reduce(p)
    s2, e2 = _two_sum_reduce(torch.cat([*e1, pe, q, r]))
    s3, e3 = _two_sum_reduce(torch.cat([*e2, s]))
    s4 = torch.cat(e3).sum(0) if e3 else torch.zeros_like(s3)

    h1, t1 = eft.two_sum(s1, s2)
    h2, t2 = eft.two_sum(t1, s3)
    return (h1, h2, t2 + s4, torch.zeros_like(h1))


def _velocity_q(tab, y_now, y_prev, ddys, h, precise_sums: bool) -> torch.Tensor:
    diff = ex.to_f64(ex.add(y_now, ex.neg(y_prev))) / h
    if precise_sums:
        wv = _precise_weights(tab.cowell_beta_n, float(h), float(tab.cowell_beta_d))
        ddv = _split_pair(ddys)
        return diff + ex.to_f64(_wsum_precise(wv, ddv.hi, ddv.lo))
    return diff + _wsum(_coef(tab.cowell_beta_n, ddys), ddys) * (h / tab.cowell_beta_d)


def elm2_step_q(
    tab: ELMTableau,
    accel,
    h,
    carry: ELM2CarryQ,
    accel_limbs=None,
    with_velocity: bool = True,
    precise_sums: bool = False,
) -> ELM2CarryQ:
    """One multistep step on the expansion state (one force evaluation).

    ``accel(t, y_f64)`` sees the f64 rounding of the expansion position;
    ``accel_limbs(t, (l0, l1, l2))`` (kernel 3 through
    :func:`..ops.cuda_limbs.pairwise_accel_limbs`; velocity-independent)
    sees its three leading limbs.  ``with_velocity=False`` defers the Cowell velocity to
    :func:`elm2_velocity_q` (velocity-independent forces only).
    ``precise_sums`` computes the beta sum with :func:`_wsum_precise` over
    the (hi, lo) pair view of the acceleration ring instead of an f64 dot.
    """
    assert all(abs(c) in (0.0, 1.0, 2.0) for c in tab.c_y), tab.name
    sum1 = _exp_wsum_alpha(tab.c_y, carry.ys)
    if precise_sums:
        w = _precise_weights(tab.c_dy, float(h) * float(h), float(tab.beta_d))
        dd = _split_pair(carry.ddys)
        y_new = ex.add(sum1, _wsum_precise(w, dd.hi, dd.lo))
    else:
        sum2 = _wsum(_coef(tab.c_dy, carry.ddys), carry.ddys)
        y_new = ex.add(sum1, ex.from_f64(sum2 * (h * h / tab.beta_d)))
    t_new = carry.t + h

    if accel_limbs is not None:
        ddy_new = accel_limbs(t_new, (y_new[0], y_new[1], y_new[2]))
    else:
        assert with_velocity or not getattr(accel, "needs_velocity", False), (
            "with_velocity=False requires a velocity-independent force"
        )
        ddy_new = eval_accel(accel, t_new, ex.to_f64(y_new), carry.dy)

    ddys_new = torch.cat([ddy_new[None], carry.ddys[: tab.order - 1]])
    if with_velocity:
        y_prev = tuple(l[0] for l in carry.ys)
        dy_new = _velocity_q(tab, y_new, y_prev, ddys_new, h, precise_sums)
    else:
        dy_new = carry.dy
    ys_new = tuple(
        torch.cat([nl[None], ol[: tab.order - 1]]) for nl, ol in zip(y_new, carry.ys)
    )
    return ELM2CarryQ(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


def elm2_velocity_q(
    tab: ELMTableau, carry: ELM2CarryQ, h, precise_sums: bool = False
) -> torch.Tensor:
    """Cowell velocity from an expansion carry (see :func:`elm2_velocity`)."""
    y_now = tuple(l[0] for l in carry.ys)
    y_prev = tuple(l[1] for l in carry.ys)
    return _velocity_q(tab, y_now, y_prev, carry.ddys, h, precise_sums)


# ---------------------------------------------------------------------------
# Fused expansion carry: pair-native force ring + the 4-limb update kernel
# ---------------------------------------------------------------------------
#
# The same arithmetic family as ELM2CarryQ, but the acceleration ring holds
# the raw (hi, lo) f32 pairs kernel 3 returns, and the whole position update
# is kernel 4 (ops.cuda_elm2q.elm2q_update).


class ELM2CarryQF(NamedTuple):
    t: float
    ys: tuple               # K-tuple of (ORDER, ..., 3) f32 limb tensors
    dd: TwoFloat            # (ORDER, ..., 3) f32 pair ring, dd[j] = f(ys[j])
    dy: torch.Tensor        # base-precision velocity (stale during scans)


def elm2_qf_from_q(carry: ELM2CarryQ) -> ELM2CarryQF:
    """Split the f64 acceleration ring into f32 pairs (rounds at ~2^-48, the
    pair's working precision)."""
    return ELM2CarryQF(t=carry.t, ys=carry.ys, dd=_split_pair(carry.ddys), dy=carry.dy)


def elm2_qf_to_q(carry: ELM2CarryQF) -> ELM2CarryQ:
    """Exact conversion back (hi and lo both convert exactly to f64)."""
    ddys = carry.dd.hi.to(torch.float64) + carry.dd.lo.to(torch.float64)
    return ELM2CarryQ(t=carry.t, ys=carry.ys, ddys=ddys, dy=carry.dy)


def elm2_init_qf(
    tab: ELMTableau, accel, t0, y0, dy0, h, accel_limbs=None, y0_limbs=None
) -> ELM2CarryQF:
    return elm2_qf_from_q(
        elm2_init_q(tab, accel, t0, y0, dy0, h, accel_limbs=accel_limbs, y0_limbs=y0_limbs)
    )


def elm2_step_qf(
    tab: ELMTableau, accel_pair, h, carry: ELM2CarryQF, precise_sums: bool = False
) -> ELM2CarryQF:
    """One fused step: kernel 4 for the position update, then the force.

    ``accel_pair(t, (l0, l1, l2)) -> (hi, lo)`` is the pair-returning force
    (kernel 3 through :func:`..ops.cuda_limbs.pairwise_accel_limbs_pair`).
    Velocity is deferred (:func:`elm2_velocity_qf`).  ``precise_sums``
    selects kernel 4's precise beta sum.
    """
    from ..ops.cuda_elm2q import elm2q_update

    y_new = elm2q_update(tab, h, carry.ys, carry.dd, precise=precise_sums)
    t_new = carry.t + h
    fh, fl = accel_pair(t_new, (y_new[0], y_new[1], y_new[2]))

    def shift(new, ring):
        return torch.cat([new[None], ring[: tab.order - 1]])

    return ELM2CarryQF(
        t=t_new,
        ys=tuple(shift(nl, ol) for nl, ol in zip(y_new, carry.ys)),
        dd=TwoFloat(shift(fh, carry.dd.hi), shift(fl, carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_velocity_qf(
    tab: ELMTableau, carry: ELM2CarryQF, h, precise_sums: bool = False
) -> torch.Tensor:
    return elm2_velocity_q(tab, elm2_qf_to_q(carry), h, precise_sums=precise_sums)


class ELM2CarryQFP(NamedTuple):
    t: float
    ys: tuple               # K-tuple of (ORDER, SUB, M/SUB) f32 limb rings
    dd: TwoFloat            # (ORDER, SUB, M/SUB) f32 pair ring
    dy: torch.Tensor        # base-precision velocity (stale during scans)


def elm2_qfp_from(carry: ELM2CarryQF, sub: int = _PACK_SUB) -> ELM2CarryQFP:
    """Pack an ELM2CarryQF's rings (a reshape; exact)."""
    return ELM2CarryQFP(
        t=carry.t,
        ys=tuple(_pack_ring(l, sub) for l in carry.ys),
        dd=TwoFloat(_pack_ring(carry.dd.hi, sub), _pack_ring(carry.dd.lo, sub)),
        dy=carry.dy,
    )


def elm2_qfp_to(carry: ELM2CarryQFP, shape: tuple) -> ELM2CarryQF:
    o = carry.ys[0].shape[0]

    def unp(x):
        return x.reshape((o, *shape))

    return ELM2CarryQF(
        t=carry.t,
        ys=tuple(unp(l) for l in carry.ys),
        dd=TwoFloat(unp(carry.dd.hi), unp(carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_step_qfp(
    tab: ELMTableau, accel_pair, h, carry: ELM2CarryQFP, shape: tuple,
    precise_sums: bool = False,
) -> ELM2CarryQFP:
    """One fused expansion-state step on the packed carry: kernel 4 through
    its packed entry point (:func:`..ops.cuda_elm2q.elm2q_update_packed`).

    ``accel_pair(t, (l0, l1, l2)) -> (hi, lo)`` with limbs of the logical
    ``shape``, as in :func:`elm2_step_qf`.  Bitwise equal to
    :func:`elm2_step_qf` on the unpacked view.
    """
    from ..ops.cuda_elm2q import elm2q_update_packed

    y_new = elm2q_update_packed(tab, h, carry.ys, carry.dd, precise=precise_sums)
    t_new = carry.t + h
    fh, fl = accel_pair(t_new, tuple(l.reshape(shape) for l in y_new[:3]))
    psh = y_new[0].shape
    fh, fl = fh.reshape(psh), fl.reshape(psh)

    def shift(new, ring):
        return torch.cat([new[None], ring[: tab.order - 1]])

    return ELM2CarryQFP(
        t=t_new,
        ys=tuple(shift(nl, ol) for nl, ol in zip(y_new, carry.ys)),
        dd=TwoFloat(shift(fh, carry.dd.hi), shift(fl, carry.dd.lo)),
        dy=carry.dy,
    )


def elm2_velocity_qfp(tab: ELMTableau, carry: ELM2CarryQFP, h, shape: tuple) -> torch.Tensor:
    return elm2_velocity_qf(tab, elm2_qfp_to(carry, shape), h)
