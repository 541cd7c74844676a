"""Adaptive (embedded) Runge-Kutta stepping with an I-controller.

Port of ``ephemeris_explorer_tpu.integrators.adaptive`` (the reference's
``AdaptiveRungeKutta``, ``integration/src/runge_kutta/mod.rs:128-440``):
:func:`advance` makes ONE accepted step, retrying with the controller-shrunk
step size until the embedded error estimate passes (the store/restore loop
at ``mod.rs:413-439``).  Rejected attempts never commit, so the FSAL stage
cache is carried functionally.

Controller (``mod.rs:225-243``):  m = fac * err^(-1/k);
h_next = min(h * clamp(m, fac_min, fac_max), h_max);  accept iff err <= 1.
:func:`control` holds that arithmetic and the failure test for both
:func:`advance` and the spacecraft fleet loop, which advances many states
by one attempt per device iteration (``spacecraft.propagate_batch``).

:func:`advance` loops over attempts on the host, one read of the accept
flags an attempt: it is the single-state reference the tests hold against
the JAX package.  The attempt counter ``n`` is bounded by ``n_max``
(reference default 1e6, load/mod.rs:472-486).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .fixed import erk_error, erk_step, erkn_step, erkng_step, nystrom_error
from .methods import ERKNGTableau, ERKNTableau, ERKTableau

# status codes (mirroring integration/src/lib.rs:312-330 StepError)
OK = 0
BOUND_REACHED = 1
STEP_SIZE_UNDERFLOW = 2
MAX_ITERATIONS = 3
EVAL_FAILED = 4  # non-finite RHS/error (StepError::EvalFailed, problem.rs:114)

F64 = torch.float64


@dataclass(frozen=True)
class AdaptiveParams:
    """AdaptiveMethodParams (integration/src/lib.rs:174-233)."""

    h_init: float = 60.0
    h_max: float = 1.7976931348623157e308
    tol_pos: float = 1e-3   # km   (1 m; load/mod.rs:476-480)
    tol_vel: float = 1e-3   # km/s (1 m/s; load/mod.rs:476-480)
    fac_min: float = 0.2
    fac_max: float = 5.0
    fac: float = 0.9
    n_max: int = 1_000_000


class AdaptiveState(NamedTuple):
    """Integrator state threaded between accepted steps (f64 tensors)."""

    t: torch.Tensor       # current time (seconds)
    y: Any                # state: a tensor or a (pos, vel) tuple
    next_h: torch.Tensor  # controller-proposed next step size
    n: torch.Tensor       # attempt count (int64)
    cache: Any            # FSAL derivative cache, shaped like f(t, y)


def _leaves(y) -> tuple:
    return y if isinstance(y, tuple) else (y,)


def abs_tol_norm(tol_pos: float, tol_vel: float):
    """AbsTol error norm (dynamics/spacecraft.rs:615-641): state = (pos, vel)."""

    def norm(_y_new, err):
        e_pos, e_vel = err
        return torch.maximum((e_pos / tol_pos).abs().max(), (e_vel / tol_vel).abs().max())

    return norm


def init_state(tab, f, t0, y0, params: AdaptiveParams) -> AdaptiveState:
    """The initial adaptive state, the FSAL cache primed with f(t0, y0).
    ``t0`` is a float, a 0-dim tensor, or one time per state of a batch."""
    like = _leaves(y0)[0]
    t0 = torch.as_tensor(t0, dtype=F64, device=like.device)
    if isinstance(tab, ERKTableau):
        cache = f(t0, y0)
    elif isinstance(tab, ERKNTableau):
        cache = f(t0, y0[0])
    else:
        cache = f(t0, y0[0], y0[1])
    return AdaptiveState(
        t=t0,
        y=y0,
        next_h=torch.full_like(t0, params.h_init),
        n=torch.zeros(t0.shape, dtype=torch.int64, device=t0.device),
        cache=cache,
    )


def _attempt(tab, f, t, y, h, cache):
    """One trial step; returns (y_new, err_pytree, new_cache)."""
    if isinstance(tab, ERKTableau):
        _, y_new, ks = erk_step(tab, f, t, y, h, k0=cache if tab.fsal else None)
        return y_new, erk_error(tab, ks, h), ks[-1]
    if isinstance(tab, (ERKNTableau, ERKNGTableau)):
        step = erkn_step if isinstance(tab, ERKNTableau) else erkng_step
        yy, dy = y
        _, y2, dy2, dks = step(tab, f, t, yy, dy, h, dk0=cache if tab.fsal else None)
        return (y2, dy2), nystrom_error(tab, dks, h), dks[-1]
    raise TypeError(type(tab))


def control(params: AdaptiveParams, lower_order: int, h, err, y_new):
    """The controller after one attempt: (next_h, accepted, failed).

    ``err`` is the error norm, 0-dim or one value per state of a batch; the
    leaves of ``y_new`` lead with the same axes.  EvalFailed semantics match
    the reference (StepError::EvalFailed, integration/src/lib.rs:312-330):
    fail only when the new state itself is non-finite (e.g. a degenerate
    TNB burn frame) or err is NaN (it would poison next_h).  An overflowed
    but finite attempt (err = inf) gives m = 0, which the clamp lifts to
    fac_min: the step is retried smaller.  err = 0 gives m = inf, clamped
    to fac_max.
    """
    finite = None
    for leaf in _leaves(y_new):
        f = torch.isfinite(leaf).reshape(err.shape + (-1,)).all(-1)
        finite = f if finite is None else finite & f
    failed = ~finite | torch.isnan(err)
    m = params.fac * err ** (-1.0 / float(lower_order))
    next_h = (h * torch.clamp(m, params.fac_min, params.fac_max)).clamp(max=params.h_max)
    return next_h, err <= 1.0, failed


def advance(
    tab,
    f: Callable,
    params: AdaptiveParams,
    err_norm: Callable,
    state: AdaptiveState,
    bound,
):
    """One ACCEPTED adaptive step bounded by ``bound``.

    Returns (new_state, h_used, status) with status one of the codes above.
    On a non-OK status the state is returned unchanged except the attempt
    counter.  A state at or past ``bound``, or whose next step would not
    move ``t``, returns at once (BOUND_REACHED, STEP_SIZE_UNDERFLOW).
    """
    bound = torch.as_tensor(bound, dtype=F64, device=state.t.device)
    pre_bound = bool(state.t >= bound)
    pre_underflow = bool(state.t + state.next_h == state.t)

    next_h, n = state.next_h, state.n
    accepted, failed = pre_bound or pre_underflow, False
    h_used = torch.zeros_like(state.t)
    y_new, cache_new = state.y, state.cache
    while not accepted and not failed and int(n) <= params.n_max:
        h = torch.minimum(next_h, bound - state.t)
        y_new, err_vec, cache_new = _attempt(tab, f, state.t, state.y, h, state.cache)
        next_h, acc, fail = control(params, tab.lower_order, h, err_norm(y_new, err_vec), y_new)
        n, h_used = n + 1, h
        accepted, failed = bool(acc), bool(fail)

    if pre_bound:
        status = BOUND_REACHED
    elif pre_underflow:
        status = STEP_SIZE_UNDERFLOW
    elif failed:
        status = EVAL_FAILED
    else:
        status = OK if accepted else MAX_ITERATIONS
    if status != OK:
        return state._replace(n=n), h_used, status
    return AdaptiveState(t=state.t + h_used, y=y_new, next_h=next_h, n=n, cache=cache_new), \
        h_used, status
