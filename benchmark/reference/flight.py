"""Plain spacecraft flight: the ship's acceleration, burn frames, Verner87.

The upstream project's semantics for a ship (a massless body):

* its acceleration is the gravity of every body of the ephemeris at the
  stage time, plus the burn of the flight-plan segment it flies in;
* a burn is given in the TNB frame of a reference body: with r and v the
  ship's position and velocity relative to that body, x = v / |v|,
  y = (r x v) / |r x v|, z = (x x y) / |x x y|, and the inertial burn is
  x a_0 + z a_1 + y a_2;
* the state (position, velocity) is stepped by Verner's 8(7) pair as a
  first-order system, the error estimate h sum_s e_s k_s measured by
  max(|error of the position| / tol, |error of the velocity| / tol) over
  the components, a step accepted when that is at most 1; steps end on the
  plan's segment edges, where the integrator restarts.

:func:`step_from` takes one Verner87 step from each of many states at once.
It is how the benchmark judges a trajectory knot by knot: from knot k with
h = t_{k+1} - t_k it gives the state at knot k + 1 and the error estimate
of that step.  :func:`fly` flies whole plans with the upstream step
controller, to judge how many steps a flight takes.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from . import tableaux
from .ephemeris import Evaluator

_V = tableaux.METHODS["Verner87"]
STAGES = len(_V["b"])
A = [[float(Fraction(x)) for x in row] for row in _V["a"]]
B = [float(Fraction(x)) for x in _V["b"]]
C = [float(Fraction(x)) for x in _V["c"]]
E = [float(Fraction(x)) for x in _V["e"]]


def timeline(burns: list[dict], names: list[str]) -> list[tuple]:
    """The plan's burns as (start_s, end_s, accel (3,), frame body index or
    -1 for the inertial frame), sorted by start."""
    out = []
    for b in sorted(burns, key=lambda b: b["start_s"]):
        ref = b["reference"]
        out.append((b["start_s"], b["end_s"], b["accel"], names.index(ref) if ref else -1))
    return out


def burn_table(plan: list[tuple], t_mid: torch.Tensor):
    """Per step (its midpoint ``t_mid``): (accel (K, 3), frame body (K,)
    int, burning (K,) bool, relative (K,) bool).  A step never crosses a
    segment edge."""
    k = t_mid.shape[0]
    acc = t_mid.new_zeros((k, 3))
    body = torch.zeros(k, dtype=torch.long, device=t_mid.device)
    burning = torch.zeros(k, dtype=torch.bool, device=t_mid.device)
    relative = torch.zeros_like(burning)
    for s, e, a, fb in plan:
        inside = (t_mid >= s) & (t_mid < e)
        acc[inside] = torch.as_tensor(a, dtype=acc.dtype, device=acc.device)
        body[inside] = max(fb, 0)
        burning |= inside
        relative |= inside & (fb >= 0)
    return acc, body, burning, relative


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def tnb(rel_pos, rel_vel, a):
    """The TNB-frame burn ``a`` (..., 3) in the inertial frame."""
    x = _unit(rel_vel)
    y = _unit(torch.linalg.cross(rel_pos, rel_vel))
    z = _unit(torch.linalg.cross(x, y))
    return x * a[..., 0:1] + z * a[..., 1:2] + y * a[..., 2:3]


def derivative(ev: Evaluator, mu, t, y, burn):
    """d/dt of states y (K, 6) at times t (K,), f64 times."""
    acc, body, burning, relative = burn
    pos, vel = y[:, :3], y[:, 3:]
    if bool(burning.any()):
        bp, bv = ev(t, velocity=True)                       # (K, N, 3)
        rows = torch.arange(t.shape[0], device=t.device)
        man = torch.where(relative[:, None],
                          tnb(pos - bp[rows, body], vel - bv[rows, body], acc.to(y.dtype)),
                          acc.to(y.dtype))
        man = torch.where(burning[:, None], man, torch.zeros_like(man))
    else:
        bp, man = ev(t), 0.0
    d = bp - pos[:, None, :]
    r2 = (d * d).sum(-1)
    inv = torch.rsqrt(r2)
    g = (d * (mu * inv * inv * inv)[..., None]).sum(1)
    return torch.cat([vel, g + man], -1)


def step_from(ev: Evaluator, mu, plan, t, y, h):
    """One Verner87 step of h (K,) from states y (K, 6) at t (K,) (f64):
    (the new states, the error estimates (K, 6))."""
    return _attempt(ev, mu, t, y, h, burn_table(plan, t + 0.5 * h))


def _attempt(ev: Evaluator, mu, t, y, h, burn):
    hk = h.to(y.dtype)[:, None]
    ks = []
    for s in range(STAGES):
        ys = y
        for j in range(s):
            if A[s][j] != 0.0:
                ys = ys + hk * (A[s][j] * ks[j])
        ks.append(derivative(ev, mu, t + C[s] * h, ys, burn))
    y_new, err = y, torch.zeros_like(y)
    for s in range(STAGES):
        if B[s] != 0.0:
            y_new = y_new + hk * (B[s] * ks[s])
        if E[s] != 0.0:
            err = err + hk * (E[s] * ks[s])
    return y_new, err


def follow(ev: Evaluator, mu, plan, ts: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """The states at the times ``ts`` (K,) f64 from ``y0`` (6,), a Verner87
    step between each two: (K, 6) in ``y0``'s dtype."""
    out = [y0]
    y = y0[None]
    for k in range(ts.shape[0] - 1):
        y, _ = step_from(ev, mu, plan, ts[k:k + 1], y, ts[k + 1:k + 2] - ts[k:k + 1])
        out.append(y[0])
    return torch.stack(out)


# the upstream step controller (AdaptiveMethodParams' defaults): a segment
# starts at h = 60 s; after an attempt h <- h * clamp(0.9 err^(-1/7), 0.2,
# 5), err the largest |error| / tol of the six components; accepted iff
# err <= 1
H_INIT, SAFETY, FAC_MIN, FAC_MAX, LOWER_ORDER = 60.0, 0.9, 0.2, 5.0, 7


def segments(plans: list[list[tuple]]):
    """Plans that share their burns' edges (one a ship, the accelerations
    alone differing) as (edges (E,) f64, and per segment and ship: accel
    (E + 1, K, 3), frame body, burning, relative); segment j lies between
    edges j - 1 and j."""
    edges = sorted({x for s, e, _, _ in plans[0] for x in (s, e)})
    k, n = len(plans), len(edges) + 1
    acc = torch.zeros((n, k, 3), dtype=torch.float64)
    body = torch.zeros((n, k), dtype=torch.long)
    burning = torch.zeros((n, k), dtype=torch.bool)
    relative = torch.zeros_like(burning)
    for i, plan in enumerate(plans):
        for s, e, a, fb in plan:
            for j in range(1, n - 1):
                if s <= edges[j - 1] and edges[j] <= e:
                    acc[j, i] = torch.as_tensor(a, dtype=torch.float64)
                    body[j, i], burning[j, i], relative[j, i] = max(fb, 0), True, fb >= 0
    return torch.tensor(edges, dtype=torch.float64), (acc, body, burning, relative)


def fly(ev: Evaluator, mu, plans: list[list[tuple]], t0: float, y0, end_s: float,
        tol: float, max_attempts: int):
    """Each plan flown from the state y0 (6,) at t0 to end_s, every ship its
    own adaptive Verner87 flight in y0's dtype (times f64), the controller
    reset at each burn edge: the accepted steps of each flight (K,), and
    whether each reached end_s within ``max_attempts`` attempts."""
    edges, table = segments(plans)
    k = len(plans)
    rows = torch.arange(k)
    bounds = torch.cat([edges, edges.new_tensor([float("inf")])]).clamp(max=end_s)
    t = torch.full((k,), float(t0), dtype=torch.float64)
    y = y0.expand(k, 6).clone()
    h_try = torch.full_like(t, H_INIT)
    steps = torch.zeros(k, dtype=torch.long)
    live = t < end_s
    for _ in range(max_attempts):
        if not bool(live.any()):
            break
        seg = torch.searchsorted(edges, t, right=True)
        bound = bounds[seg]
        h = torch.minimum(h_try, bound - t)
        burn = tuple(x[seg, rows] for x in table)
        y_new, err = _attempt(ev, mu, t, y, h, burn)
        e = (err.double().abs() / tol).amax(-1)
        m = SAFETY * e ** (-1.0 / LOWER_ORDER)
        next_h = h * m.clamp(FAC_MIN, FAC_MAX)
        ok = live & (e <= 1.0)
        t = torch.where(ok, t + h, t)
        y = torch.where(ok[:, None], y_new, y)
        steps += ok
        h_try = torch.where(live, next_h, h_try)
        h_try = torch.where(ok & (t >= bound), H_INIT, h_try)
        live = t < end_s
    return steps, ~live
