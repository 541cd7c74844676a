"""Spacecraft propagation: flight plans, burn frames, adaptive integration.

Port of ``ephemeris_explorer_tpu.spacecraft`` (the reference's
``ephemeris/src/propagators/spacecraft.rs`` +
``ephemeris_explorer/src/dynamics/spacecraft.rs``):

* a flight plan's burns become a dense ``Timeline`` of segments (coast /
  burn interleaving, ``spacecraft.rs:119-222``), host numpy arrays;
* the context acceleration is the sum of all bodies' interpolated gravity
  from the packed ephemeris (``dynamics/spacecraft.rs:218-229``), and burn
  accelerations are turned from their frame (TNB relative to a body, or
  inertial; ``dynamics/spacecraft.rs:240-293``) at every stage;
* the integrator is RESET at every segment edge (fresh ``h_init`` and FSAL
  cache, the attempt count back to 0), as ``reset_integrator`` is at
  manoeuvre changes (``spacecraft.rs:599-615``), so restarts are
  deterministic;
* accepted steps append (t, position, velocity) knots to a preallocated
  buffer, the cubic-Hermite trajectory (``trajectory.rs:745-855``).

The JAX package nests three ``lax.while_loop``s (segments, accepted steps,
attempts) and vmaps them over a fleet.  Here :func:`propagate_batch` holds
the state of B ships and advances every live ship by one step of its own
state machine an iteration.  A ship inside a segment makes one attempt,
applies the shared controller (:func:`.integrators.adaptive.control`) and,
if the attempt was accepted, appends a knot; a ship whose segment has ended
takes the fresh state of its next segment.  Each ship sees the sequence of
operations the single-ship loop gives it, whatever the batch beside it but
for two batch flags (whether any ship burns, whether any burn is
body-relative), which choose the RHS's form.

On the card the loop is kernel 14 (:mod:`.ops.cuda_fleet`, one block a
ship, which evaluates the bodies at all of an attempt's stage times at once,
as :func:`_stage_bodies` does, and runs the stages on one warp): a launch
advances every live ship by up to
``cuda_fleet.ITERATIONS_PER_LAUNCH`` iterations, and the host reads the
done flags once a launch.  On the CPU it is :func:`propagate_batch_plain`,
the kernel's plain version: one batched, masked eager loop whose branches
are ``torch.where`` selects (a NaN in a branch a ship does not take stays
out of its state), with one read of an "all done" flag every
:data:`SYNC_EVERY` iterations.  Its sums over bodies, norms, cross and
matrix products are written out in the kernel's order, so the two agree
bitwise on the card.

Every entry point runs on the device its caller names (``device=None``:
the card, :func:`._device.resolve`), whatever the batch size.  Not copied
from the JAX package: the routing of batches of up to 16 ships to the host
(``_CPU_BATCH_MAX``, ``_propagate_backend``, ``_host_packed``), which worked
around a remote-device relay, and the power-of-two padding of fleets with
inert ships, which bounded its compile shapes (eager torch compiles
nothing).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _device, tracing
from .ephemeris import PackedEphemeris
from .ftime import Epoch
from .integrators import adaptive
from .integrators.adaptive import AdaptiveParams
from .integrators.methods import ERKNGTableau, ERKTableau, get as get_method
from .io.scene import Ship, ShipBurn

EPOCH_MIN = -1.0e300
EPOCH_MAX = 1.0e300

FRAME_INERTIAL = 0
FRAME_RELATIVE = 1

F64 = torch.float64


class Timeline(NamedTuple):
    """Dense segment arrays (sorted, non-overlapping, covering (-inf, inf)).

    Mirrors ``Timeline::new`` (spacecraft.rs:129-157): coast segments fill
    the gaps between burns.  ``frame_body`` indexes the scene body list.
    Host numpy arrays; stacked fleets carry (B, S) arrays, which the fleet
    loop holds as tensors on its device.
    """

    starts: np.ndarray      # (S,)
    ends: np.ndarray        # (S,)
    accels: np.ndarray      # (S, 3) burn acceleration in the burn frame
    frame_kind: np.ndarray  # (S,) FRAME_INERTIAL | FRAME_RELATIVE
    frame_body: np.ndarray  # (S,) body index (0 when inertial)

    @property
    def n_segments(self) -> int:
        return self.starts.shape[-1]


def build_timeline(
    burns: list[ShipBurn], body_index, pad_to: int | None = None
) -> Timeline:
    """Host-side timeline construction from burns (spacecraft.rs:129-157).

    ``body_index`` maps body name -> index.  Burns are sorted by start; gaps
    are coast segments.  Optionally right-pads with zero-length coasts at
    EPOCH_MAX so batched ships share a segment count.
    """
    entries = sorted(burns, key=lambda b: b.start.as_offset_seconds())
    segs: list[tuple[float, float, np.ndarray, int, int]] = []
    cursor = EPOCH_MIN
    zero = np.zeros(3)
    for b in entries:
        s, e = b.start.as_offset_seconds(), b.end.as_offset_seconds()
        if s > cursor:
            segs.append((cursor, s, zero, FRAME_INERTIAL, 0))
        if b.reference is None:
            kind, ref = FRAME_INERTIAL, 0
        else:
            kind = FRAME_RELATIVE
            ref = body_index(b.reference) if callable(body_index) else body_index[b.reference]
        segs.append((s, e, np.asarray(b.acceleration, dtype=np.float64), kind, ref))
        cursor = e
    if cursor < EPOCH_MAX:
        segs.append((cursor, EPOCH_MAX, zero, FRAME_INERTIAL, 0))
    if pad_to is not None:
        while len(segs) < pad_to:
            segs.append((EPOCH_MAX, EPOCH_MAX, zero, FRAME_INERTIAL, 0))
    return Timeline(
        starts=np.array([s[0] for s in segs]),
        ends=np.array([s[1] for s in segs]),
        accels=np.stack([s[2] for s in segs]),
        frame_kind=np.array([s[3] for s in segs], dtype=np.int32),
        frame_body=np.array([s[4] for s in segs], dtype=np.int32),
    )


def segment_idx_at(tl: Timeline, t) -> torch.Tensor:
    """partition_point(seg.end <= t)  (spacecraft.rs:165-167).

    ``tl.ends`` (..., S) against t of shape (...) or a scalar: int64 (...)."""
    ends = torch.as_tensor(tl.ends)
    t = torch.as_tensor(t, dtype=ends.dtype, device=ends.device)
    return (ends <= t[..., None]).sum(-1)


def divergence_time(old: Timeline, new: Timeline, before) -> float:
    """Last common segment-start before ``before`` (spacecraft.rs:180-212).

    Common prefix = segments with equal starts; the prefix stops after the
    first pair with differing thrust.  Used for incremental flight-plan
    replanning (flight_plan.rs:264-303).
    """
    n = min(old.n_segments, new.n_segments)
    o = Timeline(*(np.asarray(x)[:n] for x in old))
    w = Timeline(*(np.asarray(x)[:n] for x in new))
    same_start = o.starts == w.starts
    same_thrust = (
        np.all(o.accels == w.accels, axis=-1)
        & (o.frame_kind == w.frame_kind)
        & (o.frame_body == w.frame_body)
        & (o.ends == w.ends)
    )
    # segment i yields its start if all starts up to i matched and all
    # thrusts before i matched
    prefix_start = np.cumprod(same_start) == 1
    prefix_thrust = np.concatenate([np.ones(1, bool), (np.cumprod(same_thrust) == 1)[:-1]])
    valid = prefix_start & prefix_thrust & (o.starts < before)
    return float(np.max(np.where(valid, o.starts, EPOCH_MIN)))


# ---------------------------------------------------------------------------
# Burn-frame transform (dynamics/spacecraft.rs:240-293)
# ---------------------------------------------------------------------------


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, kept as an axis of 1, the products
    added left to right: kernel 14's order (``csrc/fleet_scan.cu``), where
    ``.sum(-1)`` leaves it to torch."""
    p = a * b
    return (p[..., 0:1] + p[..., 1:2]) + p[..., 2:3]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_dot3(v, v))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b, each component two products and a subtraction, each one op:
    (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)."""
    aa, bb = torch.cat([a, a], -1), torch.cat([b, b], -1)
    return aa[..., 1:4] * bb[..., 2:5] - aa[..., 2:5] * bb[..., 1:4]


def tnb_to_inertial(rel_pos, rel_vel, accel) -> torch.Tensor:
    """Transform a TNB-frame acceleration to inertial, over leading axes.

    TNB basis (dynamics/spacecraft.rs:246-252): x = v_hat,
    y = (r x v)_hat, z = x cross y; matrix columns (x, z, y).  Norms, cross
    products and the matrix product are written out op by op in kernel 14's
    order (a norm is the square root of a left-to-right sum).

    Degenerate geometry (zero relative velocity or collinear r, v) yields a
    NaN acceleration, which the adaptive loop detects as a non-finite
    state and aborts the step with ``EVAL_FAILED``, the functional
    equivalent of ``TNB::try_new`` returning ``None``
    (dynamics/spacecraft.rs:242-253).
    """
    xy = _unit(torch.stack([rel_vel, _cross(rel_pos, rel_vel)], -2))
    x, y = xy[..., 0, :], xy[..., 1, :]
    z = _unit(_cross(x, y))
    return (x * accel[..., 0:1] + z * accel[..., 1:2]) + y * accel[..., 2:3]


def _frame_state(bodies: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """Row ``body`` of (..., N, 3) body states, per leading index: (..., 3)."""
    idx = body.reshape(body.shape + (1, 1)).expand(body.shape + (1, 3))
    return bodies.gather(-2, idx)[..., 0, :]


def _burn_accel(pos, vel, accel, relative, frame_pos, frame_vel) -> torch.Tensor:
    """The burn in the inertial frame: TNB about the frame body where
    ``relative``, else ``accel`` as given (a select: the TNB branch's NaN
    stays out of inertial burns)."""
    tnb = tnb_to_inertial(pos - frame_pos, vel - frame_vel, accel)
    return torch.where(relative[..., None], tnb, accel)


def manoeuvre_accel(eph: PackedEphemeris, t, pos, vel, accel, kind, body) -> torch.Tensor:
    """Burn acceleration in the inertial frame at stage time/state, over
    leading axes (t (...), pos/vel/accel (..., 3), kind/body (...))."""
    bpos, bvel = eph.state_vectors(t)
    body = torch.as_tensor(body, dtype=torch.int64, device=bpos.device)
    kind = torch.as_tensor(kind, device=bpos.device)
    return _burn_accel(pos, vel, accel, kind == FRAME_RELATIVE,
                       _frame_state(bpos, body), _frame_state(bvel, body))


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------

# termination reasons
DONE_END = 0          # reached requested end
DONE_KNOTS_FULL = 1   # knot buffer exhausted
DONE_ERROR = 2        # step-size underflow / max iterations / eval failed

REASON_NAMES = {
    DONE_END: "end-reached",
    DONE_KNOTS_FULL: "knot-buffer-full",
    DONE_ERROR: "step-error",
}

# Canonical knot-buffer capacity, one value across the entry points (the
# JAX package's shared compiled shapes).  Long missions that overflow it
# resume (propagate_resuming / the fleet fallback).
KNOT_CAPACITY = 8192

# Device iterations of the fleet loop between two reads of its "all done"
# flag: the loop's only host syncs.
SYNC_EVERY = 16


class PropagationResult(NamedTuple):
    ts: torch.Tensor       # (B, K) knot times (f64 s); padded with +inf
    pos: torch.Tensor      # (B, K, 3)
    vel: torch.Tensor      # (B, K, 3)
    count: torch.Tensor    # (B,) valid knots
    reason: torch.Tensor   # (B,) DONE_*
    final_seg: torch.Tensor


def _stage_bodies(eph: PackedEphemeris, t_stages, frame_body, frame: bool) -> list:
    """The bodies at every stage time of an attempt, in one batched
    evaluation: per stage, (positions (B, N, 3), frame body position and
    velocity (B, 3), or None without relative burns).  Each row is the
    bits of the stage's own evaluation."""
    if frame:
        bpos, bvel = eph.state_vectors(t_stages)              # (B, S, N, 3)
        fb = frame_body[:, None].expand(t_stages.shape)
        fpos, fvel = _frame_state(bpos, fb), _frame_state(bvel, fb)
        return [(bpos[:, s], fpos[:, s], fvel[:, s]) for s in range(t_stages.shape[1])]
    bpos = eph.positions(t_stages)
    return [(bpos[:, s], None, None) for s in range(t_stages.shape[1])]


# kernel 14's warp: the lanes of its sum over bodies
LANES = 32


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over axis -2 of (..., N, 3) in kernel 14's order: lane l of a
    warp adds rows l, l + 32, l + 64, ... to 0.0 in turn, then a halving
    tree adds lane l + off's partial to lane l's for off = 16, 8, 4, 2, 1.
    Here N is padded with zero rows to a multiple of 32 and the 32-row
    slices are folded in order; a partial is never -0.0, so a zero row adds
    nothing, as a lane past N adds nothing in the kernel."""
    pad = -x.shape[-2] % LANES
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    x = x.reshape(*x.shape[:-2], -1, LANES, x.shape[-1])
    acc = x[..., 0, :, :] + 0.0
    for j in range(1, x.shape[-3]):
        acc = acc + x[..., j, :, :]
    off = LANES // 2
    while off:
        acc = acc[..., :off, :] + acc[..., off:2 * off, :]
        off //= 2
    return acc[..., 0, :]


def _probe_accel(bpos: torch.Tensor, mu: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """``ops.nbody.accel_at``'s gravity at ships ``at`` (B, 3) from bodies
    (B, N, 3), in kernel 14's order: r^2 added left to right, the bodies
    summed by :func:`_lane_sum`."""
    d = bpos - at[..., None, :]
    inv_r = torch.rsqrt(_dot3(d, d))
    return _lane_sum(d * (mu[:, None] * (inv_r * inv_r * inv_r)))


def _make_rhs(tab, eph: PackedEphemeris, stages: list, accel, relative, burning,
              burns: bool, frames: bool):
    """The spacecraft RHS of one attempt, for every ship of the batch.

    ``stages`` (:func:`_stage_bodies`) is consumed one entry a call, in
    stage order, as the steppers call the RHS.  ``accel``, ``relative``,
    ``burning`` are each ship's current segment; ``burns`` / ``frames`` say
    (from the host's timelines) whether any ship burns at all and whether
    any burn is body-relative.  ERK states are (B, 6) [position, velocity];
    ERKNG ones a (position, velocity) pair of (B, 3).
    """
    it = iter(stages)

    def total(pos, vel):
        bpos, fpos, fvel = next(it)
        acc = _probe_accel(bpos, eph.mus, pos)
        if not burns:
            return acc
        man = _burn_accel(pos, vel, accel, relative, fpos, fvel) if frames else accel
        return acc + torch.where(burning[:, None], man, 0.0)

    if isinstance(tab, ERKNGTableau):
        return lambda t, y, dy: total(y, dy)
    return lambda t, y: torch.cat([y[:, 3:], total(y[:, :3], y[:, 3:])], -1)


def _err_norm(err_pos, err_vel, inv_tol_pos: float, inv_tol_vel: float) -> torch.Tensor:
    """``adaptive.abs_tol_norm``, one norm a ship of (B, 3) errors (a max
    is exact, so each row is its own norm), each error scaled by the host's
    1/tol: kernel 14 multiplies as torch's CUDA division by a host scalar
    does, here written out so that the CPU does the same."""
    return torch.maximum((err_pos * inv_tol_pos).abs().amax(-1),
                         (err_vel * inv_tol_vel).abs().amax(-1))


def _where(c: torch.Tensor, a, b):
    """Select rows of a tensor or of each leaf of a pair."""
    if isinstance(a, tuple):
        return tuple(_where(c, x, z) for x, z in zip(a, b))
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


class _FleetStart(NamedTuple):
    """The fleet loop's inputs on ``eph``'s device, shared by both routes."""

    tl: Timeline             # (B, S) tensors, kinds and bodies int64
    burns: bool              # any ship burns
    frames: bool             # any burn is body-relative
    t: torch.Tensor          # (B,)
    pos0: torch.Tensor       # (B, 3)
    vel0: torch.Tensor       # (B, 3)
    end_t: torch.Tensor      # (B,) the requested end, bounded by the coverage
    seg: torch.Tensor        # (B,) int64 each ship's first segment
    knots: torch.Tensor      # (B, max_knots + 1, 7): row 0 the start, t = inf past it


def _fleet_start(eph: PackedEphemeris, timelines: Timeline, t0s, pos0s, vel0s, end_ts,
                 max_knots: int) -> _FleetStart:
    dev = eph.coeffs.device

    def d(x, dtype=F64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    tl = Timeline(d(timelines.starts), d(timelines.ends), d(timelines.accels),
                  d(timelines.frame_kind, torch.int64), d(timelines.frame_body, torch.int64))
    burns = bool(np.any(np.asarray(timelines.accels) != 0.0))
    frames = burns and bool(np.any(np.asarray(timelines.frame_kind) == FRAME_RELATIVE))
    t = d(t0s)
    pos0, vel0 = d(pos0s), d(vel0s)
    knots = torch.zeros((t.shape[0], max_knots + 1, 7), dtype=F64, device=dev)
    knots[:, :, 0] = torch.inf
    knots[:, 0] = torch.cat([t[:, None], pos0, vel0], -1)
    return _FleetStart(tl, burns, frames, t, pos0, vel0,
                       torch.minimum(d(end_ts), eph.end_s), segment_idx_at(tl, t), knots)


def _result(knots: torch.Tensor, count, reason, final_seg, max_knots: int) -> PropagationResult:
    return PropagationResult(ts=knots[:, :max_knots, 0], pos=knots[:, :max_knots, 1:4],
                             vel=knots[:, :max_knots, 4:7], count=count, reason=reason,
                             final_seg=final_seg)


def propagate_batch(
    tab,
    eph: PackedEphemeris,
    timelines: Timeline,     # stacked (B, S) arrays
    t0s,                     # (B,)
    pos0s,                   # (B, 3)
    vel0s,                   # (B, 3)
    end_ts,                  # (B,)
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
) -> PropagationResult:
    """Propagate B ships on ``eph``'s device, each from t0 to its end_t.

    Every advance is also bounded by the ephemeris coverage (``eph.end_s``),
    the app's context-validity guard (dynamics/spacecraft.rs:231-238).
    Ships must share (method, tolerance): the caller groups by those.
    Returns device tensors; the knot buffers hold ``max_knots`` rows (one
    more, a sink for the appends of ships that accepted no step, is cut
    off).  Counts the loop's iterations, those of the batch's slowest ship,
    and its host syncs on ``propagate_batch.iterations`` / ``.syncs``; while
    a profiler records, the sum over ships of each ship's iterations goes to
    :mod:`.tracing`'s counter ``fleet.ship_iterations``.

    On the card the loop is kernel 14 (:mod:`.ops.cuda_fleet`): one launch
    advances every live ship by up to ``cuda_fleet.ITERATIONS_PER_LAUNCH``
    iterations, and the host reads the done flags once a launch; a build or
    launch failure raises.  On the CPU it is the eager loop,
    :func:`propagate_batch_plain`, the kernel's plain version: the two run
    the same operations on each ship in the same order.
    """
    if not isinstance(tab, (ERKTableau, ERKNGTableau)):
        raise TypeError(f"spacecraft integrators are ERK or ERKNG tableaux, not {type(tab)}")
    if eph.coeffs.device.type == "cpu":
        return propagate_batch_plain(tab, eph, timelines, t0s, pos0s, vel0s, end_ts, params,
                                     max_knots=max_knots)
    return _propagate_batch_kernel(tab, eph, timelines, t0s, pos0s, vel0s, end_ts, params,
                                   max_knots)


propagate_batch.iterations = 0
propagate_batch.syncs = 0


def _propagate_batch_kernel(tab, eph, timelines, t0s, pos0s, vel0s, end_ts, params,
                            max_knots) -> PropagationResult:
    """The fleet loop through kernel 14: launches until every ship is done,
    one host read of the done flags a launch."""
    from .ops import cuda_fleet

    with tracing.span("spacecraft.fleet_start"):
        f = _fleet_start(eph, timelines, t0s, pos0s, vel0s, end_ts, max_knots)
        plan = cuda_fleet.plan(tab, params, f.burns, f.frames)
        fstate, istate = cuda_fleet.start_state(f.t, f.pos0, f.vel0, f.seg, params.h_init)
    iterations = syncs = 0
    with tracing.span("spacecraft.fleet_loop"):
        while True:
            cuda_fleet.fleet_scan(plan, eph, f.tl, f.end_t, fstate, istate, f.knots)
            done, iters = istate[cuda_fleet.I_DONE:cuda_fleet.I_ITERS + 1].cpu()
            iterations += int(iters.max())
            if tracing.recording():
                tracing.count("fleet.ship_iterations", int(iters.sum()))
            syncs += 1
            if bool(done.all()):
                break
    propagate_batch.iterations += iterations
    propagate_batch.syncs += syncs
    return _result(f.knots, istate[cuda_fleet.I_COUNT], istate[cuda_fleet.I_REASON],
                   istate[cuda_fleet.I_SEG], max_knots)


def propagate_batch_plain(
    tab,
    eph: PackedEphemeris,
    timelines: Timeline,
    t0s,
    pos0s,
    vel0s,
    end_ts,
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
) -> PropagationResult:
    """The fleet loop as eager torch on ``eph``'s device: kernel 14's plain
    version and the CPU's route (:func:`propagate_batch` takes it for CPU
    tensors).  Arguments and result as :func:`propagate_batch`'s; it reads
    the "all done" flag once every :data:`SYNC_EVERY` iterations."""
    if not isinstance(tab, (ERKTableau, ERKNGTableau)):
        raise TypeError(f"spacecraft integrators are ERK or ERKNG tableaux, not {type(tab)}")
    with tracing.span("spacecraft.fleet_start"):
        f = _fleet_start(eph, timelines, t0s, pos0s, vel0s, end_ts, max_knots)
    tl, burns, frames, end_t, knots = f.tl, f.burns, f.frames, f.end_t, f.knots
    dev = eph.coeffs.device
    n_seg = tl.n_segments
    erk = isinstance(tab, ERKTableau)
    c_row = torch.as_tensor(tab.c, dtype=F64, device=dev)[None, :]
    inv_tol = (1.0 / params.tol_pos, 1.0 / params.tol_vel)

    def err_norm(err):
        return _err_norm(*((err[:, :3], err[:, 3:]) if erk else err), *inv_tol)

    t = f.t
    b = t.shape[0]
    rows = torch.arange(b, device=dev)

    y = torch.cat([f.pos0, f.vel0], -1) if erk else (f.pos0, f.vel0)
    seg = f.seg
    next_h = torch.full_like(t, params.h_init)
    h_try = next_h
    n = torch.zeros(b, dtype=torch.int64, device=dev)
    count = torch.ones(b, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    in_adv = done            # inside an advance (its pre-checks passed)
    reason = torch.full((b,), DONE_END, dtype=torch.int64, device=dev)
    # the FSAL cache; `stale` marks ships whose cache is their next
    # segment's fresh-state evaluation, still to be made
    cache, stale = None, ~done
    # each ship's iterations until its done flag is set, while a profiler records
    ship_iters = torch.zeros(b, dtype=torch.int64, device=dev) if tracing.recording() else None

    def iteration():
        nonlocal t, y, seg, next_h, h_try, n, count, done, in_adv, reason, cache, stale
        live = ~done
        if ship_iters is not None:
            ship_iters.add_(live)
        sc = seg.clamp(max=n_seg - 1)
        bound = torch.minimum(tl.ends[rows, sc], end_t)
        accel, relative = tl.accels[rows, sc], tl.frame_kind[rows, sc] == FRAME_RELATIVE
        burning = (accel != 0.0).any(-1)

        # an advance's pre-checks: at the bound, no progress, no attempts left
        start = live & ~in_adv
        pre_bound = start & (t >= bound)
        pre_under = start & ~pre_bound & (t + next_h == t)
        pre_stop = pre_bound | pre_under | (start & (n > params.n_max))
        attempting = live & ~pre_stop
        h_try = torch.where(start, next_h, h_try)

        # one attempt for every ship, kept where `attempting`
        h = torch.minimum(h_try, bound - t)
        stages = _stage_bodies(eph, t[:, None] + h[:, None] * c_row,
                               tl.frame_body[rows, sc] if frames else None, frames)
        f = _make_rhs(tab, eph, stages, accel, relative, burning, burns, frames)
        k0 = None
        if tab.fsal:
            fresh = f(t, y) if erk else f(t, y[0], y[1])
            k0 = fresh if cache is None else _where(stale, fresh, cache)
            cache, stale = k0, torch.zeros_like(stale)
        y_new, err_vec, cache_new = adaptive._attempt(tab, f, t, y, h, k0)
        nh, acc, fail = adaptive.control(params, tab.lower_order, h, err_norm(err_vec), y_new)
        n = torch.where(attempting, n + 1, n)
        h_try = torch.where(attempting, nh, h_try)
        ok = attempting & acc & ~fail
        adv_end = pre_stop | (attempting & (acc | fail | (n > params.n_max)))
        in_adv = attempting & ~adv_end

        # commit and append (ships that accepted nothing write the sink row)
        t = torch.where(ok, t + h, t)
        y = _where(ok, y_new, y)
        next_h = torch.where(ok, h_try, next_h)
        if tab.fsal:
            cache = _where(ok, cache_new, cache)
        state = torch.cat([t[:, None], y] if erk else [t[:, None], *y], -1)
        knots[rows, torch.where(ok, count, max_knots)] = state
        count = count + ok

        # end of the accepted-step loop, then of the segment loop
        full = count >= max_knots
        stop = adv_end & (~ok | full | (t >= bound))
        seg_reason = torch.where(full, DONE_KNOTS_FULL,
                                 torch.where(ok | pre_bound, DONE_END, DONE_ERROR))
        finished = stop & ((t >= end_t) | (seg_reason != DONE_END) | full)
        # the outer loop's fix-up: a full buffer ends as DONE_KNOTS_FULL
        reason = torch.where(finished, torch.where(full, DONE_KNOTS_FULL, seg_reason), reason)
        done = done | finished
        # the next segment starts from a fresh state (reset_integrator)
        nxt = stop & ~finished
        seg = seg + nxt
        next_h = torch.where(nxt, params.h_init, next_h)
        n = torch.where(nxt, 0, n)
        if tab.fsal:
            stale = stale | nxt

    iterations = syncs = 0
    with tracing.span("spacecraft.fleet_loop"):
        while True:
            for _ in range(SYNC_EVERY):
                iteration()
            iterations += SYNC_EVERY
            syncs += 1
            if bool(done.all()):
                break
    if ship_iters is not None:
        tracing.count("fleet.ship_iterations", int(ship_iters.sum()))
    propagate_batch.iterations += iterations
    propagate_batch.syncs += syncs
    return _result(knots, count, reason, seg, max_knots)


def propagate(
    tab,
    eph: PackedEphemeris,
    tl: Timeline,
    t0,
    pos0,
    vel0,
    end_t,
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
) -> PropagationResult:
    """Propagate one spacecraft from t0 to end_t on ``eph``'s device: the
    fleet loop at B = 1, the results unbatched."""
    r = propagate_batch(tab, eph, Timeline(*(np.asarray(x)[None] for x in tl)), [t0],
                        np.asarray(pos0)[None], np.asarray(vel0)[None], [end_t], params,
                        max_knots=max_knots)
    return PropagationResult(*(x[0] for x in r))


def _fetch(r: PropagationResult) -> PropagationResult:
    """A batch's results on the host in one copy of the knots, sliced on the
    device to the batch's largest count first (numpy arrays)."""
    with tracing.span("spacecraft.fetch"):
        kmax = max(int(r.count.max()), 1)
        knots = torch.cat([r.ts[:, :kmax, None], r.pos[:, :kmax], r.vel[:, :kmax]],
                          -1).cpu().numpy()
        meta = torch.stack([r.count, r.reason, r.final_seg], -1).cpu().numpy()
    return PropagationResult(ts=knots[..., 0], pos=knots[..., 1:4], vel=knots[..., 4:7],
                             count=meta[:, 0], reason=meta[:, 1], final_seg=meta[:, 2])


# ---------------------------------------------------------------------------
# Host-side Hermite trajectory (CubicHermiteSpline semantics)
# ---------------------------------------------------------------------------


@dataclass
class HermiteTrajectory:
    """Knot list with cubic-Hermite interpolation (trajectory.rs:745-855)."""

    ts: np.ndarray    # (K,) seconds, strictly increasing
    pos: np.ndarray   # (K, 3)
    vel: np.ndarray   # (K, 3)

    @classmethod
    def from_result(cls, r: PropagationResult) -> "HermiteTrajectory":
        """From one ship's host result (:func:`_fetch`, unbatched)."""
        k = int(r.count)
        return cls(
            ts=np.asarray(r.ts[:k]), pos=np.asarray(r.pos[:k]), vel=np.asarray(r.vel[:k])
        )

    @property
    def start_s(self) -> float:
        return float(self.ts[0]) if len(self.ts) else EPOCH_MIN

    @property
    def end_s(self) -> float:
        return float(self.ts[-1]) if len(self.ts) else EPOCH_MAX

    @property
    def start(self) -> Epoch:
        return Epoch.from_offset_seconds(self.start_s)

    @property
    def end(self) -> Epoch:
        return Epoch.from_offset_seconds(self.end_s)

    def contains(self, t) -> bool:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        return self.start_s <= ts <= self.end_s

    def _segment(self, ts: float):
        i = int(np.searchsorted(self.ts, ts))
        if i < len(self.ts) and self.ts[i] == ts:
            return ("knot", i)
        if i == 0 or i > len(self.ts) - 1:
            return None
        return ("seg", i - 1)

    def _hermite(self, i: int, ts: float, deriv: bool):
        t0, t1 = self.ts[i], self.ts[i + 1]
        p0, p1 = self.pos[i], self.pos[i + 1]
        v0, v1 = self.vel[i], self.vel[i + 1]
        dt = t1 - t0
        # coefficients as in CubicHermite::new (trajectory.rs:644-678)
        a0, a1 = p0, v0
        dpv = p1 - p0
        a2 = dpv * (3.0 / dt**2) - (v0 * 2.0 + v1) / dt
        a3 = dpv * (-2.0 / dt**3) + (v0 + v1) / dt**2
        x = ts - t0
        val = ((a3 * x + a2) * x + a1) * x + a0
        if not deriv:
            return val
        der = (a3 * x * 3.0 + a2 * 2.0) * x + a1
        return val, der

    def position(self, t) -> np.ndarray | None:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        seg = self._segment(ts)
        if seg is None:
            return None
        kind, i = seg
        if kind == "knot":
            return self.pos[i]
        return self._hermite(i, ts, deriv=False)

    def state_vector(self, t):
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        seg = self._segment(ts)
        if seg is None:
            return None
        kind, i = seg
        if kind == "knot":
            return self.pos[i], self.vel[i]
        return self._hermite(i, ts, deriv=True)

    def get(self, t) -> tuple[np.ndarray, np.ndarray] | None:
        """Exact-knot lookup (trajectory.rs:846-849)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        i = int(np.searchsorted(self.ts, ts))
        if i < len(self.ts) and self.ts[i] == ts:
            return self.pos[i], self.vel[i]
        return None

    def clear_after(self, t) -> None:
        """Retain knots strictly before t (trajectory.rs:835-839)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        keep = self.ts < ts
        self.ts, self.pos, self.vel = self.ts[keep], self.pos[keep], self.vel[keep]

    def extend(self, other: "HermiteTrajectory") -> None:
        self.ts = np.concatenate([self.ts, other.ts])
        self.pos = np.concatenate([self.pos, other.pos])
        self.vel = np.concatenate([self.vel, other.vel])

    def join(self, other: "HermiteTrajectory") -> None:
        """clear_after(other.start) + extend (spacecraft.rs:557-561)."""
        self.clear_after(other.start_s)
        self.extend(other)


# ---------------------------------------------------------------------------
# High-level: propagate ships against an Ephemeris
# ---------------------------------------------------------------------------


def ship_params(ship: Ship, h_init: float = 60.0, n_max: int = 1_000_000) -> AdaptiveParams:
    """INITIAL_ADAPTIVE_PARAMS with the ship's tolerance (load/mod.rs:472-486)."""
    return AdaptiveParams(
        h_init=h_init, tol_pos=ship.tolerance, tol_vel=ship.tolerance, n_max=n_max
    )


def _packed_on(ephemeris, device) -> PackedEphemeris:
    """``ephemeris`` packed on ``device`` (None: the card)."""
    device = _device.resolve(device)
    with tracing.span("spacecraft.pack"):
        if isinstance(ephemeris, PackedEphemeris):
            return PackedEphemeris(*(x.to(device) for x in ephemeris))
        return ephemeris.pack(device)


def propagate_resuming(
    method: str,
    packed: PackedEphemeris,
    tl: Timeline,
    t0: float,
    pos0,
    vel0,
    end_s: float,
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
    max_resumes: int = 1024,
) -> tuple[HermiteTrajectory, int]:
    """Propagate one ship on ``packed``'s device, resuming whenever the knot
    buffer fills.

    The reference's prediction task keeps stepping an incremental propagator
    until the bound and treats a step error as "end here, flush what we
    have" (prediction.rs:429-432).  The knot buffer is a fixed size instead,
    so a long mission can fill it (DONE_KNOTS_FULL); this wrapper restarts
    from the last emitted knot (a fresh adaptive state at that time, the
    reset the integrator performs at every burn edge, spacecraft.rs:599-615)
    until the requested end, a real error, or no progress.  Returns
    (trajectory, final reason).
    """
    logger = logging.getLogger("ephemeris_explorer_tpu_torch")
    tab = get_method(method)
    traj: HermiteTrajectory | None = None
    reason = DONE_END
    with tracing.span("spacecraft.timelines"):
        tl1 = Timeline(*(np.asarray(x)[None] for x in tl))
        cur_t = float(t0)
        cur_p = np.asarray(pos0, dtype=np.float64)
        cur_v = np.asarray(vel0, dtype=np.float64)
    for _ in range(max_resumes):
        r = _fetch(propagate_batch(tab, packed, tl1, [cur_t], cur_p[None], cur_v[None],
                                   [end_s], params, max_knots=max_knots))
        with tracing.span("spacecraft.trajectories"):
            piece = HermiteTrajectory.from_result(PropagationResult(*(x[0] for x in r)))
            reason = int(r.reason[0])
            if traj is None:
                traj = piece
            elif len(piece.ts) > 1:
                # first knot duplicates the resume point
                traj.extend(
                    HermiteTrajectory(ts=piece.ts[1:], pos=piece.pos[1:], vel=piece.vel[1:])
                )
        if reason != DONE_KNOTS_FULL:
            break
        if len(piece.ts) < 2:  # no forward progress: avoid spinning
            reason = DONE_ERROR
            break
        cur_t = float(piece.ts[-1])
        cur_p, cur_v = piece.pos[-1], piece.vel[-1]
        if cur_t >= end_s:
            reason = DONE_END
            break
        logger.info("knot buffer full at t=%s; resuming (%d knots so far)", cur_t, len(traj.ts))
    if reason == DONE_ERROR:
        logger.warning(
            "propagation stopped early (%s) at t=%s (requested end %s)",
            REASON_NAMES[reason],
            traj.end_s if traj is not None and len(traj.ts) else cur_t,
            end_s,
        )
    return traj, reason


def propagate_ship(
    ephemeris,
    ship: Ship,
    until: Epoch | None = None,
    max_knots: int = KNOT_CAPACITY,
    body_index: dict[str, int] | None = None,
    device=None,
) -> HermiteTrajectory:
    """Full mission propagation of one ship (spacecraft_propagation.rs path)
    on ``device`` (None: the card).

    ``body_index`` (name -> packed body row) is required only when
    ``ephemeris`` is a bare :class:`PackedEphemeris` (which carries no
    names) AND the ship has body-relative burns.
    """
    with tracing.span("spacecraft.propagate_ship"):
        if isinstance(ephemeris, PackedEphemeris):
            index = body_index
            if index is None and any(b.reference is not None for b in ship.burns):
                raise ValueError(
                    "PackedEphemeris carries no body names; pass body_index= "
                    "to propagate a ship with body-relative burns"
                )
        else:
            index = {n: i for i, n in enumerate(ephemeris.names)}
        packed = _packed_on(ephemeris, device)
        with tracing.span("spacecraft.timelines"):
            tl = build_timeline(ship.burns, index)
        traj, _ = propagate_resuming(
            ship.integrator,
            packed,
            tl,
            ship.start.as_offset_seconds(),
            ship.position,
            ship.velocity,
            (until or ship.end).as_offset_seconds(),
            ship_params(ship),
            max_knots=max_knots,
        )
        return traj


# ---------------------------------------------------------------------------
# Fleets: the "64 ships with flight plans" configuration
# ---------------------------------------------------------------------------


def stack_timelines(timelines: list[Timeline]) -> Timeline:
    """Pad to a common segment count and stack into (B, S) arrays."""
    s_max = max(t.n_segments for t in timelines)
    padded = []
    for t in timelines:
        pad = s_max - t.n_segments
        if pad:
            t = Timeline(
                starts=np.concatenate([np.asarray(t.starts), np.full((pad,), EPOCH_MAX)]),
                ends=np.concatenate([np.asarray(t.ends), np.full((pad,), EPOCH_MAX)]),
                accels=np.concatenate([np.asarray(t.accels), np.zeros((pad, 3))]),
                frame_kind=np.concatenate([np.asarray(t.frame_kind), np.zeros((pad,), np.int32)]),
                frame_body=np.concatenate([np.asarray(t.frame_body), np.zeros((pad,), np.int32)]),
            )
        padded.append(t)
    return Timeline(*(np.stack([np.asarray(getattr(t, f)) for t in padded])
                      for f in Timeline._fields))


def propagate_ships(ephemeris, ships, until=None, max_knots: int = KNOT_CAPACITY, device=None):
    """Propagate a fleet of Ship configs on ``device`` (None: the card),
    one batch per (integrator, tolerance) group, whatever its size.

    Returns {ship.name: HermiteTrajectory}.  A ship that fills its knot
    buffer re-runs alone through :func:`propagate_resuming`.
    """
    with tracing.span("spacecraft.propagate_ships"):
        packed = _packed_on(ephemeris, device)
        index = {n: i for i, n in enumerate(ephemeris.names)}

        groups: dict[tuple, list] = {}
        for s in ships:
            groups.setdefault((s.integrator, s.tolerance), []).append(s)

        out = {}
        for (method, _), group in groups.items():
            with tracing.span("spacecraft.timelines"):
                params = ship_params(group[0])
                tls = stack_timelines([build_timeline(s.burns, index) for s in group])
                t0s = np.asarray([s.start.as_offset_seconds() for s in group], dtype=np.float64)
                p0s = np.stack([s.position for s in group]).astype(np.float64)
                v0s = np.stack([s.velocity for s in group]).astype(np.float64)
                ends = np.asarray([(until or s.end).as_offset_seconds() for s in group],
                                  dtype=np.float64)
            r = _fetch(propagate_batch(get_method(method), packed, tls, t0s, p0s, v0s, ends,
                                       params, max_knots=max_knots))
            with tracing.span("spacecraft.trajectories"):
                for i, s in enumerate(group):
                    res = PropagationResult(*(x[i] for x in r))
                    if int(res.reason) == DONE_KNOTS_FULL:
                        traj, _ = propagate_resuming(
                            method, packed, Timeline(*(x[i] for x in tls)), float(t0s[i]),
                            p0s[i], v0s[i], float(ends[i]), params, max_knots=max_knots,
                        )
                        out[s.name] = traj
                    else:
                        out[s.name] = HermiteTrajectory.from_result(res)
        return out
