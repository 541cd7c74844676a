"""Kernel 14: the spacecraft fleet loop, its state and its wrapper.

One launch advances every live ship of a fleet by up to
:data:`ITERATIONS_PER_LAUNCH` iterations of ``spacecraft.propagate_batch``'s
loop, one block a ship: its warps evaluate the bodies at all of an
attempt's stage times at once, and one warp runs the stages.  No TPU kernel
computes it: the JAX package runs a ship's nested ``lax.while_loop``s as one
XLA program
(``ephemeris_explorer_tpu/spacecraft.py:253`` ``propagate``, vmapped over a
fleet at :715), and eager torch launches ~1,000 operations an iteration.  The CUDA source is
``csrc/fleet_scan.cu``; its header note says what the kernel computes, in
which order, and what bounds it on an H100.

Its plain version is the eager loop, ``spacecraft.propagate_batch_plain``,
which ``spacecraft.propagate_batch`` runs for CPU tensors; for CUDA tensors
it runs :func:`fleet_scan` until every ship is done, one host read of the
done flags a launch, and a failed build or launch raises.  The two agree
bitwise on the card.

The kernel is instanced by tableau, one instance for each of
``integrators.ADAPTIVE_METHODS`` (``csrc/fleet_tableaux.cuh``): :func:`plan`
takes the instance whose coefficients equal the tableau's bit for bit, and
refuses a tableau that no instance matches.

The ship state lives on the device between launches, one row a field:
``fstate`` (:data:`F_ROWS`, B) f64 and ``istate`` (:data:`I_ROWS`, B)
int64 (:func:`start_state`); the knot buffer is the eager loop's (B,
max_knots + 1, 7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..integrators import ADAPTIVE_METHODS, get
from .cuda_nbody import _check_input, on_device

F64, I64 = torch.float64, torch.int64
# fstate rows: t, the state (position, velocity), next_h, h_try, the FSAL cache
F_T, F_Y, F_NEXT_H, F_H_TRY, F_CACHE, F_ROWS = 0, 1, 7, 8, 9, 15
# istate rows: segment, knot count, end reason, attempts in the advance, inside
# an advance, FSAL cache stale, done, iterations run in the last launch
I_SEG, I_COUNT, I_REASON, I_N, I_IN_ADV, I_STALE, I_DONE, I_ITERS, I_ROWS = range(9)
# Iterations of the loop a launch gives each live ship before the host reads
# the done flags (~20 ms at full_solar_system's ~19 us an iteration of
# Verner87 on an H100).
ITERATIONS_PER_LAUNCH = 1024


class Plan(NamedTuple):
    """A tableau's and a batch's kernel arguments, built once a call."""

    instance: int           # the tableau's in instances()
    prm: np.ndarray         # host f64: h_init, h_max, fac, fac_min, fac_max, 1/tol_pos,
    #                         1/tol_vel, -1/lower_order
    n_max: int
    fsal: bool
    burns: bool
    frames: bool


def _bits(tab) -> np.ndarray:
    """The tableau's coefficients as bits: c, a, b, e (ERKNG: c, ap, av, bp,
    bv, ep, ev), each flattened, in turn."""
    keys = ("c", "ap", "av", "bp", "bv", "ep", "ev") if hasattr(tab, "ap") else ("c", "a", "b", "e")
    return np.concatenate([np.asarray(getattr(tab, k), dtype=np.float64).ravel()
                           for k in keys]).view(np.uint64)


@functools.cache
def instances() -> tuple[tuple[str, bool, int, np.ndarray], ...]:
    """The kernel's instances, in the numbering of ``eet_fleet_scan``'s
    ``instance`` (``EET_FLEET_TABLEAUX``, which ``tools/gen_fleet_tableaux.py``
    writes in this order): (name, nystrom, stages, :func:`_bits`)."""
    return tuple((name, hasattr(get(name), "ap"), get(name).stages, _bits(get(name)))
                 for name in ADAPTIVE_METHODS)


def instance_of(tab) -> int:
    """The instance whose coefficients equal ``tab``'s bit for bit (ERK or
    ERKNG alike, the same stage count); ValueError for a tableau that none
    matches."""
    nystrom, bits = hasattr(tab, "ap"), _bits(tab)
    for i, (_, ny, s, want) in enumerate(instances()):
        if ny == nystrom and s == tab.stages and np.array_equal(want, bits):
            return i
    raise ValueError(f"kernel 14 has no instance for {tab.name}: its coefficients are none of "
                     f"{', '.join(ADAPTIVE_METHODS)}, bit for bit")


_INSTANCES: dict = {}


def plan(tab, params, burns: bool, frames: bool) -> Plan:
    """The kernel's arguments for ``tab`` (one of the adaptive ERK or ERKNG
    tableaux it has an instance for) and ``params`` (``AdaptiveParams``);
    the instance is found once a tableau."""
    entry = _INSTANCES.get(id(tab))
    if entry is None:
        entry = _INSTANCES[id(tab)] = (tab, instance_of(tab))
    prm = np.asarray([params.h_init, params.h_max, params.fac, params.fac_min, params.fac_max,
                      1.0 / params.tol_pos, 1.0 / params.tol_vel,
                      -1.0 / float(tab.lower_order)], dtype=np.float64)
    return Plan(entry[1], prm, int(params.n_max), bool(tab.fsal), bool(burns), bool(frames))


def start_state(t: torch.Tensor, pos0: torch.Tensor, vel0: torch.Tensor, seg: torch.Tensor,
                h_init: float):
    """(fstate, istate) of B ships at their start: (t, pos0, vel0), next_h =
    h_init, the segment ``seg``, one knot, the FSAL cache stale."""
    b = t.shape[0]
    fstate = torch.zeros((F_ROWS, b), dtype=F64, device=t.device)
    fstate[F_T] = t
    fstate[F_Y:F_Y + 3] = pos0.T
    fstate[F_Y + 3:F_Y + 6] = vel0.T
    fstate[F_NEXT_H:F_H_TRY + 1] = h_init
    istate = torch.zeros((I_ROWS, b), dtype=I64, device=t.device)
    istate[I_SEG] = seg
    istate[I_COUNT] = 1
    istate[I_STALE] = 1
    return fstate, istate


def _require_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"kernel 14 runs on CUDA tensors, not on {dev}: the CPU's fleet loop "
                         f"is spacecraft.propagate_batch_plain")


def fleet_scan(p: Plan, eph, tl, end_t: torch.Tensor, fstate: torch.Tensor,
               istate: torch.Tensor, knots: torch.Tensor) -> None:
    """One launch of kernel 14: every live ship of ``fstate``/``istate``
    advances by up to :data:`ITERATIONS_PER_LAUNCH` iterations, appending
    its knots to ``knots`` (B, K + 1, 7); istate's ``I_ITERS`` row says how
    many each ran.  ``eph`` a ``PackedEphemeris`` and ``tl`` the stacked ``Timeline``
    (ends (B, S), accels (B, S, 3), frame kinds and bodies (B, S) int64)
    and ``end_t`` (B,), all contiguous on the card.  Raises if the build or
    the launch fails."""
    dev = fstate.device
    _require_cuda(dev)
    b = fstate.shape[1]
    n_seg = tl.ends.shape[-1]
    n = eph.mus.shape[0]
    _check_input("fstate", fstate, (F_ROWS, b), dev, F64)
    _check_input("istate", istate, (I_ROWS, b), dev, I64)
    _check_input("knots", knots, (b, knots.shape[1], 7), dev, F64)
    _check_input("end_t", end_t, (b,), dev, F64)
    _check_input("ends", tl.ends, (b, n_seg), dev, F64)
    _check_input("accels", tl.accels, (b, n_seg, 3), dev, F64)
    _check_input("frame_kind", tl.frame_kind, (b, n_seg), dev, I64)
    _check_input("frame_body", tl.frame_body, (b, n_seg), dev, I64)
    for name in ("mus", "starts", "intervals"):
        _check_input(name, getattr(eph, name), (n,), dev, F64)
    for name in ("offsets", "nsegs"):
        _check_input(name, getattr(eph, name), (n,), dev, I64)
    _check_input("coeffs", eph.coeffs, (eph.coeffs.shape[0], 9, 3), dev, F64)
    if knots.shape[1] < 2 or b < 1 or n_seg < 1:
        raise ValueError(f"kernel 14 needs a ship, a segment, a knot row and a sink: B = {b}, "
                         f"S = {n_seg}, K + 1 = {knots.shape[1]}")
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_fleet_scan(
            p.instance, p.prm.ctypes.data, p.n_max, int(p.fsal), int(p.burns), int(p.frames),
            eph.mus.data_ptr(), eph.starts.data_ptr(),
            eph.intervals.data_ptr(), eph.offsets.data_ptr(), eph.nsegs.data_ptr(),
            eph.coeffs.data_ptr(), n, tl.ends.data_ptr(), tl.accels.data_ptr(),
            tl.frame_kind.data_ptr(), tl.frame_body.data_ptr(), n_seg, end_t.data_ptr(),
            fstate.data_ptr(), istate.data_ptr(), knots.data_ptr(), b, knots.shape[1] - 1,
            ITERATIONS_PER_LAUNCH, stream)
    _build.check(err, "fleet_scan")
    fleet_scan.launches += 1


fleet_scan.launches = 0
