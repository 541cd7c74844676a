#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ephemeris_explorer_tpu_torch/csrc``
(one ``nvcc`` per source, started together), holds each kernel form against
its plain PyTorch version on the card, and drives the port's paths through
them:

* the main path, QT12 generation of fitted, evaluable ephemerides: kernels
  1 and 2 against their plain versions, the N = 4096 step, generation at
  N = 4096 in native f64 and through the fused two-float branch with its
  gate patched on (phases 3-6), and a year of the bundled full_solar_system
  scene at ``"f64"`` through kernel 11-f64, one launch a chunk, beside the
  eager native-f64 loop and against the CPU, then 30 days of it backward
  through kernel 11-f64 against the CPU (phase 7);
* the expansion-state engine: kernel 3 (3-limb pair force) and kernel 4
  (4-limb update) against their plain versions (phases 8-9), the N = 4096
  parity step ``elm2_step_qf(precise_sums=True)`` through both (path B,
  phase 10), and ``precision="extended3"`` generation of full_solar_system
  through kernel 3 (path A, phase 11);
* the force-mode ladder: kernels 5 (f32), 6 (mixed), 7 (masked f32) and 8
  (two-float strong-pair correction, both entries: the limb-fed one
  bitwise to its plain version, the production f64 form bitwise to the
  route it replaces) against their plain versions and the JAX package's
  bars for the modes (phases 12-15; kernels 5-7 also twice bitwise, and
  5-8 with their share of their bound), and the ladder at N = 4096 as
  ``bench.py:438-604`` drives it, 400 force evaluations per mode, with each
  mode's error against native f64 (path C, phase 16);
* ensembles and the row decomposition: kernel 1's ensemble and rows forms,
  kernel 3's rows form and kernel 9 against their plain versions and the
  square forms (phases 17-19), ``ensemble16x4096`` as ``bench.py:379-435``
  drives it through kernel 1's ensemble form and kernel 2 (path D, phase
  20), and the row-sharded scans and the data-parallel ensemble at one NCCL
  rank, bitwise against the unsharded ones (path E, phase 21);
* the last four TPU kernel forms: the packed entry points of kernels 2 and 4
  (2', 4'), the symmetric pair force (kernel 10) and the whole-chunk
  generation kernel (kernel 11) against their plain versions (phases
  22-24); one year of full_solar_system through kernel 11, against native
  f64 and the fused two-float step, and its generation through the private
  gate (path F, phase 25); kernel 10 at N = 4096 in a 400-evaluation loop
  and a 25-step scan (path G, phase 26); ``ensemble16x4096`` on the packed
  carry as ``bench.py:398-402`` drives it (path H, phase 27); and the
  packed parity step ``elm2_step_qfp(precise_sums=True)`` (path I, phase
  28);
* kernel 11 redesigned for the card: kernel 11-f64, a whole native-f64
  generation chunk in one block, against its plain version on three scenes
  and at its cap of 256 bodies, and stepping backward (h < 0) on the three
  scenes (phase 29; its main path is phase 7);
* kernels 9 and 4 redesigned for the card: kernel 9 on kernel 8's lane
  loop, both of its entries bitwise to their plain versions (K up to 200)
  and its f64 entry to the ``corr="dd"`` route it replaced, that rung four
  launches an evaluation (phase 19); kernel 4 also bitwise at ragged M and
  on Stormer13 (phase 9);
* kernel 2 redesigned for the card, with the F step's ring shift folded in:
  its shift entries (update and shifted rings in one launch) bitwise to
  their plain versions beside the update entries, also at ragged M and on
  Stormer13 (phases 4 and 22); the F step through the shift entry and
  kernel 1 writing the new force-ring row, no concatenation nor force
  copy a step, bitwise to the step before the fold (phase 5);
  paths D and H through the shift entries, path H bitwise to its step
  before the fold (phases 20 and 27);
* the faults F2 and F3 repaired: the f64 ensemble startup and scan of path
  D launch no kernel, each member's force bitwise the single-system eager
  f64 force (phase 20); the gated fused generation branch launches kernel
  2's shift entry and no kernel 1 (phase 6); path F's distance from native
  f64 on the fixed fused route beside kernel 1's (phase 25);
* the second half of the main path, spacecraft: 440 days of
  full_solar_system at ``"f64"`` through kernel 11-f64, then the bundled
  Mars Transfer Ship flown to 1951-01-01 by ``propagate_ship`` on the card,
  within 10,000 km of Earth and Mars at the reference's four epochs, beside
  the CPU port's flight, and the Earth Station coast on both devices
  (phase 30); fleet64, ``bench.py``'s 64 burning ships in one batch of
  ``propagate_ships``, against single-ship runs (phase 31).  Both print the
  fleet loop's iterations, host syncs and aten ops an iteration;
* the session layer, a mission planner's session through ``api.Universe``
  on the card (phase 32): full_solar_system loaded, 440 days generated
  forward (bitwise to phase 30's coefficients) and 30 backward through
  kernel 11-f64, the Mars Transfer Ship replanned to the night after its
  Mars capture burn (bitwise to phase 30's flight up to that epoch), its SOI
  transitions and apsides (bitwise between the card's pack and the CPU's), an edit of its last burn replanned incrementally (every
  earlier knot and event kept bitwise), a background extension paused and
  resumed under a reader thread (bit-stable reads), and the interpolation
  audit re-integrating the span through kernel 11-f64; the host time of
  each step.

Every launch count is set to 0 just before a path is driven and read just
after.  Each phase prints one line; then the run's total seconds; the line
before the last is the kernels' JSON record (each form's launches on its
path, kernel 11-f64's also on each path that runs it, error against its
plain version, times, and the least time the card could take,
:func:`bound_of`) and the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits nonzero and prints no result.
Without a CUDA device it exits nonzero at once.  It imports no JAX.

``--phases`` runs a subset (for debugging; the result lines are printed only
when all phases ran).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_BODIES = 4096
H = 600.0              # step, seconds
FLAGSHIP_STEPS = 400
GEN_STEPS = 2048
GEN_CHUNK = 1024
EXT_DAYS = 10.0        # path A span: 1440 steps of full_solar_system
ALL_PHASES = ",".join(str(p) for p in range(1, 33))

KERNEL1_VS_PLAIN = 1e-13   # max|d| / max|ref|, kernel 1 against its plain version
KERNEL1_VS_F64 = 1e-12     # against native f64 (test_pallas_accel_matches_f64's bar)
# ... except on full_solar_system: the two-float positions round at 2^-48 of
# the heliocentric radius, ~1e-10 of the Phobos-Mars separation; the JAX
# package's kernel shows 5.2e-12 there too (3-limb positions fix it, kernel 3)
KERNEL1_VS_F64_FSS = 1e-11
KERNEL2_BOUND = 2.0**-48   # times max|y|; same ops in the same order: expect bitwise
KERNEL3_VS_PLAIN = 1e-13   # max|d| / max|ref|, kernel 3 against its plain version
KERNEL3_VS_F64 = 1e-12     # against native f64 from exact host limbs, on every input
# Path B's fused step (kernel 4's precise beta sum) against the unfused step
# (the precise cascade), two arithmetics of one grade, compared on the full
# 4-limb expansions, times max|y|.  Measured on an H100 at N = 4096: one
# step 2^-79.5; kernel 4 in its two-float (plain) mode parts from the
# unfused step by 2^-50.0.  After 25 steps 2^-58.5 against plain mode's
# 2^-48.0: the deep differences move limb 2 of a few bodies by an ulp, the
# force sees that, and the cluster amplifies it.  Both runs are deterministic.
# The phase runs plain mode too and checks that both bounds see it, and holds
# the fused step at depth bitwise to kernel 4's plain version plus kernel 3.
QF_STEP_BOUND = 2.0**-70
QF_EARLY_BOUND = 2.0**-54
# Path A's integrated positions after EXT_DAYS, compared on the propagators'
# carried states (evaluated polynomials would add the metre-level f64
# rounding of degree-8 fits to ~1.4e9 km heliocentric samples).  Against
# "extended" (the same expansion state, f64 force): 1e-3 km, the bar of
# test_extended_precision_generation (measured on CPU: 6.9e-6 km).  Against
# "f64" that bar is out of reach: the f64 state's own rounding parts it from
# the expansion state by 4.19e-3 km at Charon on CPU (JAX package and port
# alike) and by 2.44e-2 km at Triton on an H100, so "f64" is held to 0.1 km.
EXT3_VS_EXT_KM = 1e-3
EXT3_VS_F64_KM = 1e-1
# The 4096-body cluster at h = 600 s is chaotic: two native-f64 runs started
# 2^-48 apart differ by the whole system size after 400 steps (measured on
# an H100), so no two implementations that round differently can agree there.
# The state is therefore held tightly where rounding has not yet been
# amplified (a two-float state rounds at 2^-48 per step, measured 3e-13 of
# max|y| after 25 steps; a broken error-free transform shows at ~2^-24 after
# one step), and at 400 steps the fused run must shadow the f64 run as
# closely as f64 shadows itself from a start rounded to two-float.
EARLY_STEPS = 25
EARLY_BOUND = 1e-10        # times max|y|, after EARLY_STEPS steps / in the first segment
SHADOW_FACTOR = 10.0       # median divergence vs the f64 chaos floor's, after 400 steps
# The force-mode ladder (kernels 5-8).  Kernels 5-7 against their plain
# versions: the f32 sums run in another order (the plain version's torch.sum
# against the kernel's source order; measured on CPU at N = 4096: 9e-8 of
# max|a| between the two orders), of max|a|.  Kernel 8: the plain version's
# chain and tree, op for op, with CUDA's rsqrtf on both sides: checked
# bitwise, and also held to STRONG_VS_PLAIN of max|c|.
F32_VS_PLAIN = 1e-6
STRONG_VS_PLAIN = 1e-14
STRONG_K = 16              # bench.py:565
LADDER_EVALS = 400         # bench.py STEPS_PER_CHUNK: one strong-set refresh per chunk
# Path C's errors against native f64 on the cluster at N = 4096, max|d|/max|a|
# (on CPU at N = 2048: f32 3.3e-6, mixed 1.4e-7, split 3.2e-8; f32 at N = 4096
# 2.6e-5): each mode's documented grade with a decade of room, and split
# below f32 (the point of the mode).
LADDER_BOUNDS = {"f32": 1e-4, "mixed": 1e-6, "split": 4e-7}
# CUDA's f64 rsqrt is not correctly rounded, so the CUDA and CPU runs part at
# the ulp level; the multistep grows that over 4320 steps to ~1e-13 of the
# positions.  Coefficients are compared in sample space (see _coeff_err).
FSS_BOUND = 1e-10
# Slice 4: ensembles and the row decomposition.  Path D is bench.py:379-435's
# ensemble16x4096: cluster seeds 0..15 with mu from seed 0, QT12, h = 600 s,
# in 50-step scans.  Its f64 scan (kernel 1's ensemble form, f64 in and out)
# is held to per-member native f64 after EARLY_STEPS at EARLY_BOUND, like the
# flagship step; its pair-native scan to the single-system fused step
# bitwise.  Kernel 9 is within 3e-13 per body of the f64 correction
# (test_strong_correction_df64_matches_f64's bar).
ENSEMBLE = 16
ENS_SCAN_STEPS = 50
ENS_TIMED_SCANS = 2
DD_VS_F64 = 3e-13
# Slice 5.  Kernel 10 against kernel 1: 2^-44 of max|a|, the bar of
# test_symmetric_kernel_matches_row_sweep; against its plain version bitwise
# (same ops in the same order), checked at the same bar.  Kernel 11 against
# its plain version over GEN_CHECK_STEPS on three scenes: 2^-44 of max|y|
# (expect bitwise).  Path F holds kernel 11's year of full_solar_system to
# the envelope of test_gen_scan_kernel_matches_plain with native f64 in
# place of the dd truth: after the first chunk, err <= max(GEN_ENVELOPE x
# the fused two-float route's err (kernels 1 + 2), 2^-42 max|y|); its force
# ring head to native f64 at kernel 1's full_solar_system bar (two-float
# positions of the Phobos-Mars pair), and its generated coefficients to
# native f64 in sample space within max(GEN_ENVELOPE x the fused route's,
# FSS_BOUND).
SYM_VS_KERNEL1 = 2.0**-44
GEN_CHECK_STEPS = 64
GEN_VS_PLAIN = 2.0**-44
GEN_ENVELOPE = 5.0
GEN_FLOOR = 2.0**-42
GEN_YEAR_STEPS = 52560      # one year at dt = 10 min
GEN_SCENES = ("full_solar_system_2433282.5", "simple_solar_system_2433282.5",
              "sun_earth_moon_2433282.5")
# Slice 6.  Kernel 11-f64 against its plain version over GEN_CHECK_STEPS on
# GEN_SCENES and the cloud at its cap of 256 bodies: the same ops in the same
# order with CUDA's f64 rsqrt on both sides, so bitwise is expected; the
# check is 2^-50 of max|y|.  Its time per step over GEN64_TIMED_STEPS.
# Phase 7 holds the year's generation to the CPU at FSS_BOUND, and after one
# chunk its distance from the CPU's eager loop to max(GEN_ENVELOPE x the
# eager CUDA loop's, GEN_FLOOR max|y|), path F's envelope.
GEN64_VS_PLAIN = 2.0**-50
BACK_DAYS = 30.0            # phase 7's backward span of full_solar_system
GEN64_CAP = 256
GEN64_TIMED_STEPS = 4096
# Slice 11: spacecraft.  The mission is tests/test_mission.py's: 440 days of
# full_solar_system at "f64" (kernel 11-f64, one launch a chunk), the
# bundled Mars Transfer Ship flown to 1951-01-01 with a 65,536-knot buffer,
# within MISSION_KM of Earth and Mars at the reference's four epochs
# (spacecraft_propagation.rs:476-480).  The card's flight against the CPU
# port's on the same ephemeris is printed; the Earth Station coast
# (sun_earth_moon) is held between the two devices to FLEET_VS_SINGLE_KM at
# 0.1, 0.5 and 0.9 of its span, the JAX package's batched-vs-single bar
# (tests/test_spacecraft.py:210-217).  fleet64 is bench.py:304-351's: 64
# Verner87 ships at 1e-3 km, each with one 600 s Sun-relative burn, over
# FLEET_DAYS against FLEET_EPH_DAYS of full_solar_system, every span over
# FLEET_MIN_SPAN_DAYS (bench.py:351); FLEET_SINGLES fly alone against the
# batch at FLEET_VS_SINGLE_KM.
MISSION_EPH_DAYS = 440.0
MISSION_UNTIL = "1951-01-01 00:00:00"
MISSION_KNOTS = 65536
MISSION_KM = 10_000.0
MISSION_EPOCHS = (("Earth", "1950-01-01 00:00:00"), ("Earth", "1950-01-01 00:15:00"),
                  ("Mars", "1950-07-27 15:45:00"), ("Mars", "1951-01-01 00:00:00"))
MISSION_COUNT_DAYS = 2.0    # the start of the flight, flown again under a dispatch mode
FLEET_SHIPS = 64
FLEET_DAYS = 300.0
FLEET_EPH_DAYS = 320.0
FLEET_MIN_SPAN_DAYS = 290.0
FLEET_KNOTS = 8192
FLEET_RUNS = 3
FLEET_SINGLES = (0, 1, 31, 63)
FLEET_VS_SINGLE_KM = 1e-2
# The Universe session (phase 32), the planner's loop on the card:
# full_solar_system loaded into an api.Universe, MISSION_EPH_DAYS generated
# forward (bitwise to phase 30's coefficients), the Mars Transfer Ship
# replanned to SESSION_UNTIL (its knots bitwise to phase 30's flight up to
# the last, which the plan end clips: the same function on the same
# coefficients), then BACK_DAYS generated backward.  SESSION_UNTIL cuts
# phase 30's 1951-01-01 to the night after the Mars capture burn: it keeps
# all four burns, the Earth SOI exit and the Mars SOI entry, and drops the
# five months in Mars orbit that hold 99% of the knots (two more flights of
# those would take the smoke past 800 s).  The ship is replanned before the
# backward span lands because the start epoch is then a segment boundary,
# where the end-inclusive segment rule evaluates the backward segment at
# tau = 1 and the first step's force moves by the fits' boundary mismatch.
# The events are scanned on the card's pack and on the CPU's (bitwise); the
# last burn's acceleration x EDIT_FACTOR is replanned incrementally (every
# knot and event before the restart bitwise); an EXTEND_DAYS background
# extension, paused and resumed, races a reader thread (bit-stable reads);
# the interpolation audit re-integrates the generated span through kernel
# 11-f64 and must stay within AUDIT_BAR_M.
SESSION_UNTIL = "1950-07-28 00:00:00"
EDIT_FACTOR = 1.01
EXTEND_DAYS = 60.0
AUDIT_BAR_M = 1000.0
# aten ops that only make a view or a host scalar: no device launch
VIEW_OPS = frozenset({"aten::view", "aten::_unsafe_view", "aten::unsqueeze", "aten::squeeze",
                      "aten::select", "aten::slice", "aten::expand", "aten::as_strided",
                      "aten::t", "aten::transpose", "aten::permute", "aten::alias",
                      "aten::detach", "aten::lift_fresh", "aten::scalar_tensor",
                      "aten::_local_scalar_dense", "aten::is_nonzero"})
SMS = 132  # an H100 SXM's SMs: a one-block kernel's bound is the card's x SMS


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3
# 3.35 TB/s; f32 67 TFLOP/s and f64 34 TFLOP/s outside the tensor cores, each
# counting an FMA as two operations.  The kernels are built with --fmad=false, so every add and
# every multiply executes alone: one operation per lane per cycle, half those
# rates.  An rsqrt counts as one operation.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12 / 2, "float64": 34e12 / 2}


def op_counter():
    """A dispatch mode that counts the element operations of the aten calls
    under it, by dtype: each add, sub, mul, div, neg, rsqrt and sqrt counts
    its output's elements, each sum its input's.  Run over a kernel's plain
    version, which repeats the kernel's arithmetic op for op, it counts the
    operations the kernel does on those inputs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    elementwise = {aten.add, aten.sub, aten.mul, aten.div, aten.neg, aten.rsqrt, aten.sqrt}

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            packet = func.overloadpacket
            ref = out if packet in elementwise else args[0] if packet is aten.sum else None
            if isinstance(ref, torch.Tensor):
                key = str(ref.dtype).replace("torch.", "")
                self.ops[key] = self.ops.get(key, 0) + ref.numel()
            return out

    return OpCount()


def bound_of(plain, tensors) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    the bytes of ``tensors`` (its inputs and outputs, each moved once) over
    the memory rate, and the operations ``plain()`` does over the peak rate
    of their type."""
    with op_counter() as count:
        plain()
    unique = {id(t): t for t in tensors}.values()
    nbytes = sum(t.numel() * t.element_size() for t in unique)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[dt] for dt, n in count.ops.items() if dt in PEAK_OPS_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": {dt: n for dt, n in count.ops.items() if dt in PEAK_OPS_S}}


def kernel_record(max_abs_err, ms, plain_ms, bound) -> dict:
    """A kernel's entry of the kernels line, less its launches (no single
    PyTorch call computes any of these kernels' functions: library_ms is
    null)."""
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None}


def _shift_same(a, b) -> bool:
    """Two (y, ys_new, dd_new) of kernel 2's shift form bitwise equal, but for
    dd_new[0], which the kernel leaves to the force."""
    import torch

    pairs = [(a[0].hi, b[0].hi), (a[0].lo, b[0].lo), (a[1].hi, b[1].hi), (a[1].lo, b[1].lo),
             (a[2].hi[1:], b[2].hi[1:]), (a[2].lo[1:], b[2].lo[1:])]
    return all(torch.equal(x, y) for x, y in pairs)


def _rows_read(ys, dd, coef, c_y, shift: bool) -> list:
    """The rows of the rings ys, dd that kernel 2 reads: those with a nonzero
    coefficient, and with ``shift`` every row the shift moves."""
    order = len(c_y)
    out = []
    for j in range(order):
        moved = shift and j < order - 1
        if moved or c_y[j] != 0.0:
            out += [ys.hi[j], ys.lo[j]]
        if moved or coef[j, 0] != 0.0:
            out += [dd.hi[j], dd.lo[j]]
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _cluster(n, seed=0):
    """The synthetic 4096-body cluster (same recipe as bench.py's _cluster)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    vel = rng.normal(size=(n, 3)) * 1.0
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    return pos, vel, mu


def ladder_loops(p64, m64, dd: bool = False) -> dict:
    """Path C: the force-mode ladder's evaluation loops as ``bench.py:438-604``
    drives them, each adding 1e-30 of the force to the state.  ``p64`` (N, 3)
    f64 positions and ``m64`` (N,) f64 mu on the card.  Returns {mode: (loop,
    start state, kernel names)}, where ``loop(state, evals)`` runs ``evals``
    force evaluations and returns the state.  ``dd`` adds the split rung with
    ``corr="dd"`` (kernel 9 in place of kernel 8) as "split_dd"."""
    from ephemeris_explorer_tpu_torch.ops import cuda_f32, cuda_mixed, cuda_nbody, cuda_split
    from ephemeris_explorer_tpu_torch.ops import split

    mu32 = m64.float().reshape(1, -1)

    def f32_loop(p, evals):       # bench_f32_fast's scan body
        for _ in range(evals):
            p = p + cuda_f32.pairwise_accel_f32(p, mu32) * 1e-30
        return p

    def mixed_loop(c, evals):     # bench_mixed's
        for _ in range(evals):
            a = cuda_mixed.pairwise_accel_mixed(c[0], c[1], mu32)
            c = ((c[0] + a.t() * 1e-30).contiguous(), c[1])
        return c

    def split_loop(corr):         # bench_split's: the strong set refreshed once per chunk
        def loop(p, evals):
            idx = split.strong_pair_indices(p, m64, k=STRONG_K)
            mask = split.strong_pair_mask(idx, p.shape[0])
            for _ in range(evals):
                p = p + cuda_split.pairwise_accel_split(p, m64, idx, mask, corr=corr) * 1e-30
            return p
        return loop

    loops = {"f32": (f32_loop, p64.float(), ("accel_f32",)),
             "mixed": (mixed_loop, cuda_nbody.split_f64(p64, transpose=True), ("accel_mixed",)),
             "split": (split_loop("fast"), p64, ("accel_f32_masked", "strong_corr"))}
    if dd:
        loops["split_dd"] = (split_loop("dd"), p64, ("accel_f32_masked", "strong_corr_dd"))
    return loops


def _fleet_ships(sc, eph, n_ships: int, mission_days: float):
    """bench.py:304-338's synthetic heliocentric fleet around Earth's orbit,
    each ship with one 600 s Sun-relative (TNB) burn, as the port's Ships."""
    from ephemeris_explorer_tpu_torch.ftime import Duration, Epoch
    from ephemeris_explorer_tpu_torch.io.scene import Ship, ShipBurn

    rng = np.random.default_rng(42)
    t0 = sc.state.epoch.as_offset_seconds() + 86400.0
    ep, ev = eph["Earth"].state_vector(t0)
    ships = []
    for k in range(n_ships):
        offset = rng.normal(size=3) * 5.0e5 + np.array([2.0e6, 0.0, 0.0])
        dv = 1.0 + rng.normal(size=3) * 1e-3
        burns = [ShipBurn(start=Epoch.from_offset_seconds(t0 + 10 * 86400.0 + k * 3600.0),
                          duration=Duration.from_seconds(600.0),
                          acceleration=np.array([2e-3, 0.0, 0.0]), reference="Sun")]
        ships.append(Ship(name=f"fleet-{k}", integrator="Verner87", tolerance=1e-3,
                          start=Epoch.from_offset_seconds(t0),
                          end=Epoch.from_offset_seconds(t0 + mission_days * 86400.0),
                          position=ep + offset, velocity=ev * dv, burns=burns))
    return ships


def _traj_km(a, b, fracs=(0.1, 0.5, 0.9)) -> float:
    """Largest distance between two trajectories at fractions of a's span."""
    worst = 0.0
    for f in fracs:
        t = a.start_s + f * (a.end_s - a.start_s)
        pa, pb = a.position(t), b.position(t)
        check(pa is not None and pb is not None, f"a trajectory does not cover t = {t}")
        worst = max(worst, float(np.abs(pa - pb).max()))
    return worst


def _coeff_err(a: dict, b: dict, settings, backward=False) -> float:
    """Worst per-body coefficient difference in sample space: each degree's
    difference divided by the fit matrix's row norm (the most a unit sample
    difference can move it) and by the body's max |position|."""
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    worst = 0.0
    for name, ca in a.items():
        cb = b[name]
        assert ca.shape == cb.shape, (name, ca.shape, cb.shape)
        if not ca.size:
            continue
        norm = np.abs(fit_matrix(settings.settings[name].degree, backward)).sum(1)
        rows = norm > 0
        d = np.abs(ca - cb).max(axis=(0, 2))[rows] / norm[rows]
        worst = max(worst, float(d.max() / np.abs(ca[:, 0]).max()))
    return worst


def _worst_bodies(d, sc, k=4) -> dict:
    """The k bodies of scene ``sc`` with the largest distance in ``d`` (N, 3),
    with that distance in km."""
    dist = d.norm(dim=1)
    top = dist.topk(k).indices.tolist()
    return {sc.state.bodies[b].name: dist[b].item() for b in top}


def _raw_coeff_err(a: dict, b: dict) -> float:
    return max(
        float(np.abs(a[n] - b[n]).max() / np.abs(a[n]).max()) for n in a if a[n].size
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=ALL_PHASES)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_smoke = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ephemeris_explorer_tpu_torch as port
    from ephemeris_explorer_tpu_torch import _build, ephemeris as eph
    from ephemeris_explorer_tpu_torch.integrators import get
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.io import scene
    from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_elm2q, cuda_limbs, cuda_nbody, nbody
    from ephemeris_explorer_tpu_torch.ops import cuda_f32, cuda_gen, cuda_mixed, cuda_split
    from ephemeris_explorer_tpu_torch.ops import cuda_sym, split
    from ephemeris_explorer_tpu_torch.ops import expansion as ex
    from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh
    from ephemeris_explorer_tpu_torch import spacecraft as sc_

    launchers = {"accel_df64": cuda_nbody.pairwise_accel_df64,
                 "elm2f_update": cuda_elm2.elm2f_update,
                 "elm2f_update_shift": cuda_elm2.elm2f_update_shift,
                 "accel_limbs3": cuda_limbs.pairwise_accel_limbs_pair,
                 "elm2q_update": cuda_elm2q.elm2q_update,
                 "accel_f32": cuda_f32.pairwise_accel_f32,
                 "accel_mixed": cuda_mixed.pairwise_accel_mixed,
                 "accel_f32_masked": cuda_f32.pairwise_accel_f32_masked,
                 "strong_corr": cuda_split.strong_correction_pair,
                 "accel_df64_ensemble": cuda_nbody.pairwise_accel_df64_ensemble,
                 "accel_df64_rows": cuda_nbody.pairwise_accel_df64_rows,
                 "accel_limbs3_rows": cuda_limbs.pairwise_accel_limbs_pair_rows,
                 "strong_corr_dd": cuda_split.strong_correction_dd,
                 "elm2f_update_packed": cuda_elm2.elm2f_update_packed,
                 "elm2f_update_shift_packed": cuda_elm2.elm2f_update_shift_packed,
                 "elm2q_update_packed": cuda_elm2q.elm2q_update_packed,
                 "accel_sym": cuda_sym.pairwise_accel_df64_sym,
                 "gen_scan": cuda_gen.elm2_gen_scan,
                 "gen_scan_f64": cuda_gen.elm2_gen_scan_f64}

    def reset_counts():
        for fn in launchers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in launchers.items()}

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    f64 = torch.float64
    tab = get("QuinlanTremaine12")

    # -- phase 1: environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"phase": 1, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))

    def cuda_ms(fn, reps: int, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def graph_ms(fn, reps: int) -> float:
        """Device time per call: `reps` calls captured in one CUDA graph and
        replayed, so host-side launch work drops out."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def step_ops(step, c) -> dict:
        """The aten ops one step of `step` dispatches, by name, under a
        dispatch mode (the ctypes kernels do not show; their counters do).
        No torch.profiler here: a window opened before phase 19's has been
        seen to leave that one without the library's kernels."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class AtenOps(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func.overloadpacket).replace("aten.", "aten::")
                self.ops[name] = self.ops.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        with AtenOps() as aten:
            step(c)
        torch.cuda.synchronize()
        return aten.ops

    record = {}

    # -- phase 2: build -------------------------------------------------------
    if 2 in phases:
        t0 = time.perf_counter()
        lib = _build.library()
        regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
                if "registers" in ln]
        check((lib.eet_f32_pair_tile(), lib.eet_f32_pair_group())
              == (cuda_nbody.F32_PAIR_TILE, cuda_nbody.F32_PAIR_GROUP),
              "kernels 5-7 were built for another tile or receiver group than "
              "_f32_pair_geometry partitions")
        print(json.dumps({"phase": 2, "build_s": round(time.perf_counter() - t0, 3),
                          "ptxas": regs, "card": smi}))

    pos, vel, mu = _cluster(N_BODIES)
    mu_dev = torch.as_tensor(mu, dtype=f64, device=dev)
    mu_hi, mu_lo = cuda_nbody.split_f64(mu_dev.reshape(1, -1))

    @ms.writes_into
    def accel_pair_square(t, y: TwoFloat, out=None) -> TwoFloat:
        """The single-system fused force: kernel 1's square form on an (N, 3) pair."""
        return TwoFloat(*cuda_nbody.pairwise_accel_df64(
            y.hi.t().contiguous(), y.lo.t().contiguous(), mu_hi, mu_lo, out=out))

    # -- phase 3: kernel 1 against its plain version --------------------------
    if 3 in phases:
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        cases = [("cluster4096", *_cluster(N_BODIES)[::2], KERNEL1_VS_F64),
                 ("ragged1000", *_cluster(1000, seed=1)[::2], KERNEL1_VS_F64),
                 ("full_solar_system", fss.state.positions(), fss.state.mus(),
                  KERNEL1_VS_F64_FSS)]
        out = []
        for name, p, m, f64_bound in cases:
            p_dev = torch.as_tensor(p, dtype=f64, device=dev)
            m_dev = torch.as_tensor(m, dtype=f64, device=dev)
            ph, pl = cuda_nbody.split_f64(p_dev, transpose=True)
            mh, ml = cuda_nbody.split_f64(m_dev.reshape(1, -1))
            raw = cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)
            k = cuda_nbody.combine_f64(*raw)
            r = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64_plain(ph, pl, mh, ml))
            ref = nbody.pairwise_accel(p_dev, m_dev)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            abs_err = (k - r).abs().max().item()
            e_plain = abs_err / r.abs().max().item()
            e_f64 = (k - ref).abs().max().item() / scale
            check(bool(torch.isfinite(k).all()), f"kernel 1 non-finite on {name}")
            check(e_plain <= KERNEL1_VS_PLAIN, f"kernel 1 vs plain on {name}: {e_plain}")
            check(e_f64 <= f64_bound, f"kernel 1 vs f64 on {name}: {e_f64}")
            kms = cuda_ms(lambda: cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml), 20)
            pms = cuda_ms(lambda: cuda_nbody.pairwise_accel_df64_plain(ph, pl, mh, ml), 3, 1)
            gms = graph_ms(lambda: cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml), 20)
            out.append({"input": name, "n": len(p), "rel_err_vs_plain": e_plain,
                        "rel_err_vs_f64": e_f64, "f64_bound": f64_bound, "kernel_us": kms * 1e3,
                        "kernel_device_us": gms * 1e3, "plain_us": pms * 1e3})
            if name == "cluster4096":
                b = bound_of(lambda: cuda_nbody.pairwise_accel_df64_plain(ph, pl, mh, ml),
                             [ph, pl, mh, ml, *raw])
                out[-1]["bound"] = b
                record["accel_df64"] = kernel_record(abs_err, kms, pms, b)
        print(json.dumps({"phase": 3, "kernel": "accel_df64", "cases": out, "card": smi}))

    # QT12 startup at N=4096 in native f64 (shared by phases 4 and 5)
    if phases & {4, 5}:
        def accel(t, y):
            return nbody.pairwise_accel(y, mu_dev)

        @ms.writes_into
        def accel_pair(t, y: TwoFloat, out=None) -> TwoFloat:
            return TwoFloat(*cuda_nbody.pairwise_accel_df64(
                y.hi.t().contiguous(), y.lo.t().contiguous(), mu_hi, mu_lo, out=out))

        carry0 = ms.elm2_init(tab, accel, 0.0, torch.as_tensor(pos, dtype=f64, device=dev),
                              torch.as_tensor(vel, dtype=f64, device=dev), H)
        torch.cuda.synchronize()

    # -- phase 4: kernel 2 against its plain version --------------------------
    if 4 in phases:
        coef = cuda_elm2.elm2_update_coeffs(tab, H)
        c_y = np.asarray(tab.c_y, np.float32)
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        fss_mu = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        carry_fss = ms.elm2_init(
            tab, lambda t, y: nbody.pairwise_accel(y, fss_mu), 0.0,
            torch.as_tensor(fss.state.positions(), dtype=f64, device=dev),
            torch.as_tensor(fss.state.velocities(), dtype=f64, device=dev), H)
        out = []
        for name, c in (("cluster4096", carry0), ("full_solar_system", carry_fss)):
            f = ms.elm2_f_from(c)
            yk = cuda_elm2.elm2f_update(tab, H, f.ys, f.dd)
            yp = cuda_elm2.elm2f_update_plain(coef, c_y, f.ys, f.dd)
            sk = cuda_elm2.elm2f_update_shift(tab, H, f.ys, f.dd)
            sp = cuda_elm2.elm2f_update_shift_plain(coef, c_y, f.ys, f.dd)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(yk.hi, yp.hi) and torch.equal(yk.lo, yp.lo))
            diff = ((yk.hi.to(f64) - yp.hi.to(f64)) + (yk.lo.to(f64) - yp.lo.to(f64))).abs().max().item()
            ymax = c.ys[0].abs().max().item()
            check(diff <= KERNEL2_BOUND * ymax, f"kernel 2 vs plain on {name}: {diff} > 2^-48 max|y|")
            shift_bitwise = _shift_same(sk, sp)
            shift_diff = max((a.to(f64) - b.to(f64)).abs().max().item()
                             for a, b in zip((*sk[1], *(x[1:] for x in sk[2])),
                                             (*sp[1], *(x[1:] for x in sp[2]))))
            same_y = bool(torch.equal(sk[0].hi, yk.hi) and torch.equal(sk[0].lo, yk.lo))
            check(shift_bitwise and same_y,
                  f"kernel 2's shift entry on {name}: bitwise to its plain version {shift_bitwise}, "
                  f"its y to the update entry's {same_y}")
            kms = cuda_ms(lambda: cuda_elm2.elm2f_update(tab, H, f.ys, f.dd), 200)
            pms = cuda_ms(lambda: cuda_elm2.elm2f_update_plain(coef, c_y, f.ys, f.dd), 20)
            gms = graph_ms(lambda: cuda_elm2.elm2f_update(tab, H, f.ys, f.dd), 200)
            skms = cuda_ms(lambda: cuda_elm2.elm2f_update_shift(tab, H, f.ys, f.dd), 200)
            spms = cuda_ms(lambda: cuda_elm2.elm2f_update_shift_plain(coef, c_y, f.ys, f.dd), 20)
            sgms = graph_ms(lambda: cuda_elm2.elm2f_update_shift(tab, H, f.ys, f.dd), 200)

            def update_and_cats():
                """What the shift entry replaces on the F step: the update and
                four ring concatenations (a ring row standing in for the force)."""
                ms._shift(tab, cuda_elm2.elm2f_update(tab, H, f.ys, f.dd), f.ys)
                ms._shift(tab, TwoFloat(f.dd.hi[0], f.dd.lo[0]), f.dd)

            ugms = graph_ms(update_and_cats, 200)
            # the floor of graph replay: one launch of a one-element add
            one = torch.zeros(1, device=dev)
            floor_us = graph_ms(lambda: one.add_(1.0), 200) * 1e3
            out.append({"input": name, "m": f.ys.hi[0].numel(), "bitwise": bitwise,
                        "max_abs_err": diff,
                        "why_not_bitwise": None if bitwise else "results differ; within 2^-48 max|y|",
                        "kernel_us": kms * 1e3, "kernel_device_us": gms * 1e3,
                        "plain_us": pms * 1e3, "one_element_add_device_us": floor_us,
                        "shift": {"bitwise": shift_bitwise, "max_abs_err": shift_diff,
                                  "kernel_us": skms * 1e3, "kernel_device_us": sgms * 1e3,
                                  "plain_us": spms * 1e3,
                                  "update_and_four_cats_device_us": ugms * 1e3}})
            if name == "cluster4096":
                b = bound_of(lambda: cuda_elm2.elm2f_update_plain(coef, c_y, f.ys, f.dd),
                             [*_rows_read(f.ys, f.dd, coef, c_y, False), *yk])
                out[-1]["bound"] = b
                record["elm2f_update"] = kernel_record(diff, kms, pms, b)
                sb = bound_of(lambda: cuda_elm2.elm2f_update_shift_plain(coef, c_y, f.ys, f.dd),
                              [*_rows_read(f.ys, f.dd, coef, c_y, True), *sk[1], *(x[1:] for x in sk[2])])
                out[-1]["shift"]["bound"] = sb
                record["elm2f_update_shift"] = kernel_record(shift_diff, skms, spms, sb)
        # ragged M and another tableau
        ragged = []
        for name in ("QuinlanTremaine12", "Stormer13"):
            t = get(name)
            tc, tcy = cuda_elm2._tables(t, H)
            for m in (3, 99, 4095):
                rng = np.random.default_rng(m)
                ys = TwoFloat(*cuda_nbody.split_f64(torch.as_tensor(
                    rng.normal(size=(t.order, m)) * 1e8, device=dev)))
                dd = TwoFloat(*cuda_nbody.split_f64(torch.as_tensor(
                    rng.normal(size=(t.order, m)) * 1e-6, device=dev)))
                yk = cuda_elm2.elm2f_update(t, H, ys, dd)
                yp = cuda_elm2.elm2f_update_plain(tc, tcy, ys, dd)
                same = bool(torch.equal(yk.hi, yp.hi) and torch.equal(yk.lo, yp.lo)) and _shift_same(
                    cuda_elm2.elm2f_update_shift(t, H, ys, dd),
                    cuda_elm2.elm2f_update_shift_plain(tc, tcy, ys, dd))
                check(same, f"kernel 2 at M = {m} on {name}: not bitwise to its plain versions")
                ragged.append({"tableau": name, "m": m, "bitwise": same})
        print(json.dumps({"phase": 4, "kernel": "elm2f_update, elm2f_update_shift", "cases": out,
                          "ragged": ragged, "card": smi}))

    # -- phase 5: flagship step ----------------------------------------------
    if 5 in phases:
        def plain_step(c):
            return ms.elm2_step(tab, accel, H, c, with_velocity=False)

        def fused_step(c):
            return ms.elm2_step_f(tab, accel_pair, H, c)

        def cat_step(c):
            """The F step before the fold: kernel 2's update entry, kernel 1
            and the four ring concatenations (the JAX package's step)."""
            return ms._step_f_cat(tab, accel_pair, H, c)

        def run(step, c, steps):
            """`steps` steps; also returns the ring head after EARLY_STEPS."""
            early = None
            for i in range(steps):
                c = step(c)
                if i + 1 == EARLY_STEPS:
                    early = c.ys[0] if isinstance(c.ys, torch.Tensor) else (c.ys.hi[0], c.ys.lo[0])
            return c, early

        f0 = ms.elm2_f_from(carry0)
        run(plain_step, carry0, 2), run(fused_step, f0, 2), run(cat_step, f0, 2)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp, yp_early = run(plain_step, carry0, FLAGSHIP_STEPS)
        cp = cp._replace(dy=ms.elm2_velocity(tab, cp, H))
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        cf, yf_early = run(fused_step, ms.elm2_f_from(carry0), FLAGSHIP_STEPS)
        cf = cf._replace(dy=ms.elm2_velocity_f(tab, cf, H))
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        launches = read_counts()
        check(launches["accel_df64"] == FLAGSHIP_STEPS
              and launches["elm2f_update_shift"] == FLAGSHIP_STEPS
              and sum(launches.values()) == 2 * FLAGSHIP_STEPS,
              f"the F step did not run through kernel 1 and kernel 2's shift entry: {launches}")
        # the step before the fold, from the same start: the same bits
        reset_counts()
        t0 = time.perf_counter()
        cc, _ = run(cat_step, f0, FLAGSHIP_STEPS)
        torch.cuda.synchronize()
        t_cat = time.perf_counter() - t0
        launches_cat = read_counts()
        check(launches_cat["accel_df64"] == FLAGSHIP_STEPS
              and launches_cat["elm2f_update"] == FLAGSHIP_STEPS
              and sum(launches_cat.values()) == 2 * FLAGSHIP_STEPS,
              f"the F step before the fold: launches {launches_cat}")
        fold_bitwise = cc.t == cf.t and all(torch.equal(a, b) for a, b in zip(
            (*cc.ys, *cc.dd), (*cf.ys, *cf.dd)))
        check(fold_bitwise, f"the F step after {FLAGSHIP_STEPS} steps is not the step before "
                            "the fold bitwise")
        # the aten ops of a step: the folded step concatenates nothing and
        # copies no force (kernel 1 writes the new ring row); its device
        # launches a step are profile_port.py's (--loops FS)
        ops_fused, ops_cat = step_ops(fused_step, f0), step_ops(cat_step, f0)
        check("aten::cat" not in ops_fused and "aten::copy_" not in ops_fused
              and ops_cat.get("aten::cat") == 4,
              f"the F step's aten ops {ops_fused}, before the fold {ops_cat}")
        # the chaos floor: native f64 from the carry rounded to two-float
        cq, _ = run(plain_step, ms.elm2_f_to(ms.elm2_f_from(carry0)), FLAGSHIP_STEPS)

        yf_early = yf_early[0].to(f64) + yf_early[1].to(f64)
        early = (yf_early - yp_early).abs().max().item() / yp_early.abs().max().item()
        yf = cf.ys.hi[0].to(f64) + cf.ys.lo[0].to(f64)
        d_fused = (yf - cp.ys[0]).norm(dim=1)
        d_floor = (cq.ys[0] - cp.ys[0]).norm(dim=1)
        shadow = (d_fused.median() / d_floor.median()).item()
        ymax = cp.ys[0].abs().max().item()
        check(bool(torch.isfinite(yf).all() and torch.isfinite(cf.dy).all()),
              "flagship state non-finite")
        check(early <= EARLY_BOUND, f"flagship fused vs plain after {EARLY_STEPS} steps: {early}")
        check(shadow <= SHADOW_FACTOR, f"flagship fused run does not shadow f64: {shadow}")
        print(json.dumps({
            "phase": 5, "n": N_BODIES, "steps": FLAGSHIP_STEPS, "h_s": H,
            f"rel_pos_diff_after_{EARLY_STEPS}": early, "early_bound": EARLY_BOUND,
            f"rel_pos_diff_after_{FLAGSHIP_STEPS}": d_fused.max().item() / ymax,
            f"f64_chaos_floor_after_{FLAGSHIP_STEPS}": d_floor.max().item() / ymax,
            "median_divergence_vs_floor": shadow, "shadow_bound": SHADOW_FACTOR,
            "fused_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_fused,
            "plain_f64_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_plain,
            "launches": {k: v for k, v in launches.items() if v},
            "kernel_launches_per_step": sum(launches.values()) / FLAGSHIP_STEPS,
            "aten_ops_per_step": {"fused": ops_fused, "before_fold": ops_cat},
            "before_fold": {"body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_cat,
                            "launches": {k: v for k, v in launches_cat.items() if v},
                            "bitwise_to_fused": fold_bitwise},
            "card": smi,
        }))
        # the F step is kernel 1's and kernel 2's shift entry's live path
        # (generation's fused branch, phase 6, runs only with its gate patched
        # on); the step before the fold, kernel 2's update entry's
        for k in ("accel_df64", "elm2f_update_shift"):
            record.setdefault(k, {})["launches"] = launches[k]
        record.setdefault("elm2f_update", {})["launches"] = launches_cat["elm2f_update"]

    # -- phase 6: generation at N=4096, native f64 and the fused branch ---------
    if 6 in phases:
        epoch = port.Epoch.parse("2000-01-01 12:00:00")
        names = [f"b{i:04d}" for i in range(N_BODIES)]
        state = scene.SolarSystemState(
            name="cluster4096", epoch=epoch,
            bodies=[scene.Body(n, float(m), p, v) for n, m, p, v in zip(names, mu, pos, vel)],
        )
        settings = scene.EphemeridesSettings(
            dt=port.Duration(H),
            settings={n: scene.InterpolationParameters(degree=8, count=4) for n in names},
        )
        span = port.Duration(GEN_STEPS * H)

        def generate():
            e = eph.generate_ephemeris(state, settings, span, chunk_steps=GEN_CHUNK, device=dev)
            torch.cuda.synchronize()
            return e

        # "f64" generation keeps native f64 at N=4096 (F1): the fused
        # two-float branch runs only with its gate patched on
        check(not eph._use_fused_f(N_BODIES, dev), "the fused gate is on by default (F1)")
        fused_gate = eph._use_fused_f
        eph._use_fused_f = lambda n, d: True
        try:
            reset_counts()
            t0 = time.perf_counter()
            e_fused = generate()
            t_fused = time.perf_counter() - t0
            launches = read_counts()
        finally:
            eph._use_fused_f = fused_gate
        # the fused branch's force is native f64 on hi + lo (F3): kernel 2's
        # shift entry a step, no kernel 1
        check(launches["accel_df64"] == 0 and launches["elm2f_update_shift"] > 0,
              f"the fused branch launched kernel 1 or no kernel 2 (F3): {launches}")

        reset_counts()
        t0 = time.perf_counter()
        e_plain = generate()
        t_plain = time.perf_counter() - t0
        launches_plain = read_counts()
        check(not any(launches_plain.values()),
              f"default f64 generation at N=4096 launched kernels (F1): {launches_plain}")

        cf = {n: e_fused[n].coeffs for n in names}
        cp = {n: e_plain[n].coeffs for n in names}
        # the first segment (32 steps) is compared tightly; later segments
        # only for the record, the cluster being chaotic (see EARLY_BOUND)
        err = _coeff_err({n: c[:1] for n, c in cp.items()}, {n: c[:1] for n, c in cf.items()},
                         settings)
        check(all(np.isfinite(c).all() for c in cf.values()), "fused coefficients not finite")
        t_mid = epoch.as_offset_seconds() + 0.5 * span.as_seconds()
        p_mid = e_fused.positions(t_mid)
        check(p_mid is not None and np.isfinite(p_mid).all(), "Ephemeris.positions not finite")
        check(err <= EARLY_BOUND, f"generation fused vs plain, first segment: {err}")
        print(json.dumps({
            "phase": 6, "n": N_BODIES, "steps": GEN_STEPS, "chunk_steps": GEN_CHUNK,
            "segments_per_body": int(cf[names[0]].shape[0]), "launches": launches,
            "default_route_launches": launches_plain,
            "first_segment_coeff_err": err, "bound": EARLY_BOUND,
            "all_segments_coeff_err": _coeff_err(cp, cf, settings),
            "fused_body_steps_per_s": N_BODIES * GEN_STEPS / t_fused,
            "plain_f64_body_steps_per_s": N_BODIES * GEN_STEPS / t_plain, "card": smi,
        }))

    # -- phase 7: full_solar_system, one year, through kernel 11-f64 ------------
    fss_year = {}  # phase 7's eager native-f64 year, which path F compares with
    if 7 in phases:
        t_phase = time.perf_counter()
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        year = port.Duration.from_days(365.25)
        h = fss.settings.dt.as_seconds()

        def generate_year():
            t0 = time.perf_counter()
            e = eph.generate_ephemeris(fss.state, fss.settings, year, device=dev)
            torch.cuda.synchronize()
            return e, time.perf_counter() - t0

        eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(2), device=dev)
        torch.cuda.synchronize()
        # generate_ephemeris's chunks: CHUNK_STEPS each, the tail bucketed into one
        n_chunks = -(-round(year.as_seconds() / h) // eph.CHUNK_STEPS)
        reset_counts()
        e_gpu, t_year = generate_year()
        launches_y = read_counts()
        check(launches_y["gen_scan_f64"] == n_chunks and sum(launches_y.values()) == n_chunks,
              f"phase 7: launches {launches_y}, expected one of kernel 11-f64 per chunk "
              f"({n_chunks})")
        # the eager native-f64 step loop beside it, kernel 11-f64's gate patched off
        gate = eph._use_gen_kernel_f64
        eph._use_gen_kernel_f64 = lambda n, d: False
        try:
            reset_counts()
            e_eager, t_eager = generate_year()
            launches_e = read_counts()
        finally:
            eph._use_gen_kernel_f64 = gate
        check(not any(launches_e.values()), f"phase 7 eager route launched kernels: {launches_e}")
        fss_year["f64"] = e_eager
        e_cpu = eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(30),
                                       device="cpu")
        c_cpu = {n: e_cpu[n].coeffs for n in e_cpu.names}
        c_gpu = {n: e_gpu[n].coeffs[: c_cpu[n].shape[0]] for n in e_cpu.names}
        c_eager = {n: e_eager[n].coeffs[: c_cpu[n].shape[0]] for n in e_cpu.names}
        err = _coeff_err(c_cpu, c_gpu, fss.settings)
        err_eager = _coeff_err(c_cpu, c_eager, fss.settings)
        t_end = e_gpu.end.as_offset_seconds()
        check(np.isfinite(e_gpu.positions(t_end)).all(), "full_solar_system positions not finite")
        check(err <= FSS_BOUND, f"full_solar_system CUDA vs CPU: {err}")

        # order-only differences after the first chunk: from one startup carry
        # (made on the CPU), kernel 11-f64 and the eager CUDA loop against the
        # CPU's eager loop, all three native f64
        cpu = torch.device("cpu")
        mu_c = torch.as_tensor(fss.state.mus(), dtype=f64)
        mu_g = mu_c.to(dev)
        t_s, dy_s, ys_fwd, dd_fwd = ms.elm2_startup_scan(
            tab, lambda t, y: nbody.pairwise_accel(y, mu_c), 0.0,
            torch.as_tensor(fss.state.positions(), dtype=f64),
            torch.as_tensor(fss.state.velocities(), dtype=f64), h)
        c_c = ms.ELM2Carry(t=t_s, ys=ys_fwd.flip(0), ddys=dd_fwd.flip(0), dy=dy_s)
        c_g = ms.ELM2Carry(t=t_s, ys=c_c.ys.to(dev), ddys=c_c.ddys.to(dev), dy=dy_s.to(dev))
        steps = eph.CHUNK_STEPS
        _, c_k = cuda_gen.elm2_gen_scan_f64(tab, h, c_g, mu_g, steps)
        for _ in range(steps):
            c_g = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_g), h, c_g,
                               with_velocity=False)
            c_c = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_c), h, c_c,
                               with_velocity=False)
        y_cpu = c_c.ys[0]
        d_k, d_e = c_k.ys[0].to(cpu) - y_cpu, c_g.ys[0].to(cpu) - y_cpu
        km_k, km_e = d_k.norm(dim=1).max().item(), d_e.norm(dim=1).max().item()
        env = max(GEN_ENVELOPE * km_e, GEN_FLOOR * y_cpu.abs().max().item())
        check(km_k <= env, f"phase 7 after {steps} steps: kernel 11-f64 {km_k} km from the CPU, "
                           f"> {env} km (eager CUDA {km_e} km)")

        # backward generation through kernel 11-f64 (h < 0), one launch a
        # chunk, against the CPU's eager loop in sample space (the backward
        # fit matrices) at the forward year's bar
        back = port.Duration.from_days(BACK_DAYS)
        n_chunks_b = -(-round(back.as_seconds() / h) // eph.CHUNK_STEPS)
        reset_counts()
        t0 = time.perf_counter()
        e_back = eph.generate_ephemeris(fss.state, fss.settings, back, direction=-1, device=dev)
        torch.cuda.synchronize()
        t_back = time.perf_counter() - t0
        launches_b = read_counts()
        check(launches_b["gen_scan_f64"] == n_chunks_b and sum(launches_b.values()) == n_chunks_b,
              f"phase 7 backward: launches {launches_b}, expected one of kernel 11-f64 per chunk "
              f"({n_chunks_b})")
        e_back_cpu = eph.generate_ephemeris(fss.state, fss.settings, back, direction=-1,
                                            device="cpu")
        check(all(e_back[n].start_s == e_back_cpu[n].start_s for n in e_back.names),
              "phase 7 backward: the card's and the CPU's segments start apart")
        err_b = _coeff_err({n: e_back_cpu[n].coeffs for n in e_back.names},
                           {n: e_back[n].coeffs for n in e_back.names}, fss.settings,
                           backward=True)
        check(err_b <= FSS_BOUND, f"phase 7 backward, CUDA vs CPU: {err_b} > {FSS_BOUND}")
        record.setdefault("gen_scan_f64", {})["launches"] = launches_y["gen_scan_f64"]
        record["gen_scan_f64"].setdefault("launches_by_phase", {}).update(
            {"7": launches_y["gen_scan_f64"], "7_backward": launches_b["gen_scan_f64"]})
        print(json.dumps({
            "phase": 7, "scene": "full_solar_system_2433282.5", "n": fss.state.n,
            "sim_days": 365.25, "chunks": n_chunks, "launches": launches_y,
            "launches_per_chunk": launches_y["gen_scan_f64"] / n_chunks,
            "sim_days_per_s": 365.25 / t_year, "generation_s": t_year,
            "eager_sim_days_per_s": 365.25 / t_eager, "eager_generation_s": t_eager,
            "coeff_err_vs_cpu_30d": err, "raw_coeff_err_vs_cpu_30d": _raw_coeff_err(c_cpu, c_gpu),
            "eager_coeff_err_vs_cpu_30d": err_eager, "bound": FSS_BOUND,
            f"km_vs_cpu_after_{steps}": km_k, f"eager_km_vs_cpu_after_{steps}": km_e,
            "ratio_to_eager": km_k / km_e if km_e else None, "envelope_km": env,
            "worst_bodies_km": _worst_bodies(d_k, fss),
            "eager_worst_bodies_km": _worst_bodies(d_e, fss),
            "backward": {"sim_days": BACK_DAYS, "chunks": n_chunks_b, "launches": launches_b,
                         "generation_s": t_back, "coeff_err_vs_cpu": err_b, "bound": FSS_BOUND},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- the expansion-state engine (kernels 3 and 4) ------------------------
    fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")

    def limb_forces(mu64):
        """(accel_limbs, accel_pair) through kernel 3 for (1, N) f64 mu."""
        mh, ml = cuda_nbody.split_f64(mu64.reshape(1, -1))

        def accel_pair(t, limbs):
            return cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)

        def accel_limbs(t, limbs):
            return cuda_nbody.combine_f64(*accel_pair(t, limbs))

        return accel_limbs, accel_pair

    def exp_head(ys):
        return ex.to_f64(tuple(l[0] for l in ys))

    def exp_diff(ys, ref):
        """max |head(ys) - head(ref)| / max |head(ref)| on the full 4-limb
        ring heads (below f64 rounding)."""
        a, b = tuple(l[0] for l in ys), tuple(l[0] for l in ref)
        return (ex.to_f64(ex.add(a, ex.neg(b))).abs().max() / ex.to_f64(b).abs().max()).item()

    # -- phase 8: kernel 3 against its plain version --------------------------
    if 8 in phases:
        t_phase = time.perf_counter()
        cases = [("cluster4096", *_cluster(N_BODIES)[::2]),
                 ("ragged1000", *_cluster(1000, seed=1)[::2]),
                 ("full_solar_system", fss.state.positions(), fss.state.mus())]
        out = []
        for name, p, m in cases:
            limbs = ex.from_f64_host(p, dev)[:3]
            m_dev = torch.as_tensor(m, dtype=f64, device=dev)
            mh, ml = cuda_nbody.split_f64(m_dev.reshape(1, -1))
            raw = cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)
            k = cuda_nbody.combine_f64(*raw)
            r = cuda_nbody.combine_f64(*cuda_limbs.pairwise_accel_limbs_pair_plain(*limbs, mh, ml))
            ref = nbody.pairwise_accel(torch.as_tensor(p, dtype=f64, device=dev), m_dev)
            torch.cuda.synchronize()
            abs_err = (k - r).abs().max().item()
            e_plain = abs_err / r.abs().max().item()
            e_f64 = (k - ref).abs().max().item() / ref.abs().max().item()
            check(bool(torch.isfinite(k).all()), f"kernel 3 non-finite on {name}")
            check(e_plain <= KERNEL3_VS_PLAIN, f"kernel 3 vs plain on {name}: {e_plain}")
            check(e_f64 <= KERNEL3_VS_F64, f"kernel 3 vs f64 on {name}: {e_f64}")
            kms = cuda_ms(lambda: cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml), 20)
            pms = cuda_ms(lambda: cuda_limbs.pairwise_accel_limbs_pair_plain(*limbs, mh, ml), 3, 1)
            gms = graph_ms(lambda: cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml), 20)
            out.append({"input": name, "n": len(p), "rel_err_vs_plain": e_plain,
                        "rel_err_vs_f64": e_f64, "f64_bound": KERNEL3_VS_F64,
                        "kernel_us": kms * 1e3, "kernel_device_us": gms * 1e3,
                        "plain_us": pms * 1e3})
            if name == "cluster4096":
                b = bound_of(lambda: cuda_limbs.pairwise_accel_limbs_pair_plain(*limbs, mh, ml),
                             [*limbs, mh, ml, *raw])
                out[-1]["bound"] = b
                record["accel_limbs3"] = kernel_record(abs_err, kms, pms, b)
        print(json.dumps({"phase": 8, "kernel": "accel_limbs3", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # expansion-state startups (kernel 3 for every force), shared by 9, 10,
    # 22 and 28
    if phases & {9, 10, 22, 28}:
        cl_limbs, cl_pair = limb_forces(mu_dev)

        def kernel1_accel(t, y):
            return cuda_nbody.pairwise_accel(y, mu_hi, mu_lo)

        def init_cluster():
            """bench.py:bench_parity's startup: elm2_init_q with the kernel-1
            drop-in as `accel` and kernel 3 as `accel_limbs` (which then
            carries every startup force)."""
            return ms.elm2_init_q(tab, kernel1_accel, 0.0,
                                  torch.as_tensor(pos, dtype=f64, device=dev),
                                  torch.as_tensor(vel, dtype=f64, device=dev), H,
                                  accel_limbs=cl_limbs)

    # -- phase 9: kernel 4 against its plain version --------------------------
    if 9 in phases:
        t_phase = time.perf_counter()
        fss_mu = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        fss_q = ms.elm2_init_q(tab, None, 0.0, None,
                               torch.as_tensor(fss.state.velocities(), dtype=f64, device=dev),
                               H, accel_limbs=limb_forces(fss_mu)[0],
                               y0_limbs=ex.from_f64_host(fss.state.positions(), dev))
        out = []
        for name, c in (("cluster4096", ms.elm2_qf_from_q(init_cluster())),
                        ("full_solar_system", ms.elm2_qf_from_q(fss_q))):
            for precise in (False, True):
                tables = cuda_elm2q._tables(tab, H, precise)
                yk = cuda_elm2q.elm2q_update(tab, H, c.ys, c.dd, precise=precise)
                yp = cuda_elm2q.elm2q_update_plain(*tables, c.ys, c.dd, precise)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(yk, yp))
                diff = sum(a.to(f64) - b.to(f64) for a, b in zip(yk, yp)).abs().max().item()
                ymax = exp_head(c.ys).abs().max().item()
                check(bool(all(torch.isfinite(a).all() for a in yk)), f"kernel 4 non-finite on {name}")
                check(bitwise, f"kernel 4 vs plain on {name} (precise={precise}): not bitwise, "
                               f"max|d| = {diff}, {diff / ymax} of max|y|")
                kms = cuda_ms(lambda: cuda_elm2q.elm2q_update(tab, H, c.ys, c.dd, precise=precise),
                              200)
                pms = cuda_ms(lambda: cuda_elm2q.elm2q_update_plain(*tables, c.ys, c.dd, precise),
                              5, 1)
                gms = graph_ms(lambda: cuda_elm2q.elm2q_update(tab, H, c.ys, c.dd, precise=precise),
                               200)
                m = c.ys[0][0].numel()
                out.append({"input": name, "m": m, "precise": precise,
                            "bitwise": bitwise, "max_abs_err": diff,
                            "kernel_us": kms * 1e3, "kernel_device_us": gms * 1e3,
                            "plain_us": pms * 1e3})
                if name == "cluster4096" and precise:
                    b = bound_of(lambda: cuda_elm2q.elm2q_update_plain(*tables, c.ys, c.dd, precise),
                                 [*c.ys, *c.dd, *yk])
                    out[-1]["bound"] = b
                    out[-1]["bound_share"] = b["bound_ms"] * 1e3 / out[-1]["kernel_device_us"]
                    record["elm2q_update"] = kernel_record(diff, kms, pms, b)
        # ragged M (3, 99, 4095: no multiple of a block's 32 elements) and another
        # tableau (Stormer13: order 13, two c_y rows), both modes, bitwise
        rng = np.random.default_rng(4)
        ragged = []
        for tab_name, n in (("QuinlanTremaine12", 1), ("QuinlanTremaine12", 33),
                            ("QuinlanTremaine12", 1365), ("Stormer13", N_BODIES)):
            t_ = get(tab_name)
            order = len(t_.c_y)
            ys = ex.from_f64_host(rng.normal(size=(order, n, 3)) * 1e8, dev)
            dd = TwoFloat(*cuda_nbody.split_f64(torch.as_tensor(
                rng.normal(size=(order, n, 3)) * 1e-6, device=dev)))
            for precise in (False, True):
                yk = cuda_elm2q.elm2q_update(t_, H, ys, dd, precise=precise)
                yp = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(t_, H, precise), ys, dd,
                                                   precise)
                check(all(torch.equal(a, b) for a, b in zip(yk, yp)),
                      f"kernel 4 vs plain on {tab_name} at M = {3 * n} (precise={precise}): "
                      f"not bitwise")
                ragged.append({"tableau": tab_name, "m": 3 * n, "precise": precise,
                               "bitwise": True})
        print(json.dumps({"phase": 9, "kernel": "elm2q_update", "cases": out,
                          "ragged_and_stormer13": ragged,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 10: path B, the N=4096 parity step through kernels 4 and 3 ------
    if 10 in phases:
        t_phase = time.perf_counter()

        def fused_step(c):
            return ms.elm2_step_qf(tab, cl_pair, H, c, precise_sums=True)

        def unfused_step(c):
            return ms.elm2_step_q(tab, None, H, c, accel_limbs=cl_limbs, with_velocity=False,
                                  precise_sums=True)

        def plain_mode_step(c):
            return ms.elm2_step_qf(tab, cl_pair, H, c, precise_sums=False)

        def run(step, c, steps):
            """`steps` steps; also returns the carry after EARLY_STEPS."""
            early = None
            for i in range(steps):
                c = step(c)
                if i + 1 == EARLY_STEPS:
                    early = c
            return c, early

        warm = init_cluster()
        run(fused_step, ms.elm2_qf_from_q(warm), 2), run(unfused_step, warm, 2)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        q0 = init_cluster()
        cf, yf_early = run(fused_step, ms.elm2_qf_from_q(q0), FLAGSHIP_STEPS)
        vf = ms.elm2_velocity_qf(tab, cf, H)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
        launches_b = read_counts()
        check(launches_b["accel_limbs3"] > 0 and launches_b["elm2q_update"] > 0,
              f"path B did not launch kernels 3 and 4: {launches_b}")
        check(launches_b["elm2q_update"] == FLAGSHIP_STEPS, f"kernel 4 once per step: {launches_b}")

        qf0 = ms.elm2_qf_from_q(q0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(fused_step, qf0, FLAGSHIP_STEPS)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        t0 = time.perf_counter()
        cu, yu_early = run(unfused_step, q0, FLAGSHIP_STEPS)
        torch.cuda.synchronize()
        t_unfused = time.perf_counter() - t0
        # the chaos floor: the unfused run from the position ring rounded to f64
        cq, _ = run(unfused_step, q0._replace(ys=ex.from_f64(ex.to_f64(q0.ys))), FLAGSHIP_STEPS)

        y1u = unfused_step(q0).ys
        one = exp_diff(fused_step(qf0).ys, y1u)
        early = exp_diff(yf_early.ys, yu_early.ys)
        # what the two bounds must see: kernel 4 in its two-float mode
        one_pm = exp_diff(plain_mode_step(qf0).ys, y1u)
        early_pm = exp_diff(run(plain_mode_step, qf0, EARLY_STEPS)[1].ys, yu_early.ys)
        # the fused step at depth: kernel 4's plain version, then kernel 3
        deep = fused_step(yf_early)
        y_plain = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(tab, H, True), yf_early.ys,
                                                yf_early.dd, True)
        f_plain = cl_pair(deep.t, y_plain[:3])
        composed = (all(torch.equal(a[0], b) for a, b in zip(deep.ys, y_plain))
                    and torch.equal(deep.dd.hi[0], f_plain[0])
                    and torch.equal(deep.dd.lo[0], f_plain[1]))
        yf, yu, yq = exp_head(cf.ys), exp_head(cu.ys), exp_head(cq.ys)
        d_fused = (yf - yu).norm(dim=1)
        d_floor = (yq - yu).norm(dim=1)
        shadow = (d_fused.median() / d_floor.median()).item()
        ymax = yu.abs().max().item()
        check(bool(torch.isfinite(yf).all() and torch.isfinite(vf).all()), "path B state non-finite")
        check(one <= QF_STEP_BOUND, f"path B fused vs unfused step: {one}")
        check(early <= QF_EARLY_BOUND, f"path B fused vs unfused after {EARLY_STEPS} steps: {early}")
        check(one_pm > QF_STEP_BOUND and early_pm > QF_EARLY_BOUND,
              f"path B's bounds cannot tell kernel 4's plain mode: {one_pm}, {early_pm}")
        check(composed, f"path B step {EARLY_STEPS + 1} is not kernel 4's plain version + kernel 3")
        check(shadow <= SHADOW_FACTOR, f"path B fused run does not shadow the unfused: {shadow}")
        print(json.dumps({
            "phase": 10, "path": "B", "n": N_BODIES, "steps": FLAGSHIP_STEPS, "h_s": H,
            "launches": launches_b, "path_s": t_path,
            "rel_exp_diff_one_step": one, "one_step_bound": QF_STEP_BOUND,
            f"rel_exp_diff_after_{EARLY_STEPS}": early, "early_bound": QF_EARLY_BOUND,
            "plain_mode_rel_exp_diff_one_step": one_pm,
            f"plain_mode_rel_exp_diff_after_{EARLY_STEPS}": early_pm,
            f"step_{EARLY_STEPS + 1}_bitwise_to_plain_update": composed,
            f"rel_pos_diff_after_{FLAGSHIP_STEPS}": d_fused.max().item() / ymax,
            f"f64_rounded_start_floor_after_{FLAGSHIP_STEPS}": d_floor.max().item() / ymax,
            "median_divergence_vs_floor": shadow, "shadow_bound": SHADOW_FACTOR,
            "fused_qf_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_fused,
            "unfused_q_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_unfused,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))
        for k in ("accel_limbs3", "elm2q_update"):
            record.setdefault(k, {})["launches"] = launches_b[k]

    # -- phase 11: path A, "extended3" generation of full_solar_system --------
    if 11 in phases:
        t_phase = time.perf_counter()
        span = port.Duration.from_days(EXT_DAYS)

        def generate(precision, device):
            e = eph.generate_ephemeris(fss.state, fss.settings, span, precision=precision,
                                       device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return e

        eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(1),
                               precision="extended3", device=dev)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        e_gpu = generate("extended3", dev)
        t_gpu = time.perf_counter() - t0
        launches_a = read_counts()
        check(launches_a["accel_limbs3"] > 0 and launches_a["elm2q_update"] == 0,
              f"path A must run kernel 3 and not kernel 4: {launches_a}")
        t0 = time.perf_counter()
        e_cpu = generate("extended3", torch.device("cpu"))
        t_cpu = time.perf_counter() - t0
        c_cpu = {n: e_cpu[n].coeffs for n in e_cpu.names}
        c_gpu = {n: e_gpu[n].coeffs for n in e_gpu.names}
        err = _coeff_err(c_cpu, c_gpu, fss.settings)
        # the integrated positions after the span, "extended3" against "f64"
        n_steps = int(round(span.as_seconds() / fss.settings.dt.as_seconds()))
        heads = {}
        for precision in ("extended3", "extended", "f64"):
            prop = eph.NBodyPropagator(fss.state, fss.settings, precision=precision, device=dev)
            prop.step_chunk(n_steps)
            c = prop._carry.ms
            heads[precision] = c.ys[0] if precision == "f64" else exp_head(c.ys)
        # "f64" above ran kernel 11-f64; the eager native-f64 loop beside it
        gate = eph._use_gen_kernel_f64
        eph._use_gen_kernel_f64 = lambda n, d: False
        try:
            prop = eph.NBodyPropagator(fss.state, fss.settings, precision="f64", device=dev)
            prop.step_chunk(n_steps)
            heads["f64_eager"] = prop._carry.ms.ys[0]
        finally:
            eph._use_gen_kernel_f64 = gate
        d_ext = (heads["extended3"] - heads["extended"]).abs().max().item()
        d_km = (heads["extended3"] - heads["f64"]).abs().max().item()
        d_km_eager = (heads["extended3"] - heads["f64_eager"]).abs().max().item()
        fitted = [n for n in e_gpu.names if e_gpu[n].segment_count]
        for n in fitted:
            b = e_gpu[n]
            check(np.isfinite(b.position(b.end_s)).all(), f"path A position of {n} not finite")
        check(bool(torch.isfinite(heads["extended3"]).all()), "path A state not finite")
        check(err <= FSS_BOUND, f"path A CUDA vs CPU: {err}")
        check(d_ext < EXT3_VS_EXT_KM, f"path A extended3 vs extended: {d_ext} km")
        check(d_km < EXT3_VS_F64_KM, f"path A extended3 vs f64: {d_km} km")
        print(json.dumps({
            "phase": 11, "path": "A", "scene": "full_solar_system_2433282.5",
            "precision": "extended3", "n": fss.state.n, "sim_days": EXT_DAYS,
            "bodies_fitted": len(fitted), "launches": launches_a,
            "sim_days_per_s": EXT_DAYS / t_gpu,
            "cpu_sim_days_per_s": EXT_DAYS / t_cpu, "coeff_err_vs_cpu": err,
            "bound": FSS_BOUND, "max_km_vs_extended": d_ext, "extended_km_bound": EXT3_VS_EXT_KM,
            "max_km_vs_f64": d_km, "f64_km_bound": EXT3_VS_F64_KM,
            "max_km_vs_f64_eager": d_km_eager,
            "f64_worst_bodies_km": _worst_bodies(heads["f64"] - heads["extended3"], fss),
            "f64_eager_worst_bodies_km": _worst_bodies(heads["f64_eager"] - heads["extended3"], fss),
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- the force-mode ladder (kernels 5-8) ----------------------------------
    def hierarchy(n=16, seed=7):
        """tests/test_pallas_nbody.py:_hierarchy: a sun, 3 planets with close
        moon pairs, light far bodies."""
        rng = np.random.default_rng(seed)
        au = 1.5e11
        p, m = [np.zeros(3)], [1.33e20]
        for i in range(3):
            pp = rng.normal(size=3)
            pp = pp / np.linalg.norm(pp) * au * (0.7 + i)
            p.append(pp)
            m.append(3e14 * (i + 1))
            for j in range(2):
                off = rng.normal(size=3)
                off = off / np.linalg.norm(off) * 4e8 * (1 + 0.002 * j)
                p.append(pp + off)
                m.append(5e12)
        while len(p) < n:
            p.append(rng.normal(size=3) * au * 2)
            m.append(1e10)
        return np.array(p), np.array(m)

    def close_pair():
        """test_mixed_mode_error_envelope's input (a Phobos-Mars-like pair)."""
        rng = np.random.default_rng(29)
        p = rng.normal(size=(16, 3)) * 1.0e6
        p[1] = p[0] + np.array([40.1234567, 19.7654321, -9.87654321])
        m = rng.uniform(1.0e3, 1.0e5, size=16)
        m[0] = 1.0e7
        return p, m

    def seeded_cloud(n, seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(n, 3)) * 1e6, rng.uniform(1e3, 1e5, size=n)

    ladder_cases = [("cluster32", *_cluster(32)[::2]), ("ragged1000", *_cluster(1000, seed=1)[::2]),
                    ("cluster4096", *_cluster(N_BODIES)[::2]), ("hierarchy", *hierarchy())]

    def dev64(p, m):
        return torch.as_tensor(p, dtype=f64, device=dev), torch.as_tensor(m, dtype=f64, device=dev)

    def f32_in(p, m):
        tp, tm = dev64(p, m)
        return tp.float(), tm.float().reshape(1, -1)

    def rel_rows(a, ref):
        return ((a.double() - ref).norm(dim=1) / ref.norm(dim=1)).max().item()

    def against_plain(name, kernel, plain, bound, inputs, combine=None):
        """Kernel vs plain on one input: checks the bound, times both; on
        cluster4096 also the least time the card could take."""
        k, r = kernel(), plain()
        outputs = list(k) if combine is not None else [k]
        if combine is not None:
            k, r = combine(*k), combine(*r)
        torch.cuda.synchronize()
        abs_err = (k - r).abs().max().item()
        scale = r.abs().max().item()
        check(bool(torch.isfinite(k).all()), f"{name}: kernel output not finite")
        check(abs_err <= bound * scale, f"{name}: kernel vs plain {abs_err / scale} > {bound}")
        case = {"input": name, "rel_err_vs_plain": abs_err / scale, "max_abs_err": abs_err,
                "bitwise": bool(torch.equal(k, r)), "kernel_us": cuda_ms(kernel, 20) * 1e3,
                "kernel_device_us": graph_ms(kernel, 20) * 1e3,
                "plain_us": cuda_ms(plain, 3, 1) * 1e3}
        if name == "cluster4096":
            case["bound"] = bound_of(plain, [*inputs, *outputs])
        return case

    def keep(kernel_name, case):
        if case["input"] == "cluster4096":
            record[kernel_name] = kernel_record(case["max_abs_err"], case["kernel_us"] / 1e3,
                                                case["plain_us"] / 1e3, case["bound"])

    def deterministic(name, kernel, case):
        """Two more calls of a redesigned kernel equal each other bitwise;
        on cluster4096 also its device time's share of its bound."""
        a, b = kernel(), kernel()
        check(torch.equal(a, b), f"{name}: two calls differ")
        case["two_calls_bitwise"] = True
        if "bound" in case:
            case["bound_share"] = case["bound"]["bound_ms"] * 1e3 / case["kernel_device_us"]

    # -- phase 12: kernel 5 against its plain version --------------------------
    if 12 in phases:
        t_phase = time.perf_counter()
        out = []
        for name, p, m in ladder_cases:
            p32, m32 = f32_in(p, m)
            out.append(against_plain(name, lambda: cuda_f32.pairwise_accel_f32(p32, m32),
                                     lambda: cuda_f32.pairwise_accel_f32_plain(p32, m32),
                                     F32_VS_PLAIN, [p32, m32]))
            deterministic(name, lambda: cuda_f32.pairwise_accel_f32(p32, m32), out[-1])
            keep("accel_f32", out[-1])
        # test_f32_fast_mode_error_envelope's bar: within 1e-5 of kernel 1
        p, m = seeded_cloud(64, 21)
        tp, tm = dev64(p, m)
        mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
        env = (cuda_f32.pairwise_accel_f32(*f32_in(p, m)).double()
               - cuda_nbody.pairwise_accel(tp, mh, ml))
        env = (env.abs().max() / cuda_nbody.pairwise_accel(tp, mh, ml).abs().max()).item()
        check(1e-9 < env < 1e-5, f"kernel 5 vs kernel 1 on the 64-body cloud: {env}")
        print(json.dumps({"phase": 12, "kernel": "accel_f32", "cases": out,
                          "envelope_vs_kernel1": env, "envelope_bar": 1e-5,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 13: kernel 6 against its plain version --------------------------
    if 13 in phases:
        t_phase = time.perf_counter()
        out = []
        for name, p, m in ladder_cases + [("close_pair", *close_pair())]:
            tp, tm = dev64(p, m)
            ph, pl = cuda_nbody.split_f64(tp, transpose=True)
            m32 = tm.float().reshape(1, -1)
            out.append(against_plain(name, lambda: cuda_mixed.pairwise_accel_mixed(ph, pl, m32),
                                     lambda: cuda_mixed.pairwise_accel_mixed_plain(ph, pl, m32),
                                     F32_VS_PLAIN, [ph, pl, m32]))
            deterministic(name, lambda: cuda_mixed.pairwise_accel_mixed(ph, pl, m32), out[-1])
            keep("accel_mixed", out[-1])
        # test_mixed_mode_error_envelope's bars, per body against kernel 1
        p, m = close_pair()
        tp, tm = dev64(p, m)
        mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
        ref = cuda_nbody.pairwise_accel(tp, mh, ml)
        ph, pl = cuda_nbody.split_f64(tp, transpose=True)
        mixed = cuda_mixed.pairwise_accel_mixed(ph, pl, tm.float().reshape(1, -1)).double()
        fast = cuda_f32.pairwise_accel_f32(*f32_in(p, m)).double()
        rel_m = ((mixed - ref).norm(dim=1) / ref.norm(dim=1))
        rel_f = ((fast - ref).norm(dim=1) / ref.norm(dim=1))
        check(1e-9 < rel_m.max().item() < 3e-6, f"mixed close pair per body: {rel_m.max().item()}")
        check(rel_f[1].item() > 30 * rel_m[1].item(), "the close pair does not hurt kernel 5")
        print(json.dumps({"phase": 13, "kernel": "accel_mixed", "cases": out,
                          "close_pair_max_rel": rel_m.max().item(), "close_pair_bar": 3e-6,
                          "close_pair_f32_over_mixed": rel_f[1].item() / rel_m[1].item(),
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 14: kernel 7 against its plain version ----------------------------
    if 14 in phases:
        t_phase = time.perf_counter()
        out = []
        for name, p, m in ladder_cases:
            tp, tm = dev64(p, m)
            n = len(p)
            idx = split.strong_pair_indices(tp, tm, k=6 if name == "hierarchy" else STRONG_K)
            mask = split.strong_pair_mask(idx, n)
            no_diag = mask.clone()
            no_diag.fill_diagonal_(0)
            p32, m32 = f32_in(p, m)
            for mk, diag in ((no_diag, False), (mask, True)):
                case = against_plain(
                    name, lambda: cuda_f32.pairwise_accel_f32_masked(p32, m32, mk, diag),
                    lambda: cuda_f32.pairwise_accel_f32_masked_plain(p32, m32, mk, diag_in_mask=diag),
                    F32_VS_PLAIN, [p32, m32, mk])
                case["diag_in_mask"] = diag
                deterministic(name, lambda: cuda_f32.pairwise_accel_f32_masked(p32, m32, mk, diag),
                              case)
                out.append(case)
            keep("accel_f32_masked", case)
            # the rows form against the square form's row slices, bitwise
            sq = cuda_f32.pairwise_accel_f32_masked(p32, m32, mask, diag_in_mask=True)
            for r0 in range(0, n, max(1, n // 4) + 1):
                nl = min(n - r0, max(1, n // 4) + 1)
                rows = cuda_f32.pairwise_accel_f32_masked_rows(
                    p32, m32, mask[r0:r0 + nl].contiguous(), p32[r0:r0 + nl].contiguous())
                check(torch.equal(rows, sq[r0:r0 + nl]),
                      f"kernel 7 rows form at {r0}:{r0 + nl} of {name} is not the square's slice")
            case["rows_form_bitwise"] = True
        print(json.dumps({"phase": 14, "kernel": "accel_f32_masked", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 15: kernel 8 against its plain version, and the split mode's bars --
    if 15 in phases:
        t_phase = time.perf_counter()
        out = []
        cases = [(c[0], c[1], c[2], 6 if c[0] == "hierarchy" else STRONG_K) for c in ladder_cases]
        cases += [("cloud64_k40", *seeded_cloud(64, 14), 40),
                  ("cloud200_k128", *seeded_cloud(200, 14), 128)]
        for name, p, m, k in cases:
            tp, tm = dev64(p, m)
            n = len(p)
            idx = split.strong_pair_indices(tp, tm, k=k)
            ph, pl = cuda_nbody.split_f64(tp)
            mh, ml = cuda_nbody.split_f64(tm)
            args = (ph, pl, ph, pl, mh, ml, idx)
            case = against_plain(name, lambda: cuda_split.strong_correction_pair(*args),
                                 lambda: cuda_split.strong_correction_pair_plain(*args),
                                 STRONG_VS_PLAIN, args, combine=cuda_nbody.combine_f64)
            case["k"] = k
            kh, kl = cuda_split.strong_correction_pair(*args)
            rh, rl = cuda_split.strong_correction_pair_plain(*args)
            check(torch.equal(kh, rh) and torch.equal(kl, rl),
                  f"kernel 8 vs plain on {name} (K = {k}): not bitwise")
            if "bound" in case:
                case["bound_share"] = case["bound"]["bound_ms"] * 1e3 / case["kernel_device_us"]
            # the production form (f64 in, kernel 7's a32 added in the kernel)
            # against the route it replaces, square and rows, bitwise
            mask = split.strong_pair_mask(idx, n)
            a32 = cuda_f32.pairwise_accel_f32_masked(tp.float(), tm.float().reshape(1, -1), mask,
                                                     diag_in_mask=True)
            for r0 in (0, n // 3):
                rows = None if r0 == 0 else tp[r0:]
                idx_r, a_r = idx[r0:].contiguous(), a32[r0:].contiguous()
                composed = cuda_nbody.combine_f64(*cuda_split.strong_correction_pair(
                    ph, pl, *cuda_nbody.split_f64(tp[r0:]), mh, ml, idx_r)) + a_r.double()
                fused = cuda_split.strong_correction_fused(tp, tm, idx_r, rows, a_r)
                check(torch.equal(fused, composed),
                      f"kernel 8's f64 form on {name} rows {r0}: not the composed route")
            case["fused_is_composed_route"] = True
            case["fused_device_us"] = graph_ms(
                lambda: cuda_split.strong_correction_fused(tp, tm, idx, a32=a32), 20) * 1e3
            sq = cuda_split._strong_correction_fast(tp, tm, idx)
            r0 = n // 3
            rows = cuda_split._strong_correction_fast(tp, tm, idx[r0:].contiguous(), rows=tp[r0:])
            check(torch.equal(rows, sq[r0:]), f"kernel 8 rows form on {name} is not bitwise")
            case["rows_form_bitwise"] = True
            out.append(case)
            keep("strong_corr", case)

        def split_err(p, m, k, **kw):
            tp, tm = dev64(p, m)
            idx = split.strong_pair_indices(tp, tm, k=k)
            a = cuda_split.pairwise_accel_split(tp, tm, idx, split.strong_pair_mask(idx, len(p)),
                                                **kw)
            return rel_rows(a, nbody.pairwise_accel(tp, tm))

        tp, tm = dev64(*hierarchy())
        idx = split.strong_pair_indices(tp, tm, k=6)
        fast_vs_f64 = rel_rows(cuda_split._strong_correction_fast(tp, tm, idx),
                               split._strong_correction(tp, tm, idx))
        bars = {  # name: (measured, bar), per body
            "corr_fast_vs_f64_hierarchy": (fast_vs_f64, 5e-12),
            "split_hierarchy_k6": (split_err(*hierarchy(), 6), 2e-9),
            "split_cloud64_k8": (split_err(*seeded_cloud(64, 11), 8), 4e-7),
            "all_strong_f64": (split_err(*seeded_cloud(16, 3), 15, corr="f64"), 1e-14),
            "all_strong_fast": (split_err(*seeded_cloud(16, 3), 15), 1e-12),
        }
        for what, (got, bar) in bars.items():
            check(got < bar, f"{what}: {got} >= {bar}")
        # test_strong_pair_selection_invariants on the card
        sel = split.strong_pair_indices(tp, tm, k=5).cpu()
        mask = split.strong_pair_mask(sel, 16)
        check(all(i not in r and len(set(r)) == 5 for i, r in enumerate(sel.tolist()))
              and int(mask.sum()) == 16 * 6 and bool(mask.diagonal().all())
              and 3 in sel[2] and 2 in sel[3] and 0 in sel[2] and 0 in sel[3],
              "strong-pair selection invariants")
        print(json.dumps({"phase": 15, "kernel": "strong_corr", "cases": out,
                          "bars": {k: {"measured": v[0], "bar": v[1]} for k, v in bars.items()},
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 16: path C, the force-mode ladder at N = 4096 ---------------------
    if 16 in phases:
        t_phase = time.perf_counter()
        p64, m64 = dev64(pos, mu)
        mu32 = m64.float().reshape(1, -1)
        ref = nbody.pairwise_accel(p64, m64)
        result = {}
        for mode, (loop, start, kernels) in ladder_loops(p64, m64).items():
            loop(start, 2)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            end = loop(start, LADDER_EVALS)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = read_counts()
            check(all(launches[k] == LADDER_EVALS for k in kernels)
                  and all(v == 0 for k, v in launches.items() if k not in kernels),
                  f"path C {mode}: launches {launches}, expected {LADDER_EVALS} of {kernels}")
            check(bool(torch.isfinite(end if mode != "mixed" else end[0]).all()),
                  f"path C {mode} state not finite")
            for k in kernels:
                record.setdefault(k, {})["launches"] = launches[k]
            result[mode] = {"launches": {k: launches[k] for k in kernels}, "path_s": elapsed,
                            "force_evals_per_s_x_bodies": N_BODIES * LADDER_EVALS / elapsed}
        # each mode's error against native f64 at the start positions
        idx = split.strong_pair_indices(p64, m64, k=STRONG_K)
        mask = split.strong_pair_mask(idx, N_BODIES)
        forces = {"f32": cuda_f32.pairwise_accel_f32(p64.float(), mu32),
                  "mixed": cuda_mixed.pairwise_accel_mixed(
                      *cuda_nbody.split_f64(p64, transpose=True), mu32),
                  "split": cuda_split.pairwise_accel_split(p64, m64, idx, mask),
                  "split_corr_f64": cuda_split.pairwise_accel_split(p64, m64, idx, mask, corr="f64")}
        scale = ref.abs().max().item()
        for mode, a in forces.items():
            a = a.double()
            per_body = (a - ref).norm(dim=1) / ref.norm(dim=1)
            err = (a - ref).abs().max().item() / scale
            result.setdefault(mode, {}).update({
                "rel_err_vs_f64": err, "per_body_max": per_body.max().item(),
                "per_body_median": per_body.median().item()})
            if mode in LADDER_BOUNDS:
                result[mode]["bound"] = LADDER_BOUNDS[mode]
                check(err <= LADDER_BOUNDS[mode], f"path C {mode} vs f64: {err}")
        check(result["split"]["rel_err_vs_f64"] < result["f32"]["rel_err_vs_f64"],
              "path C: the split mode is not more accurate than f32")
        print(json.dumps({"phase": 16, "path": "C", "n": N_BODIES, "k": STRONG_K,
                          "evals_per_mode": LADDER_EVALS, "modes": result,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))


    # -- slice 4: ensembles and the row decomposition ---------------------------
    def member_inputs(e, n):
        """Cluster seeds 0..e-1 as (E, 3, N) split positions, mu from seed 0."""
        pos_e = torch.as_tensor(np.stack([_cluster(n, seed=i)[0] for i in range(e)]), dtype=f64,
                                device=dev)
        mh_, ml_ = cuda_nbody.split_f64(torch.as_tensor(_cluster(n)[2], dtype=f64,
                                                        device=dev).reshape(1, -1))
        return (*cuda_nbody.split_f64(pos_e.transpose(1, 2)), mh_, ml_)

    def timed(kernel, plain, reps=20):
        return {"kernel_us": cuda_ms(kernel, reps) * 1e3,
                "kernel_device_us": graph_ms(kernel, reps) * 1e3,
                "plain_us": cuda_ms(plain, 2, 1) * 1e3}

    # -- phase 17: kernel 1's ensemble and rows forms -------------------------
    if 17 in phases:
        t_phase = time.perf_counter()
        out = []
        for e, n in ((ENSEMBLE, N_BODIES), (3, 1000), (2, 32)):
            ph, pl, mh, ml = member_inputs(e, n)
            kh, kl = cuda_nbody.pairwise_accel_df64_ensemble(ph, pl, mh, ml)
            rh, rl = cuda_nbody.pairwise_accel_df64_ensemble_plain(ph, pl, mh, ml)
            square = [cuda_nbody.pairwise_accel_df64(ph[m].contiguous(), pl[m].contiguous(), mh, ml)
                      for m in range(e)]
            torch.cuda.synchronize()
            k, r = cuda_nbody.combine_f64(kh, kl), cuda_nbody.combine_f64(rh, rl)
            abs_err = (k - r).abs().max().item()
            members = all(torch.equal(kh[m], sq[0]) and torch.equal(kl[m], sq[1])
                          for m, sq in enumerate(square))
            check(bool(torch.isfinite(k).all()), f"kernel 1 ensemble non-finite at {e} x {n}")
            check(abs_err <= KERNEL1_VS_PLAIN * r.abs().max().item(),
                  f"kernel 1 ensemble vs plain at {e} x {n}: {abs_err}")
            check(members, f"kernel 1 ensemble at {e} x {n}: a member is not the square kernel's")
            case = {"form": "ensemble", "e": e, "n": n, "max_abs_err": abs_err,
                    "rel_err_vs_plain": abs_err / r.abs().max().item(), "members_bitwise": members,
                    **timed(lambda: cuda_nbody.pairwise_accel_df64_ensemble(ph, pl, mh, ml),
                            lambda: cuda_nbody.pairwise_accel_df64_ensemble_plain(ph, pl, mh, ml))}
            if e == ENSEMBLE:
                # the same work as 16 square calls, for the cost of one launch
                case["square_x16_device_us"] = graph_ms(
                    lambda: [cuda_nbody.pairwise_accel_df64(ph[m], pl[m], mh, ml)
                             for m in range(e)], 5) * 1e3
                case["bound"] = bound_of(
                    lambda: cuda_nbody.pairwise_accel_df64_ensemble_plain(ph, pl, mh, ml),
                    [ph, pl, mh, ml, kh, kl])
                record["accel_df64_ensemble"] = kernel_record(
                    abs_err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        for n in (N_BODIES, 1000, 32):
            p_dev = torch.as_tensor(_cluster(n, seed=3)[0], dtype=f64, device=dev)
            ph, pl = cuda_nbody.split_f64(p_dev, transpose=True)
            mh, ml = cuda_nbody.split_f64(torch.as_tensor(_cluster(n, seed=3)[2], dtype=f64,
                                                          device=dev).reshape(1, -1))
            sq = cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)
            for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1)):
                rows = cuda_nbody.split_f64(p_dev[r0:r0 + nl])
                got = cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml, *rows, r0)
                check(torch.equal(got[0], sq[0][r0:r0 + nl]) and torch.equal(got[1], sq[1][r0:r0 + nl]),
                      f"kernel 1 rows form at {r0}:{r0 + nl} of {n} is not the square's slice")
            # at the main path's shape (path E at one rank: NL = N, row0 = 0)
            rows = cuda_nbody.split_f64(p_dev)
            got = cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml, *rows, 0)
            plain = cuda_nbody.pairwise_accel_df64_rows_plain(ph, pl, mh, ml, *rows, 0)
            abs_err = (cuda_nbody.combine_f64(*got) - cuda_nbody.combine_f64(*plain)).abs().max().item()
            case = {"form": "rows", "n": n, "row0s_bitwise_to_square": True, "max_abs_err": abs_err,
                    **timed(lambda: cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml, *rows, 0),
                            lambda: cuda_nbody.pairwise_accel_df64_rows_plain(ph, pl, mh, ml,
                                                                              *rows, 0))}
            if n == N_BODIES:
                case["bound"] = bound_of(
                    lambda: cuda_nbody.pairwise_accel_df64_rows_plain(ph, pl, mh, ml, *rows, 0),
                    [ph, pl, mh, ml, *rows, *got])
                record["accel_df64_rows"] = kernel_record(
                    abs_err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        print(json.dumps({"phase": 17, "kernel": "accel_df64 ensemble and rows forms",
                          "cases": out, "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 18: kernel 3's rows form -----------------------------------------
    if 18 in phases:
        t_phase = time.perf_counter()
        out = []
        for n in (N_BODIES, 1000, 32):
            p_np, _, m_np = _cluster(n, seed=4)
            limbs = ex.from_f64_host(p_np, dev)[:3]
            mh, ml = cuda_nbody.split_f64(torch.as_tensor(m_np, dtype=f64, device=dev).reshape(1, -1))
            src = [l.t().contiguous() for l in limbs]
            sq = cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)
            for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1)):
                recv = [l[r0:r0 + nl].contiguous() for l in limbs]
                got = cuda_limbs.pairwise_accel_limbs_pair_rows(*src, mh, ml, *recv, r0)
                check(torch.equal(got[0], sq[0][r0:r0 + nl]) and torch.equal(got[1], sq[1][r0:r0 + nl]),
                      f"kernel 3 rows form at {r0}:{r0 + nl} of {n} is not the square's slice")
            got = cuda_limbs.pairwise_accel_limbs_pair_rows(*src, mh, ml, *limbs, 0)
            plain = cuda_limbs.pairwise_accel_limbs_pair_rows_plain(*src, mh, ml, *limbs, 0)
            k, r = cuda_nbody.combine_f64(*got), cuda_nbody.combine_f64(*plain)
            abs_err = (k - r).abs().max().item()
            check(abs_err <= KERNEL3_VS_PLAIN * r.abs().max().item(),
                  f"kernel 3 rows form vs plain at {n}: {abs_err}")
            case = {"form": "rows", "n": n, "row0s_bitwise_to_square": True, "max_abs_err": abs_err,
                    "rel_err_vs_plain": abs_err / r.abs().max().item(),
                    **timed(lambda: cuda_limbs.pairwise_accel_limbs_pair_rows(*src, mh, ml, *limbs, 0),
                            lambda: cuda_limbs.pairwise_accel_limbs_pair_rows_plain(
                                *src, mh, ml, *limbs, 0))}
            if n == N_BODIES:
                case["bound"] = bound_of(
                    lambda: cuda_limbs.pairwise_accel_limbs_pair_rows_plain(*src, mh, ml, *limbs, 0),
                    [*src, mh, ml, *limbs, *got])
                record["accel_limbs3_rows"] = kernel_record(
                    abs_err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        print(json.dumps({"phase": 18, "kernel": "accel_limbs3 rows form", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 19: kernel 9, and the split mode with corr="dd" ------------------
    if 19 in phases:
        t_phase = time.perf_counter()
        out = []
        dd_cases = [("hierarchy", *hierarchy(), 6), ("ragged1000", *_cluster(1000, seed=1)[::2], 16),
                    ("cloud200_k128", *seeded_cloud(200, 14), 128),
                    ("cloud256_k200", *seeded_cloud(256, 14), 200)]
        dd_cases += [("cluster4096", *_cluster(N_BODIES)[::2], k) for k in (6, 40, 16)]
        for name, p, m, k in dd_cases:
            tp, tm = dev64(p, m)
            idx = split.strong_pair_indices(tp, tm, k=k)
            kh, kl = cuda_split.strong_correction_dd(tp, tm, idx)
            rh, rl = cuda_split.strong_correction_dd_plain(tp, tm, idx)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(kh, rh) and torch.equal(kl, rl))
            kc, rc = cuda_nbody.combine_f64(kh, kl), cuda_nbody.combine_f64(rh, rl)
            abs_err = (kc - rc).abs().max().item()
            vs_f64 = rel_rows(kc, split._strong_correction(tp, tm, idx))
            check(bool(torch.isfinite(kc).all()), f"kernel 9 non-finite on {name}")
            check(bitwise, f"kernel 9 vs plain on {name} (K = {k}): not bitwise, {abs_err}")
            check(vs_f64 <= DD_VS_F64, f"kernel 9 vs the f64 correction on {name}: {vs_f64}")
            # the f64 entry (kernel 7's weak tail added in the kernel) against
            # its plain version and the corr="dd" route it replaces, bitwise
            mask = split.strong_pair_mask(idx, len(p))
            a32 = cuda_f32.pairwise_accel_f32_masked(tp.float(), tm.float().reshape(1, -1), mask,
                                                     diag_in_mask=True)
            fused = cuda_split.strong_correction_dd_fused(tp, tm, idx, a32)
            check(torch.equal(fused, kc + a32.double())
                  and torch.equal(fused, cuda_split.strong_correction_dd_fused_plain(tp, tm, idx, a32))
                  and torch.equal(cuda_split.strong_correction_dd_fused(tp, tm, idx), kc),
                  f"kernel 9's f64 entry on {name} (K = {k}): not its plain version or the old route")
            case = {"input": name, "n": len(p), "k": k, "bitwise": bitwise, "max_abs_err": abs_err,
                    "per_body_vs_f64": vs_f64, "f64_entry_is_the_old_route": True,
                    **timed(lambda: cuda_split.strong_correction_dd(tp, tm, idx),
                            lambda: cuda_split.strong_correction_dd_plain(tp, tm, idx)),
                    "f64_entry_device_us": graph_ms(
                        lambda: cuda_split.strong_correction_dd_fused(tp, tm, idx, a32), 20) * 1e3}
            if name == "cluster4096" and k == STRONG_K:
                case["bound"] = bound_of(lambda: cuda_split.strong_correction_dd_plain(tp, tm, idx),
                                         [tp, tm, idx, kh, kl])
                case["bound_share"] = case["bound"]["bound_ms"] * 1e3 / case["kernel_device_us"]
                record["strong_corr_dd"] = kernel_record(
                    abs_err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        # the split mode with the dd correction at N = 4096, K = 16: its error
        # against native f64, and LADDER_EVALS evaluations as path C runs "split"
        p64, m64 = dev64(pos, mu)
        idx = split.strong_pair_indices(p64, m64, k=STRONG_K)
        mask = split.strong_pair_mask(idx, N_BODIES)
        ref = nbody.pairwise_accel(p64, m64)
        errs = {c: (cuda_split.pairwise_accel_split(p64, m64, idx, mask, corr=c) - ref).abs().max().item()
                / ref.abs().max().item() for c in ("dd", "fast", "f64")}
        check(errs["dd"] <= LADDER_BOUNDS["split"], f"split mode (dd) vs f64: {errs['dd']}")
        # one evaluation is four launches: two casts, kernel 7 and kernel 9's
        # f64 entry (no eager combine or add)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            cuda_split.pairwise_accel_split(p64, m64, idx, mask, corr="dd")
            torch.cuda.synchronize()
        per_eval = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        check(per_eval == 4, f"split mode (dd): {per_eval} launches an evaluation, expected 4")

        dd_loop, start, kernels = ladder_loops(p64, m64, dd=True)["split_dd"]
        dd_loop(start, 2)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        end = dd_loop(start, LADDER_EVALS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches_dd = read_counts()
        check(all(launches_dd[k] == LADDER_EVALS for k in kernels)
              and all(v == 0 for k, v in launches_dd.items() if k not in kernels),
              f"split mode (dd): launches {launches_dd}, expected {LADDER_EVALS} of {kernels}")
        check(bool(torch.isfinite(end).all()), "split mode (dd) state not finite")
        record.setdefault("strong_corr_dd", {})["launches"] = launches_dd["strong_corr_dd"]
        print(json.dumps({"phase": 19, "kernel": "strong_corr_dd", "cases": out,
                          "split_rel_err_vs_f64": errs, "split_bound": LADDER_BOUNDS["split"],
                          "dd_loop": {"evals": LADDER_EVALS, "launches": launches_dd,
                                      "launches_per_eval_profiled": per_eval, "path_s": elapsed,
                                      "force_evals_per_s_x_bodies": N_BODIES * LADDER_EVALS / elapsed},
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # path D's start: the ensemble startup through kernel 1's ensemble form
    # (shared by phases 20 and 21)
    ens_cache = {}

    def ensemble_start():
        if "carry0" not in ens_cache:
            ens_pos = np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(ENSEMBLE)])
            ens_vel = np.stack([_cluster(N_BODIES, seed=i)[1] for i in range(ENSEMBLE)])
            # the f64 startup takes the native-f64 force member by member (F2)
            reset_counts()
            t0 = time.perf_counter()
            ens_cache["carry0"] = sh.init_fused_ensemble_carry(tab, mu, 0.0, ens_pos, ens_vel, H,
                                                               device=dev)
            torch.cuda.synchronize()
            ens_cache["startup_s"] = time.perf_counter() - t0
            ens_cache["startup_launches"] = read_counts()
            ens_cache["pos"] = torch.as_tensor(ens_pos, dtype=f64, device=dev)
            run25, to_f = sh.make_fused_ensemble_scan_f(tab, mu, H, EARLY_STEPS, device=dev)
            ens_cache["f0"] = to_f(ens_cache["carry0"])
            ens_cache["f25"] = run25(ens_cache["f0"])
            torch.cuda.synchronize()
        return ens_cache

    # -- phase 20: path D, ensemble16x4096 ---------------------------------------
    if 20 in phases:
        t_phase = time.perf_counter()
        start = ensemble_start()
        check(not any(start["startup_launches"].values()),
              f"path D: the f64 ensemble startup launched kernels (F2): "
              f"{start['startup_launches']}")
        # F2: the f64 ensemble force is each member's single-system eager
        # force, bitwise
        ens_force = sh._fused_ensemble_accel(mu, dev)(0.0, start["pos"])
        force_bitwise = all(torch.equal(ens_force[m], nbody.pairwise_accel(start["pos"][m], mu_dev))
                            for m in range(ENSEMBLE))
        check(force_bitwise, "path D: an ensemble member's f64 force is not the single-system "
                             "eager force (F2)")
        del ens_force
        run50, _ = sh.make_fused_ensemble_scan_f(tab, mu, H, ENS_SCAN_STEPS, device=dev)
        c = run50(start["f0"])  # warm-up scan
        torch.cuda.synchronize()
        reset_counts()
        scan_s = []
        for _ in range(ENS_TIMED_SCANS):
            t0 = time.perf_counter()
            c = run50(c)
            torch.cuda.synchronize()
            scan_s.append(time.perf_counter() - t0)
        launches_d = read_counts()
        steps = ENS_SCAN_STEPS * ENS_TIMED_SCANS
        check(launches_d["accel_df64_ensemble"] == steps
              and launches_d["elm2f_update_shift"] == steps
              and sum(launches_d.values()) == 2 * steps,
              f"path D: launches {launches_d}, expected {steps} each of kernel 1-ensemble and "
              "kernel 2's shift entry")
        y_end = c.ys.hi[0].to(f64) + c.ys.lo[0].to(f64)
        check(bool(torch.isfinite(y_end).all() and torch.isfinite(c.dy).all()),
              "path D state non-finite")
        record.setdefault("accel_df64_ensemble", {})["launches"] = launches_d["accel_df64_ensemble"]

        # members 0 and 15 after EARLY_STEPS against the single-system fused step
        f25 = start["f25"]
        c0 = start["carry0"]
        members = {}
        for m in (0, ENSEMBLE - 1):
            cm = ms.elm2_f_from(ms.ELM2Carry(t=c0.t, ys=c0.ys[:, m], ddys=c0.ddys[:, m], dy=c0.dy[m]))
            for _ in range(EARLY_STEPS):
                cm = ms.elm2_step_f(tab, accel_pair_square, H, cm)
            members[m] = all(torch.equal(a[:, m], b) for a, b in
                             ((f25.ys.hi, cm.ys.hi), (f25.ys.lo, cm.ys.lo),
                              (f25.dd.hi, cm.dd.hi), (f25.dd.lo, cm.dd.lo)))
            check(members[m], f"path D member {m} after {EARLY_STEPS} steps is not the "
                              "single-system fused scan")
        # the f64 ensemble scan (the native-f64 force member by member, F2)
        # against per-member native f64
        run64 = sh.make_fused_ensemble_scan(tab, mu, H, EARLY_STEPS, device=dev)
        reset_counts()
        e64 = run64(c0)
        torch.cuda.synchronize()
        launches_64 = read_counts()
        check(not any(launches_64.values()),
              f"path D: the f64 ensemble scan launched kernels (F2): {launches_64}")
        worst = 0.0
        for m in range(ENSEMBLE):
            cm = ms.ELM2Carry(t=c0.t, ys=c0.ys[:, m], ddys=c0.ddys[:, m], dy=c0.dy[m])
            for _ in range(EARLY_STEPS):
                cm = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), H, cm,
                                  with_velocity=False)
            worst = max(worst, ((e64.ys[0, m] - cm.ys[0]).abs().max() / cm.ys[0].abs().max()).item())
        check(worst <= EARLY_BOUND, f"path D f64 ensemble scan vs native f64: {worst}")
        best = min(scan_s)
        print(json.dumps({
            "phase": 20, "path": "D", "config": "ensemble16x4096", "e": ENSEMBLE, "n": N_BODIES,
            "h_s": H, "scan_steps": ENS_SCAN_STEPS, "timed_scans": ENS_TIMED_SCANS,
            "scan_s": scan_s, "startup_s": start["startup_s"],
            "startup_launches": start["startup_launches"], "f64_scan_launches": launches_64,
            "f64_force_members_bitwise_to_single": force_bitwise,
            "body_steps_per_s": ENSEMBLE * N_BODIES * steps / sum(scan_s),
            "best_scan_body_steps_per_s": ENSEMBLE * N_BODIES * ENS_SCAN_STEPS / best,
            "us_per_step": sum(scan_s) / steps * 1e6, "launches": launches_d,
            "launches_per_step": sum(launches_d.values()) / steps,
            f"members_bitwise_after_{EARLY_STEPS}": {str(k): v for k, v in members.items()},
            f"f64_scan_rel_diff_vs_native_after_{EARLY_STEPS}": worst, "bound": EARLY_BOUND,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 21: path E, the row decomposition at one rank ---------------------
    if 21 in phases:
        import torch.distributed as dist

        t_phase = time.perf_counter()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            mesh = sh.make_mesh(1, 1)
            check(mesh.device_type == "cuda", f"make_mesh's default device is {mesh.device_type}")
            f0 = ms.elm2_f_from(ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), 0.0,
                                             torch.as_tensor(pos, dtype=f64, device=dev),
                                             torch.as_tensor(vel, dtype=f64, device=dev), H))
            cl_limbs, cl_pair = limb_forces(mu_dev)
            qf0 = ms.elm2_qf_from_q(ms.elm2_init_q(
                tab, None, 0.0, torch.as_tensor(pos, dtype=f64, device=dev),
                torch.as_tensor(vel, dtype=f64, device=dev), H, accel_limbs=cl_limbs))
            p64, m64 = dev64(pos, mu)
            ens = ensemble_start()
            torch.cuda.synchronize()

            # the sharded path, counts reset just before and read just after
            reset_counts()
            t0 = time.perf_counter()
            run_f, _ = sh.make_rowsharded_scan_f(mesh, tab, mu, H, EARLY_STEPS)
            out_f = run_f(f0)
            run_qf, _ = sh.make_rowsharded_scan_qf(mesh, tab, mu, H, EARLY_STEPS, precise_sums=True)
            out_qf = run_qf(qf0)
            refresh, force = sh.make_rowsharded_split_force(mesh, mu, k=STRONG_K)
            idx_s, mask_s = refresh(p64)
            a_s = force(p64, idx_s, mask_s)
            run_e, _ = sh.make_shardmap_ensemble_scan_f(mesh, tab, mu, H, EARLY_STEPS)
            out_e = run_e(ens["f0"])
            torch.cuda.synchronize()
            t_path = time.perf_counter() - t0
            launches_e = read_counts()
            for k in ("accel_df64_rows", "accel_limbs3_rows", "elm2f_update_shift", "elm2q_update",
                      "accel_f32_masked", "strong_corr", "accel_df64_ensemble"):
                check(launches_e[k] > 0, f"path E did not launch {k}: {launches_e}")
            check(launches_e["accel_df64"] == 0 and launches_e["accel_limbs3"] == 0,
                  f"path E launched a square pair kernel: {launches_e}")

            # the unsharded references
            ref_f = f0
            for _ in range(EARLY_STEPS):
                ref_f = ms.elm2_step_f(tab, accel_pair_square, H, ref_f)
            ref_qf = qf0
            for _ in range(EARLY_STEPS):
                ref_qf = ms.elm2_step_qf(tab, cl_pair, H, ref_qf, precise_sums=True)
            idx = split.strong_pair_indices(p64, m64, k=STRONG_K)
            mask = split.strong_pair_mask(idx, N_BODIES)
            a_ref = cuda_split.pairwise_accel_split(p64, m64, idx, mask)

            def same(a, b):
                return all(torch.equal(x, y) for x, y in zip(a, b))

            results = {
                "scan_f": same((*out_f.ys, *out_f.dd), (*ref_f.ys, *ref_f.dd)),
                "scan_qf_precise": same((*out_qf.ys, *out_qf.dd), (*ref_qf.ys, *ref_qf.dd)),
                "split_refresh": bool(torch.equal(idx_s, idx) and torch.equal(mask_s, mask)),
                "split_force": bool(torch.equal(a_s, a_ref)),
                "shardmap_ensemble": same((*out_e.ys, *out_e.dd), (*ens["f25"].ys, *ens["f25"].dd)),
            }
            for what, ok in results.items():
                check(ok, f"path E {what} is not the unsharded result bitwise")
        finally:
            dist.destroy_process_group()
        for k in ("accel_df64_rows", "accel_limbs3_rows"):
            record.setdefault(k, {})["launches"] = launches_e[k]
        print(json.dumps({"phase": 21, "path": "E", "ranks": 1, "backend": "nccl", "n": N_BODIES,
                          "steps": EARLY_STEPS, "bitwise": results, "launches": launches_e,
                          "path_s": t_path, "phase_s": time.perf_counter() - t_phase,
                          "card": smi}))

    # -- slice 5: kernels 2', 4', 10 and 11, paths F-I ---------------------------
    slice5 = {}

    def cluster_qf():
        """Path B's start (bench.py:bench_parity's startup), shared by 22 and 28."""
        if "qf0" not in slice5:
            slice5["qf0"] = ms.elm2_qf_from_q(init_cluster())
            torch.cuda.synchronize()
        return slice5["qf0"]

    # -- phase 22: kernels 2' and 4', the packed entry points ------------------
    if 22 in phases:
        t_phase = time.perf_counter()
        out = []
        rng = np.random.default_rng(31)
        small = TwoFloat(*cuda_nbody.split_f64(torch.as_tensor(
            rng.normal(size=(12, 8, 12)) * 1e8, device=dev)))
        small_dd = TwoFloat(*cuda_nbody.split_f64(torch.as_tensor(
            rng.normal(size=(12, 8, 12)) * 1e-6, device=dev)))
        fp0 = ms.elm2_fp_from(ensemble_start()["f0"])
        qfp0 = ms.elm2_qfp_from(cluster_qf())
        small_q = tuple(l.reshape(12, 8, 12) for l in ex.from_f64_host(
            rng.normal(size=(12, 96)) * 1e8, dev))
        f_cases = [("ensemble16x4096", fp0.ys, fp0.dd), ("n32", small, small_dd)]
        q_cases = [("cluster4096", qfp0.ys, qfp0.dd), ("n32", small_q, small_dd)]
        coef, c_y = cuda_elm2._tables(tab, H)
        for name, ys, dd in f_cases:
            k = cuda_elm2.elm2f_update_packed(tab, H, ys, dd)
            p = cuda_elm2.elm2f_update_plain(coef, c_y, ys, dd)
            u = cuda_elm2.elm2f_update(tab, H, TwoFloat(*(x.reshape(12, -1) for x in ys)),
                                       TwoFloat(*(x.reshape(12, -1) for x in dd)))
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k.hi, p.hi) and torch.equal(k.lo, p.lo))
            unpacked = bool(torch.equal(k.hi, u.hi.reshape(k.hi.shape))
                            and torch.equal(k.lo, u.lo.reshape(k.lo.shape)))
            diff = ((k.hi.to(f64) - p.hi.to(f64)) + (k.lo.to(f64) - p.lo.to(f64))).abs().max().item()
            check(bitwise and unpacked, f"kernel 2' on {name}: bitwise to plain {bitwise}, "
                                        f"to the unpacked entry point {unpacked}")
            case = {"kernel": "elm2f_update_packed", "input": name, "shape": list(ys.hi.shape),
                    "bitwise": bitwise, "bitwise_to_unpacked": unpacked, "max_abs_err": diff,
                    "kernel_us": cuda_ms(lambda: cuda_elm2.elm2f_update_packed(tab, H, ys, dd),
                                         200) * 1e3,
                    "kernel_device_us": graph_ms(
                        lambda: cuda_elm2.elm2f_update_packed(tab, H, ys, dd), 200) * 1e3,
                    "plain_us": cuda_ms(lambda: cuda_elm2.elm2f_update_plain(coef, c_y, ys, dd),
                                        20) * 1e3}
            if name == "ensemble16x4096":
                case["bound"] = bound_of(lambda: cuda_elm2.elm2f_update_plain(coef, c_y, ys, dd),
                                         [*_rows_read(ys, dd, coef, c_y, False), *k])
                record["elm2f_update_packed"] = kernel_record(
                    diff, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
            # the packed shift entry: bitwise to its plain version and to the
            # unpacked shift entry
            sk = cuda_elm2.elm2f_update_shift_packed(tab, H, ys, dd)
            sp = cuda_elm2.elm2f_update_shift_plain(coef, c_y, ys, dd)
            su = cuda_elm2.elm2f_update_shift(tab, H, TwoFloat(*(x.reshape(12, -1) for x in ys)),
                                              TwoFloat(*(x.reshape(12, -1) for x in dd)))
            torch.cuda.synchronize()
            bitwise = _shift_same(sk, sp)
            unpacked = _shift_same(sk, [TwoFloat(*(x.reshape(sk[i].hi.shape) for x in su[i]))
                                        for i in range(3)])
            diff = max((a.to(f64) - b.to(f64)).abs().max().item()
                       for a, b in zip((*sk[1], *(x[1:] for x in sk[2])),
                                       (*sp[1], *(x[1:] for x in sp[2]))))
            check(bitwise and unpacked, f"kernel 2's packed shift entry on {name}: bitwise to "
                                        f"plain {bitwise}, to the unpacked entry {unpacked}")
            case = {"kernel": "elm2f_update_shift_packed", "input": name,
                    "shape": list(ys.hi.shape), "bitwise": bitwise, "bitwise_to_unpacked": unpacked,
                    "max_abs_err": diff,
                    "kernel_us": cuda_ms(lambda: cuda_elm2.elm2f_update_shift_packed(
                        tab, H, ys, dd), 200) * 1e3,
                    "kernel_device_us": graph_ms(lambda: cuda_elm2.elm2f_update_shift_packed(
                        tab, H, ys, dd), 200) * 1e3,
                    "plain_us": cuda_ms(lambda: cuda_elm2.elm2f_update_shift_plain(
                        coef, c_y, ys, dd), 20) * 1e3}

            def update_and_cats():
                """What the packed shift entry replaces on path H's step."""
                ms._shift(tab, cuda_elm2.elm2f_update_packed(tab, H, ys, dd), ys)
                ms._shift(tab, TwoFloat(dd.hi[0], dd.lo[0]), dd)

            case["update_and_four_cats_device_us"] = graph_ms(update_and_cats, 200) * 1e3
            if name == "ensemble16x4096":
                case["bound"] = bound_of(
                    lambda: cuda_elm2.elm2f_update_shift_plain(coef, c_y, ys, dd),
                    [*_rows_read(ys, dd, coef, c_y, True), *sk[1], *(x[1:] for x in sk[2])])
                record["elm2f_update_shift_packed"] = kernel_record(
                    diff, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        for name, ys, dd in q_cases:
            for precise in (False, True):
                tables = cuda_elm2q._tables(tab, H, precise)
                k = cuda_elm2q.elm2q_update_packed(tab, H, ys, dd, precise=precise)
                p = cuda_elm2q.elm2q_update_plain(*tables, ys, dd, precise)
                u = cuda_elm2q.elm2q_update(tab, H, tuple(l.reshape(12, -1) for l in ys),
                                            TwoFloat(*(x.reshape(12, -1) for x in dd)),
                                            precise=precise)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(k, p))
                unpacked = all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(k, u))
                diff = sum(a.to(f64) - b.to(f64) for a, b in zip(k, p)).abs().max().item()
                check(bitwise and unpacked, f"kernel 4' on {name} (precise={precise}): bitwise "
                                            f"to plain {bitwise}, to the unpacked {unpacked}")
                case = {"kernel": "elm2q_update_packed", "input": name, "precise": precise,
                        "shape": list(ys[0].shape),
                        "bitwise": bitwise,
                        "bitwise_to_unpacked": unpacked, "max_abs_err": diff,
                        "kernel_us": cuda_ms(lambda: cuda_elm2q.elm2q_update_packed(
                            tab, H, ys, dd, precise=precise), 200) * 1e3,
                        "kernel_device_us": graph_ms(lambda: cuda_elm2q.elm2q_update_packed(
                            tab, H, ys, dd, precise=precise), 200) * 1e3,
                        "plain_us": cuda_ms(lambda: cuda_elm2q.elm2q_update_plain(
                            *tables, ys, dd, precise), 5, 1) * 1e3}
                if name == "cluster4096" and precise:
                    case["bound"] = bound_of(
                        lambda: cuda_elm2q.elm2q_update_plain(*tables, ys, dd, precise),
                        [*ys, *dd, *k])
                    case["bound_share"] = case["bound"]["bound_ms"] * 1e3 / case["kernel_device_us"]
                    record["elm2q_update_packed"] = kernel_record(
                        diff, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
                out.append(case)
        print(json.dumps({"phase": 22, "kernel": "elm2f_update_packed, elm2f_update_shift_packed, "
                                                 "elm2q_update_packed",
                          "cases": out, "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 23: kernel 10 against its plain version and kernel 1 ------------
    if 23 in phases:
        t_phase = time.perf_counter()
        out = []
        for n in (N_BODIES, 1024, 96):
            p_np, _, m_np = _cluster(n, seed=5)
            tp, tm = dev64(p_np, m_np)
            ph, pl = cuda_nbody.split_f64(tp, transpose=True)
            mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
            raw = cuda_sym.pairwise_accel_df64_sym(ph, pl, mh, ml)
            plain = cuda_sym.pairwise_accel_df64_sym_plain(ph, pl, mh, ml)
            k1 = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml))
            torch.cuda.synchronize()
            k, r = cuda_nbody.combine_f64(*raw), cuda_nbody.combine_f64(*plain)
            bitwise = bool(torch.equal(raw[0], plain[0]) and torch.equal(raw[1], plain[1]))
            abs_err = (k - r).abs().max().item()
            vs_k1 = (k - k1).abs().max().item() / k1.abs().max().item()
            check(bool(torch.isfinite(k).all()), f"kernel 10 non-finite at N = {n}")
            check(abs_err <= SYM_VS_KERNEL1 * r.abs().max().item(),
                  f"kernel 10 vs plain at N = {n}: {abs_err}")
            check(vs_k1 <= SYM_VS_KERNEL1, f"kernel 10 vs kernel 1 at N = {n}: {vs_k1}")
            case = {"n": n, "bitwise": bitwise, "max_abs_err": abs_err,
                    "rel_err_vs_kernel1": vs_k1, "bar": SYM_VS_KERNEL1,
                    **timed(lambda: cuda_sym.pairwise_accel_df64_sym(ph, pl, mh, ml),
                            lambda: cuda_sym.pairwise_accel_df64_sym_plain(ph, pl, mh, ml))}
            case["kernel1_device_us"] = graph_ms(
                lambda: cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml), 20) * 1e3
            if n == N_BODIES:
                case["bound"] = bound_of(
                    lambda: cuda_sym.pairwise_accel_df64_sym_plain(ph, pl, mh, ml),
                    [ph, pl, mh, ml, *raw])
                record["accel_sym"] = kernel_record(
                    abs_err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"])
            out.append(case)
        print(json.dumps({"phase": 23, "kernel": "accel_sym", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 24: kernel 11 against its plain version ----------------------------
    if 24 in phases:
        t_phase = time.perf_counter()
        out = []
        for name in GEN_SCENES:
            sc = scene.load_scene(ROOT / "systems" / name)
            h = sc.settings.dt.as_seconds()
            m64 = torch.as_tensor(sc.state.mus(), dtype=f64, device=dev)
            c0 = ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, m64), 0.0,
                              torch.as_tensor(sc.state.positions(), dtype=f64, device=dev),
                              torch.as_tensor(sc.state.velocities(), dtype=f64, device=dev), h)
            mu_pair = TwoFloat(*cuda_nbody.split_f64(m64.reshape(1, -1)))
            ys, c = cuda_gen.elm2_gen_scan(tab, h, c0, mu_pair, GEN_CHECK_STEPS)
            ysp, cp = cuda_gen.elm2_gen_scan_plain(tab, h, c0, mu_pair, GEN_CHECK_STEPS)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(ys, ysp) and torch.equal(c.ys, cp.ys)
                           and torch.equal(c.ddys, cp.ddys))
            abs_err = (ys - ysp).abs().max().item()
            ymax = ysp.abs().max().item()
            check(bool(torch.isfinite(ys).all()), f"kernel 11 non-finite on {name}")
            check(abs_err <= GEN_VS_PLAIN * ymax, f"kernel 11 vs plain on {name}: {abs_err / ymax}")
            check(torch.equal(ys[-1], c.ys[0]), f"kernel 11's last emission is not the ring head "
                                                f"on {name}")
            kms = cuda_ms(lambda: cuda_gen.elm2_gen_scan(tab, h, c0, mu_pair, GEN_CHECK_STEPS), 5)
            pms = cuda_ms(lambda: cuda_gen.elm2_gen_scan_plain(tab, h, c0, mu_pair,
                                                               GEN_CHECK_STEPS), 1, 1)
            case = {"scene": name, "n": sc.state.n, "padded_n": 1 << (sc.state.n - 1).bit_length(),
                    "steps": GEN_CHECK_STEPS, "bitwise": bitwise, "max_abs_err": abs_err,
                    "rel_err_vs_plain": abs_err / ymax, "bar": GEN_VS_PLAIN,
                    "kernel_us": kms * 1e3, "kernel_us_per_step": kms * 1e3 / GEN_CHECK_STEPS,
                    "plain_us": pms * 1e3}
            if name == GEN_SCENES[0]:
                case["bound"] = bound_of(
                    lambda: cuda_gen.elm2_gen_scan_plain(tab, h, c0, mu_pair, GEN_CHECK_STEPS),
                    [c0.ys, c0.ddys, *mu_pair, ys, c.ys, c.ddys])
                record["gen_scan"] = kernel_record(abs_err, kms, pms, case["bound"])
            out.append(case)
        print(json.dumps({"phase": 24, "kernel": "gen_scan", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 25: path F, a year of full_solar_system through kernel 11 -----------
    if 25 in phases:
        t_phase = time.perf_counter()
        fss_mu = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        h = fss.settings.dt.as_seconds()

        def accel64(t, y):
            return nbody.pairwise_accel(y, fss_mu)

        # the native-f64 startup, as generation runs it
        t_s, dy_s, ys_fwd, dd_fwd = ms.elm2_startup_scan(
            tab, accel64, 0.0, torch.as_tensor(fss.state.positions(), dtype=f64, device=dev),
            torch.as_tensor(fss.state.velocities(), dtype=f64, device=dev), h)
        c0 = ms.ELM2Carry(t=t_s, ys=ys_fwd.flip(0), ddys=dd_fwd.flip(0), dy=dy_s)
        mu_pair = TwoFloat(*cuda_nbody.split_f64(fss_mu.reshape(1, -1)))
        n_chunks, rest = divmod(GEN_YEAR_STEPS, eph.CHUNK_STEPS)
        chunks = [eph.CHUNK_STEPS] * n_chunks + ([rest] if rest else [])
        cuda_gen.elm2_gen_scan(tab, h, c0, mu_pair, 16)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        c, first = c0, None
        for steps in chunks:
            ys, c = cuda_gen.elm2_gen_scan(tab, h, c, mu_pair, steps)
            first = c if first is None else first
        c = c._replace(dy=ms.elm2_velocity(tab, c, h))
        torch.cuda.synchronize()
        t_year = time.perf_counter() - t0
        launches_f = read_counts()
        check(launches_f["gen_scan"] == len(chunks) and sum(launches_f.values()) == len(chunks),
              f"path F: launches {launches_f}, expected one of kernel 11 per chunk")
        chunk_ms = cuda_ms(lambda: cuda_gen.elm2_gen_scan(tab, h, c0, mu_pair, eph.CHUNK_STEPS),
                           1, 0)
        # the reference test's invariants
        emission_is_head = bool(torch.equal(ys[-1], c.ys[0]))
        f_head = accel64(c.t, c.ys[0])
        head_err = ((c.ddys[0] - f_head).abs().max() / f_head.abs().max()).item()
        check(emission_is_head, "path F: the last emission is not the committed ring head")
        check(head_err <= KERNEL1_VS_F64_FSS, f"path F: force ring head vs f64: {head_err}")
        check(bool(torch.isfinite(c.ys).all() and torch.isfinite(c.dy).all()),
              "path F state non-finite")
        # after the first chunk, against native f64 beside two fused two-float
        # steps: with kernel 1's two-float force (state and force two-float,
        # as in kernel 11: its envelope), and generation's fused branch (the
        # native-f64 force on hi + lo, split: F3)
        mh, ml = mu_pair

        def kernel1_pair(t, y):
            return TwoFloat(*cuda_nbody.pairwise_accel_df64(y.hi.t().contiguous(),
                                                            y.lo.t().contiguous(), mh, ml))

        def f64_pair(t, y):
            return ms._split_pair(accel64(t, y.hi.to(f64) + y.lo.to(f64)))

        cn, cf, c3 = c0, ms.elm2_f_from(c0), ms.elm2_f_from(c0)
        for _ in range(chunks[0]):
            cn = ms.elm2_step(tab, accel64, h, cn, with_velocity=False)
            cf = ms.elm2_step_f(tab, kernel1_pair, h, cf)
            c3 = ms.elm2_step_f(tab, f64_pair, h, c3)
        y64 = cn.ys[0]
        d_gen = first.ys[0] - y64
        d_f = cf.ys.hi[0].to(f64) + cf.ys.lo[0].to(f64) - y64
        d_3 = c3.ys.hi[0].to(f64) + c3.ys.lo[0].to(f64) - y64
        err_gen, err_f, err_3 = (d.abs().max().item() for d in (d_gen, d_f, d_3))
        env = max(GEN_ENVELOPE * err_f, GEN_FLOOR * y64.abs().max().item())
        check(err_gen <= env, f"path F after {chunks[0]} steps: {err_gen} km > {env} km")

        # generation through the private gate, against native f64 and the fused
        # route (kernel 11-f64's gate patched off for both of those)
        year = port.Duration.from_days(365.25)

        def generate(**gates):
            saved = {g: getattr(eph, g) for g in gates}
            for g, on in gates.items():
                setattr(eph, g, lambda n, d, on=on: on)
            try:
                t0 = time.perf_counter()
                e = eph.generate_ephemeris(fss.state, fss.settings, year, device=dev)
                torch.cuda.synchronize()
                return e, time.perf_counter() - t0
            finally:
                for g, fn in saved.items():
                    setattr(eph, g, fn)

        reset_counts()
        e_gen, t_gen = generate(_use_gen_kernel=True)
        launches_gen = read_counts()
        check(launches_gen["gen_scan"] > 0 and launches_gen["accel_df64"] == 0
              and launches_gen["gen_scan_f64"] == 0,
              f"path F generation did not run kernel 11 alone: {launches_gen}")
        e_fused, _ = generate(_use_fused_f=True, _use_gen_kernel_f64=False)
        e_64 = fss_year["f64"] if "f64" in fss_year else generate(_use_gen_kernel_f64=False)[0]
        coeffs = {k: {n: e[n].coeffs for n in e.names}
                  for k, e in (("gen", e_gen), ("fused", e_fused), ("f64", e_64))}
        cerr_gen = _coeff_err(coeffs["f64"], coeffs["gen"], fss.settings)
        cerr_fused = _coeff_err(coeffs["f64"], coeffs["fused"], fss.settings)
        # the fused branch no longer takes kernel 1's force (F3), so kernel
        # 11's like-for-like route (two-float state and force) is estimated
        # from it by the two steps' distances after the first chunk
        cbar = max(GEN_ENVELOPE * cerr_fused * max(1.0, err_f / err_3), FSS_BOUND)
        check(cerr_gen <= cbar, f"path F generation vs f64: {cerr_gen} > {cbar}")
        record.setdefault("gen_scan", {})["launches"] = launches_f["gen_scan"]
        print(json.dumps({
            "phase": 25, "path": "F", "scene": "full_solar_system_2433282.5", "n": fss.state.n,
            "steps": GEN_YEAR_STEPS, "chunks": chunks, "launches": launches_f,
            "launches_per_chunk": launches_f["gen_scan"] / len(chunks),
            "integration_s": t_year,
            "integration_sim_days_per_s": GEN_YEAR_STEPS * h / 86400.0 / t_year,
            "chunk_ms": chunk_ms, "kernel_us_per_step": chunk_ms * 1e3 / eph.CHUNK_STEPS,
            "year_loop_us_per_step": t_year * 1e6 / GEN_YEAR_STEPS,
            "generation_s": t_gen, "generation_sim_days_per_s": 365.25 / t_gen,
            "generation_launches": launches_gen,
            f"err_km_after_{chunks[0]}": err_gen,
            f"fused_kernel1_err_km_after_{chunks[0]}": err_f,
            f"fused_err_km_after_{chunks[0]}": err_3,
            "worst_bodies_km": _worst_bodies(d_gen, fss),
            "fused_kernel1_worst_bodies_km": _worst_bodies(d_f, fss),
            "fused_worst_bodies_km": _worst_bodies(d_3, fss),
            "envelope_km": env, "last_emission_is_ring_head": emission_is_head,
            "force_head_rel_err_vs_f64": head_err, "force_head_bar": KERNEL1_VS_F64_FSS,
            "coeff_err_vs_f64": cerr_gen, "fused_coeff_err_vs_f64": cerr_fused,
            "coeff_bar": cbar, "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 26: path G, kernel 10 at cluster4096 -------------------------------
    if 26 in phases:
        t_phase = time.perf_counter()
        p64 = torch.as_tensor(pos, dtype=f64, device=dev)

        def sym_loop(p, evals):  # as path C's loops: each evaluation moves the state
            for _ in range(evals):
                p = p + cuda_sym.pairwise_accel_sym(p, mu_hi, mu_lo) * 1e-30
            return p

        sym_loop(p64, 2)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        end = sym_loop(p64, LADDER_EVALS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches_g = read_counts()
        check(launches_g["accel_sym"] == LADDER_EVALS and sum(launches_g.values()) == LADDER_EVALS,
              f"path G: launches {launches_g}, expected {LADDER_EVALS} of kernel 10")
        check(bool(torch.isfinite(end).all()), "path G state non-finite")
        ph, pl = cuda_nbody.split_f64(p64, transpose=True)
        sym_us = graph_ms(lambda: cuda_sym.pairwise_accel_df64_sym(ph, pl, mu_hi, mu_lo), 20) * 1e3
        k1_us = graph_ms(lambda: cuda_nbody.pairwise_accel_df64(ph, pl, mu_hi, mu_lo), 20) * 1e3

        # a 25-step fused scan with kernel 10 as the force, against kernel 1's
        def sym_pair(t, y):
            return TwoFloat(*cuda_sym.pairwise_accel_df64_sym(
                y.hi.t().contiguous(), y.lo.t().contiguous(), mu_hi, mu_lo))

        f0 = ms.elm2_f_from(ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), 0.0,
                                         p64, torch.as_tensor(vel, dtype=f64, device=dev), H))
        cs, ck = f0, f0
        for _ in range(EARLY_STEPS):
            cs = ms.elm2_step_f(tab, sym_pair, H, cs)
            ck = ms.elm2_step_f(tab, accel_pair_square, H, ck)
        ys_ = cs.ys.hi[0].to(f64) + cs.ys.lo[0].to(f64)
        yk = ck.ys.hi[0].to(f64) + ck.ys.lo[0].to(f64)
        scan_diff = ((ys_ - yk).abs().max() / yk.abs().max()).item()
        check(scan_diff <= EARLY_BOUND, f"path G scan vs kernel 1's after {EARLY_STEPS}: {scan_diff}")
        record.setdefault("accel_sym", {})["launches"] = launches_g["accel_sym"]
        print(json.dumps({
            "phase": 26, "path": "G", "n": N_BODIES, "evals": LADDER_EVALS, "launches": launches_g,
            "path_s": elapsed, "force_evals_per_s_x_bodies": N_BODIES * LADDER_EVALS / elapsed,
            "kernel10_device_us": sym_us, "kernel1_device_us": k1_us,
            f"scan_rel_diff_vs_kernel1_after_{EARLY_STEPS}": scan_diff, "bound": EARLY_BOUND,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 27: path H, ensemble16x4096 on the packed carry --------------------
    if 27 in phases:
        t_phase = time.perf_counter()
        start = ensemble_start()
        shape = (ENSEMBLE, N_BODIES, 3)
        run25, to_fp = sh.make_fused_ensemble_scan_fp(tab, mu, H, EARLY_STEPS, shape, device=dev)
        fp0 = to_fp(start["carry0"])
        h25 = run25(fp0)
        back = ms.elm2_fp_to(h25, shape)
        ref = start["f25"]
        packed_is_unpacked = all(torch.equal(a, b) for a, b in zip(
            (*back.ys, *back.dd, back.dy), (*ref.ys, *ref.dd, ref.dy)))
        check(packed_is_unpacked, f"path H after {EARLY_STEPS} steps is not path D's scan bitwise")
        run50, _ = sh.make_fused_ensemble_scan_fp(tab, mu, H, ENS_SCAN_STEPS, shape, device=dev)
        c = run50(fp0)  # warm-up scan
        torch.cuda.synchronize()
        reset_counts()
        scan_s = []
        for _ in range(ENS_TIMED_SCANS):
            t0 = time.perf_counter()
            c = run50(c)
            torch.cuda.synchronize()
            scan_s.append(time.perf_counter() - t0)
        launches_h = read_counts()
        steps = ENS_SCAN_STEPS * ENS_TIMED_SCANS
        check(launches_h["accel_df64_ensemble"] == steps
              and launches_h["elm2f_update_shift_packed"] == steps
              and sum(launches_h.values()) == 2 * steps,
              f"path H: launches {launches_h}, expected {steps} each of kernel 1-ensemble and "
              "kernel 2's packed shift entry")
        check(bool(torch.isfinite(c.ys.hi).all() and torch.isfinite(c.dy).all()),
              "path H state non-finite")
        # the packed step before the fold (kernel 2's packed update entry and
        # four concatenations): path H's bits
        accel_ens = sh._ensemble_accel_pair(mu, dev)
        reset_counts()
        cat25 = fp0
        for _ in range(EARLY_STEPS):
            cat25 = ms._step_fp_cat(tab, accel_ens, H, cat25, shape)
        torch.cuda.synchronize()
        launches_cat = read_counts()
        check(launches_cat["elm2f_update_packed"] == EARLY_STEPS
              and launches_cat["accel_df64_ensemble"] == EARLY_STEPS
              and sum(launches_cat.values()) == 2 * EARLY_STEPS,
              f"path H before the fold: launches {launches_cat}")
        fold_bitwise = all(torch.equal(a, b) for a, b in zip((*cat25.ys, *cat25.dd),
                                                             (*h25.ys, *h25.dd)))
        check(fold_bitwise, f"path H after {EARLY_STEPS} steps is not the step before the fold")
        record.setdefault("elm2f_update_shift_packed", {})["launches"] = \
            launches_h["elm2f_update_shift_packed"]
        record.setdefault("elm2f_update_packed", {})["launches"] = \
            launches_cat["elm2f_update_packed"]
        print(json.dumps({
            "phase": 27, "path": "H", "config": "ensemble16x4096", "e": ENSEMBLE, "n": N_BODIES,
            "scan_steps": ENS_SCAN_STEPS, "timed_scans": ENS_TIMED_SCANS, "scan_s": scan_s,
            "body_steps_per_s": ENSEMBLE * N_BODIES * steps / sum(scan_s),
            "us_per_step": sum(scan_s) / steps * 1e6, "launches": launches_h,
            f"bitwise_to_path_D_after_{EARLY_STEPS}": packed_is_unpacked,
            "before_fold": {"steps": EARLY_STEPS, "launches": launches_cat,
                            "bitwise_to_path_H": fold_bitwise},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 28: path I, the packed parity step at N = 4096 ---------------------
    if 28 in phases:
        t_phase = time.perf_counter()
        q0 = cluster_qf()
        shape = (N_BODIES, 3)
        qfp = ms.elm2_qfp_from(q0)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(EARLY_STEPS):
            qfp = ms.elm2_step_qfp(tab, cl_pair, H, qfp, shape, precise_sums=True)
        torch.cuda.synchronize()
        t_packed = time.perf_counter() - t0
        launches_i = read_counts()
        check(launches_i["elm2q_update_packed"] == EARLY_STEPS
              and launches_i["accel_limbs3"] == EARLY_STEPS
              and sum(launches_i.values()) == 2 * EARLY_STEPS,
              f"path I: launches {launches_i}, expected {EARLY_STEPS} each of kernels 4' and 3")
        ref = q0
        for _ in range(EARLY_STEPS):
            ref = ms.elm2_step_qf(tab, cl_pair, H, ref, precise_sums=True)
        back = ms.elm2_qfp_to(qfp, shape)
        same = all(torch.equal(a, b) for a, b in zip((*back.ys, *back.dd), (*ref.ys, *ref.dd)))
        check(same, f"path I after {EARLY_STEPS} steps is not path B's elm2_step_qf bitwise")
        record.setdefault("elm2q_update_packed", {})["launches"] = launches_i["elm2q_update_packed"]
        print(json.dumps({
            "phase": 28, "path": "I", "n": N_BODIES, "steps": EARLY_STEPS, "launches": launches_i,
            "path_s": t_packed, "body_steps_per_s": N_BODIES * EARLY_STEPS / t_packed,
            f"bitwise_to_elm2_step_qf_after_{EARLY_STEPS}": same,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 29: kernel 11-f64 against its plain version ----------------------
    if 29 in phases:
        t_phase = time.perf_counter()
        out = []
        # forward on the scenes and at the cap, then backward (h < 0, the
        # route of backward generation) on the scenes
        for case, direction in [*((c, 1) for c in (*GEN_SCENES, GEN64_CAP)),
                                *((c, -1) for c in GEN_SCENES)]:
            if isinstance(case, str):
                sc = scene.load_scene(ROOT / "systems" / case)
                h = sc.settings.dt.as_seconds() * direction
                p_np, v_np, m_np = sc.state.positions(), sc.state.velocities(), sc.state.mus()
            else:
                (p_np, v_np, m_np), h = _cluster(case, seed=6), H
            m64 = torch.as_tensor(m_np, dtype=f64, device=dev)
            c0 = ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, m64), 0.0,
                              torch.as_tensor(p_np, dtype=f64, device=dev),
                              torch.as_tensor(v_np, dtype=f64, device=dev), h)
            ys, c = cuda_gen.elm2_gen_scan_f64(tab, h, c0, m64, GEN_CHECK_STEPS)
            ysp, cp = cuda_gen.elm2_gen_scan_f64_plain(tab, h, c0, m64, GEN_CHECK_STEPS)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(ys, ysp) and torch.equal(c.ys, cp.ys)
                           and torch.equal(c.ddys, cp.ddys))
            abs_err = max((ys - ysp).abs().max().item(), (c.ys - cp.ys).abs().max().item())
            ymax = ysp.abs().max().item()
            f_err = (c.ddys - cp.ddys).abs().max().item() / cp.ddys.abs().max().item()
            name = case if isinstance(case, str) else f"cloud{case}"
            if direction < 0:
                name += " backward"
                check(bitwise, f"kernel 11-f64 backward is not bitwise to plain on {name}")
            check(bool(torch.isfinite(ys).all()), f"kernel 11-f64 non-finite on {name}")
            check(abs_err <= GEN64_VS_PLAIN * ymax and f_err <= GEN64_VS_PLAIN,
                  f"kernel 11-f64 vs plain on {name}: {abs_err / ymax} of max|y|, "
                  f"{f_err} of max|a|")
            check(torch.equal(ys[-1], c.ys[0]), f"kernel 11-f64's last emission is not the ring "
                                                f"head on {name}")
            kms = cuda_ms(lambda: cuda_gen.elm2_gen_scan_f64(tab, h, c0, m64, GEN_CHECK_STEPS), 5)
            pms = cuda_ms(lambda: cuda_gen.elm2_gen_scan_f64_plain(tab, h, c0, m64,
                                                                   GEN_CHECK_STEPS), 1, 1)
            long_ms = cuda_ms(lambda: cuda_gen.elm2_gen_scan_f64(tab, h, c0, m64,
                                                                 GEN64_TIMED_STEPS), 2, 1)
            case_out = {"input": name, "n": len(m_np), "h_s": h, "steps": GEN_CHECK_STEPS,
                        "bitwise": bitwise, "max_abs_err": abs_err, "rel_err_vs_plain": abs_err / ymax,
                        "force_rel_err_vs_plain": f_err, "bar": GEN64_VS_PLAIN,
                        "kernel_us": kms * 1e3, "plain_us": pms * 1e3,
                        "timed_steps": GEN64_TIMED_STEPS,
                        "kernel_us_per_step": long_ms * 1e3 / GEN64_TIMED_STEPS}
            b = bound_of(lambda: cuda_gen.elm2_gen_scan_f64_plain(tab, h, c0, m64, GEN_CHECK_STEPS),
                         [c0.ys, c0.ddys, m64, ys, c.ys, c.ddys])
            case_out["bound"] = b
            case_out["bound_us_per_step"] = b["bound_ms"] * 1e3 / GEN_CHECK_STEPS
            case_out["bound_one_sm_us_per_step"] = case_out["bound_us_per_step"] * SMS
            if case == GEN_SCENES[0] and direction > 0:
                record.setdefault("gen_scan_f64", {}).update(kernel_record(abs_err, kms, pms, b))
            out.append(case_out)
        print(json.dumps({"phase": 29, "kernel": "gen_scan_f64", "cases": out,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    def flight_ops(fly) -> dict:
        """aten ops an iteration of the fleet loop, from one flight under a
        dispatch mode: all of them, and those that launch on the device."""
        sc_.propagate_batch.iterations = 0
        ops = step_ops(lambda _: fly(), None)
        it = sc_.propagate_batch.iterations
        launching = sum(v for k, v in ops.items() if k not in VIEW_OPS)
        return {"iterations": it, "aten_ops_per_iteration": sum(ops.values()) / it,
                "launching_ops_per_iteration": launching / it}

    def fleet_run(fly):
        """(result, wall s, iterations, host syncs) of one propagation."""
        sc_.propagate_batch.iterations = sc_.propagate_batch.syncs = 0
        t0 = time.perf_counter()
        out = fly()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, sc_.propagate_batch.iterations,
                sc_.propagate_batch.syncs)

    # -- phase 30: the mission: generation, then the Mars Transfer Ship ---------
    mission = {}  # phase 30's ephemeris and flight, which phase 32 is held to
    if 30 in phases:
        t_phase = time.perf_counter()
        fss_m = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        span = port.Duration.from_days(MISSION_EPH_DAYS)
        n_chunks = -(-round(span.as_seconds() / fss_m.settings.dt.as_seconds()) // eph.CHUNK_STEPS)
        reset_counts()
        t0 = time.perf_counter()
        e_m = eph.generate_ephemeris(fss_m.state, fss_m.settings, span, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_gen = read_counts()
        check(launches_gen["gen_scan_f64"] == n_chunks and sum(launches_gen.values()) == n_chunks,
              f"phase 30: generation launches {launches_gen}, expected one of kernel 11-f64 "
              f"per chunk ({n_chunks})")
        ship = next(x for x in fss_m.ships if x.name == "Mars Transfer Ship")
        until = port.Epoch.parse(MISSION_UNTIL)

        def fly(device, end=until):
            return sc_.propagate_ship(e_m, ship, until=end, max_knots=MISSION_KNOTS,
                                      device=device)

        reset_counts()
        traj, fly_s, fly_it, fly_syncs = fleet_run(lambda: fly(dev))
        launches_fly = read_counts()
        check(not any(launches_fly.values()), f"phase 30: the flight launched {launches_fly}")
        check(traj.end_s >= until.as_offset_seconds() - 1.0,
              f"the mission stopped early at {port.Epoch.from_offset_seconds(traj.end_s)}")
        dist, dist_cpu = {}, {}
        t_cpu = time.perf_counter()
        traj_cpu = fly("cpu")
        cpu_s = time.perf_counter() - t_cpu
        for body, when in MISSION_EPOCHS:
            t = port.Epoch.parse(when)
            p, b, pc = traj.position(t), e_m[body].position(t), traj_cpu.position(t)
            check(p is not None and b is not None and pc is not None, f"no position at {when}")
            dist[f"{body} {when}"] = float(np.linalg.norm(p - b))
            dist_cpu[f"{body} {when}"] = float(np.linalg.norm(p - pc))
        check(all(d < MISSION_KM for d in dist.values()),
              f"the mission missed a reference epoch by {MISSION_KM} km or more: {dist}")
        count_end = port.Epoch.from_offset_seconds(ship.start.as_offset_seconds()
                                                   + MISSION_COUNT_DAYS * 86400.0)
        ops_it = flight_ops(lambda: fly(dev, count_end))
        mission.update(eph=e_m, traj=traj)
        # the Earth Station coast on both devices
        sem = scene.load_scene(ROOT / "systems" / "sun_earth_moon_2433282.5")
        e_sem = eph.generate_ephemeris(sem.state, sem.settings, port.Duration.from_days(40.0),
                                       device=dev)
        reset_counts()
        st_g, st_s, st_it, _ = fleet_run(lambda: sc_.propagate_ship(e_sem, sem.ships[0], device=dev))
        check(not any(read_counts().values()), "phase 30: the Earth Station flight launched kernels")
        st_c = sc_.propagate_ship(e_sem, sem.ships[0], device="cpu")
        st_km = _traj_km(st_c, st_g)
        check(st_km <= FLEET_VS_SINGLE_KM and abs(st_g.end_s - st_c.end_s) < 1.0,
              f"Earth Station, CUDA against CPU: {st_km} km, ends {st_g.end_s} / {st_c.end_s}")
        print(json.dumps({
            "phase": 30, "path": "mission", "scene": "full_solar_system_2433282.5",
            "ship": ship.name, "method": ship.integrator, "tolerance_km": ship.tolerance,
            "ephemeris_days": MISSION_EPH_DAYS, "generation_s": gen_s, "chunks": n_chunks,
            "generation_launches": launches_gen, "until": MISSION_UNTIL,
            "reached": str(port.Epoch.from_offset_seconds(traj.end_s)),
            "distance_km": dist, "bar_km": MISSION_KM, "knots": len(traj.ts),
            "iterations": fly_it, "host_syncs": fly_syncs, "sync_every": sc_.SYNC_EVERY,
            "wall_s": fly_s, "ms_per_iteration": fly_s * 1e3 / fly_it,
            "flight_launches": launches_fly, "dispatch_count": ops_it,
            "cpu_wall_s": cpu_s, "cpu_knots": len(traj_cpu.ts), "cuda_vs_cpu_km": dist_cpu,
            "earth_station": {"knots": len(st_g.ts), "cpu_knots": len(st_c.ts),
                              "iterations": st_it, "wall_s": st_s,
                              "cuda_vs_cpu_km_at_0.1_0.5_0.9": st_km,
                              "bar_km": FLEET_VS_SINGLE_KM},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 31: fleet64 ---------------------------------------------------------
    if 31 in phases:
        t_phase = time.perf_counter()
        fss_f = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        e_f = eph.generate_ephemeris(fss_f.state, fss_f.settings,
                                     port.Duration.from_days(FLEET_EPH_DAYS), device=dev)
        ships = _fleet_ships(fss_f, e_f, FLEET_SHIPS, FLEET_DAYS)

        def fleet():
            return sc_.propagate_ships(e_f, ships, max_knots=FLEET_KNOTS, device=dev)

        first, warm_s, _, _ = fleet_run(fleet)
        spans = [tr.end_s - tr.start_s for tr in first.values()]
        check(min(spans) > FLEET_MIN_SPAN_DAYS * 86400.0,
              f"fleet64: a ship spans only {min(spans) / 86400.0} days")
        reset_counts()
        runs = [fleet_run(fleet) for _ in range(FLEET_RUNS)]
        launches_fleet = read_counts()
        check(not any(launches_fleet.values()), f"fleet64 launched kernels: {launches_fleet}")
        same = all(np.array_equal(r[0][x.name].ts, first[x.name].ts)
                   and np.array_equal(r[0][x.name].pos, first[x.name].pos)
                   for r in runs for x in ships)
        check(same, "fleet64 is not bitwise to itself across runs")
        singles = {}
        for i in FLEET_SINGLES:
            solo = sc_.propagate_ship(e_f, ships[i], max_knots=FLEET_KNOTS, device=dev)
            km = _traj_km(solo, first[ships[i].name])
            check(km <= FLEET_VS_SINGLE_KM and abs(solo.end_s - first[ships[i].name].end_s) < 1.0,
                  f"fleet64 ship {i} against its single-ship run: {km} km")
            singles[str(i)] = km
        ops_it = flight_ops(fleet)
        knots = [len(tr.ts) for tr in first.values()]
        walls = [r[1] for r in runs]
        print(json.dumps({
            "phase": 31, "path": "fleet64", "scene": "full_solar_system_2433282.5",
            "ships": FLEET_SHIPS, "mission_days": FLEET_DAYS, "ephemeris_days": FLEET_EPH_DAYS,
            "method": "Verner87", "tolerance_km": 1e-3, "max_knots": FLEET_KNOTS,
            "min_span_days": min(spans) / 86400.0, "knots_min_max": [min(knots), max(knots)],
            "knots_total": sum(knots), "warm_s": warm_s, "wall_s": walls,
            "ship_days_per_s": [FLEET_SHIPS * FLEET_DAYS / w for w in walls],
            "iterations": [r[2] for r in runs], "host_syncs": [r[3] for r in runs],
            "sync_every": sc_.SYNC_EVERY,
            "ms_per_iteration": [r[1] * 1e3 / r[2] for r in runs],
            "bitwise_across_runs": same, "singles_km_at_0.1_0.5_0.9": singles,
            "bar_km": FLEET_VS_SINGLE_KM, "dispatch_count": ops_it, "launches": launches_fleet,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 32: the Universe session ------------------------------------------
    if 32 in phases:
        from ephemeris_explorer_tpu_torch import api, events

        t_phase = time.perf_counter()
        host_s = {}

        def timed(step, fn):
            """fn() with its host time (to a synchronize) under host_s[step]."""
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            host_s[step] = time.perf_counter() - t0
            return out

        u = timed("load", lambda: api.Universe.load(
            ROOT / "systems" / "full_solar_system_2433282.5", device=dev))
        check(u.device.type == "cuda", f"phase 32: the Universe runs on {u.device}")
        h = u.settings.dt.as_seconds()
        span = port.Duration.from_days(MISSION_EPH_DAYS)
        n_fwd = -(-round(span.as_seconds() / h) // eph.CHUNK_STEPS)
        reset_counts()
        timed("generate_forward", lambda: u.generate(span))
        launches_fwd = read_counts()
        check(launches_fwd["gen_scan_f64"] == n_fwd and sum(launches_fwd.values()) == n_fwd,
              f"phase 32: forward generation launches {launches_fwd}, expected one of kernel "
              f"11-f64 per chunk ({n_fwd})")
        coeffs_same = None
        if mission:
            coeffs_same = all(np.array_equal(u.ephemeris[n].coeffs, mission["eph"][n].coeffs)
                              and u.ephemeris[n].start_s == mission["eph"][n].start_s
                              for n in u.names)
            check(coeffs_same, "phase 32: the session's forward coefficients are not phase 30's")

        # the Mars Transfer Ship, replanned to SESSION_UNTIL
        ship = next(x for x in u.scene.ships if x.name == "Mars Transfer Ship")
        until = port.Epoch.parse(SESSION_UNTIL)
        entry = u.spawn_ship(ship, propagate_now=False)
        u.set_plan_end(ship.name, until, replan=False)
        reset_counts()
        traj = timed("replan", lambda: u.replan(ship.name, max_knots=MISSION_KNOTS))
        launches_replan = read_counts()
        check(not any(launches_replan.values()), f"phase 32: the replan launched {launches_replan}")
        check(traj.end_s >= until.as_offset_seconds() - 1.0,
              f"phase 32: the replan stopped at {port.Epoch.from_offset_seconds(traj.end_s)}")
        n_knots = len(traj.ts)
        dist = {}
        for body, when in MISSION_EPOCHS:
            t = port.Epoch.parse(when)
            if t.as_offset_seconds() <= until.as_offset_seconds():
                dist[f"{body} {when}"] = float(
                    np.linalg.norm(traj.position(t) - u.ephemeris[body].position(t)))
        check(len(dist) == 3 and all(d < MISSION_KM for d in dist.values()),
              f"phase 32: the replanned mission missed a reference epoch: {dist}")
        knots_same = None
        if mission:
            m, k = mission["traj"], n_knots - 1
            knots_same = bool(k <= len(m.ts) and all(
                np.array_equal(a[:k], b[:k]) for a, b in
                zip((traj.ts, traj.pos, traj.vel), (m.ts, m.pos, m.vel))))
            check(knots_same, f"phase 32: the replan's first {k} knots are not phase 30's")

        # the backward span
        back = port.Duration.from_days(BACK_DAYS)
        n_bwd = -(-round(back.as_seconds() / h) // eph.CHUNK_STEPS)
        reset_counts()
        timed("generate_backward", lambda: u.extend(back, -1))
        launches_bwd = read_counts()
        check(launches_bwd["gen_scan_f64"] == n_bwd and sum(launches_bwd.values()) == n_bwd,
              f"phase 32: backward generation launches {launches_bwd}, expected {n_bwd}")
        check(u.ephemeris.start.as_offset_seconds() < u.state.epoch.as_offset_seconds(),
              "phase 32: the backward span did not land")

        # events: the card's pack and the CPU's, scanned alike
        coeff_mb = sum(u.ephemeris[n].coeffs.nbytes for n in u.names) / 2**20
        packed = timed("pack_to_card", lambda: u.ephemeris.pack(dev))
        timed("mirror_to_host", lambda: events._fetch_host_eph(packed))

        def scan(p):
            tr = events.soi_transitions(traj, p, u.soi.radii)
            return tr, events.apsides(traj, p, tr)

        tr, aps = timed("events", lambda: scan(packed))
        tr_cpu, aps_cpu = scan(u.ephemeris.pack("cpu"))
        check(tr == tr_cpu and aps == aps_cpu, "phase 32: events on the card's pack differ from "
                                               "the CPU pack's")
        names = u.names
        i_earth, i_mars = u.body_index["Earth"], u.body_index["Mars"]
        transitions = [(str(port.Epoch.from_offset_seconds(t)), names[b]) for t, b in tr]
        earth_exit = next((transitions[k + 1] for k, (_, b) in enumerate(tr[:-1])
                           if b == i_earth), None)
        mars_entry = next((transitions[k] for k, (_, b) in enumerate(tr) if b == i_mars), None)
        check(tr and tr[0][1] == i_earth and earth_exit is not None and mars_entry is not None,
              f"phase 32: no Earth SOI exit and Mars SOI entry in {transitions}")

        def apsis(a):
            return {"at": str(port.Epoch.from_offset_seconds(a.time)), "body": names[a.body],
                    "km": a.distance, "periapsis": bool(a.periapsis)}

        by_body = {}
        for a in aps:
            by_body[names[a.body]] = by_body.get(names[a.body], 0) + 1

        # edit the last burn; the replan restarts at the last common event
        last = max(entry.plan.burns.values(), key=lambda b: b.start.as_offset_seconds())
        old = (traj.ts.copy(), traj.pos.copy(), traj.vel.copy())
        old_tr, old_aps = list(entry.transitions), list(entry.apsides)
        u.edit_burn(ship.name, last.id, acceleration=last.acceleration * EDIT_FACTOR,
                    replan=False)
        t_restart = entry.plan.restart_epoch(entry.last_timeline, entry.last_method,
                                             entry.last_params, entry.trajectory, u.body_index)
        check(t_restart == last.start.as_offset_seconds(),
              f"phase 32: restart at {t_restart}, not at the edited burn's start")
        reset_counts()
        traj2 = timed("replan_incremental", lambda: u.replan(ship.name, max_knots=MISSION_KNOTS))
        launches_edit = read_counts()
        check(not any(launches_edit.values()), f"phase 32: the edit's replan launched "
                                               f"{launches_edit}")
        n_keep = int(np.count_nonzero(old[0] < t_restart))
        kept = all(np.array_equal(a[:n_keep], b[:n_keep])
                   for a, b in zip((traj2.ts, traj2.pos, traj2.vel), old))
        kept_events = ([e for e in entry.transitions if e[0] < t_restart]
                       == [e for e in old_tr if e[0] < t_restart]
                       and [a for a in entry.apsides if a.time < t_restart]
                       == [a for a in old_aps if a.time < t_restart])
        check(kept and kept_events, "phase 32: a knot or an event before the restart changed")
        check(traj2.end_s >= until.as_offset_seconds() - 1.0, "phase 32: the edited plan "
                                                              "stopped early")
        t_end = until.as_offset_seconds()
        mars_km_edited = float(
            np.linalg.norm(traj2.position(t_end) - u.ephemeris["Mars"].position(t_end)))

        # a background extension, paused and resumed, racing a reader thread
        at = port.Epoch.from_offset_seconds(u.state.epoch.as_offset_seconds() + 100 * 86400.0)
        ref = u.positions(at)
        stop = threading.Event()
        reads = {"n": 0, "worst_km": 0.0}

        def reader():
            while not stop.is_set():
                p = u.positions(at)
                reads["worst_km"] = max(reads["worst_km"], float(np.abs(p - ref).max()))
                reads["n"] += 1

        th = threading.Thread(target=reader, daemon=True)
        end_before = u.ephemeris.end.as_offset_seconds()
        reset_counts()
        th.start()
        t0 = time.perf_counter()
        task = u.extend(port.Duration.from_days(EXTEND_DAYS), background=True)
        task.pause()
        paused = task.paused
        task.resume()
        task.join(timeout=600)
        torch.cuda.synchronize()
        host_s["extend_background"] = time.perf_counter() - t0
        stop.set()
        th.join(timeout=60)
        launches_ext = read_counts()
        check(paused and not task.in_progress and task.progress == 1.0 and not th.is_alive(),
              f"phase 32: the background extension ended at {task.progress}")
        check(reads["n"] > 0 and reads["worst_km"] == 0.0,
              f"phase 32: torn read during the extension: {reads}")
        check(u.ephemeris.end.as_offset_seconds() > end_before, "phase 32: no extension landed")
        check(launches_ext["gen_scan_f64"] >= 1 and sum(launches_ext.values())
              == launches_ext["gen_scan_f64"], f"phase 32: the extension launched {launches_ext}")

        # the interpolation audit over the generated span
        t0_s = u.state.epoch.as_offset_seconds()
        audit_steps = int((u.ephemeris.end.as_offset_seconds() - t0_s) / h) - tab.order
        n_audit = -(-audit_steps // eph.CHUNK_STEPS)
        reset_counts()
        errs = timed("interpolation_error", lambda: api.interpolation_error(
            u.ephemeris, u.state, u.settings, device=dev))
        launches_audit = read_counts()
        check(launches_audit["gen_scan_f64"] == n_audit
              and sum(launches_audit.values()) == n_audit,
              f"phase 32: the audit launched {launches_audit}, expected {n_audit} of kernel 11-f64")
        worst = max(errs, key=errs.get)
        check(all(np.isfinite(v) for v in errs.values()) and errs[worst] < AUDIT_BAR_M,
              f"phase 32: interpolation error {errs[worst]} m on {worst}")
        record.setdefault("gen_scan_f64", {}).setdefault("launches_by_phase", {})["32"] = sum(
            x["gen_scan_f64"] for x in (launches_fwd, launches_bwd, launches_ext, launches_audit))
        print(json.dumps({
            "phase": 32, "path": "Universe session", "scene": "full_solar_system_2433282.5",
            "n": u.state.n, "ship": ship.name, "until": SESSION_UNTIL,
            "forward_days": MISSION_EPH_DAYS, "backward_days": BACK_DAYS,
            "launches": {"generate_forward": launches_fwd["gen_scan_f64"],
                         "generate_backward": launches_bwd["gen_scan_f64"],
                         "extend_background": launches_ext["gen_scan_f64"],
                         "interpolation_error": launches_audit["gen_scan_f64"],
                         "replans": sum(launches_replan.values()) + sum(launches_edit.values())},
            "forward_coeffs_bitwise_to_phase_30": coeffs_same,
            "knots": n_knots, "knots_but_the_last_bitwise_to_phase_30": knots_same,
            "distance_km": dist, "bar_km": MISSION_KM,
            "transitions": transitions, "earth_soi_exit": earth_exit, "mars_soi_entry": mars_entry,
            "apsides": len(aps), "apsides_by_body": by_body,
            "apsides_first_last": [apsis(a) for a in (aps[:2] + aps[-2:])],
            "events_bitwise_card_vs_cpu_pack": True,
            "coefficients_mb": coeff_mb,
            "edit": {"burn_start": str(last.start), "factor": EDIT_FACTOR,
                     "restart": str(port.Epoch.from_offset_seconds(t_restart)),
                     "knots_kept": n_keep, "knots_reflown": len(traj2.ts) - n_keep,
                     "knots": len(traj2.ts), "seconds": host_s["replan_incremental"],
                     "mars_km_at_until": mars_km_edited},
            "extend": {"days": EXTEND_DAYS, "reads": reads["n"], "worst_read_drift_km":
                       reads["worst_km"], "progress": task.progress},
            "interpolation_error_m": {"worst_body": worst, "worst_m": errs[worst],
                                      "per_body": errs, "bar_m": AUDIT_BAR_M,
                                      "route": "kernel 11-f64 (gen_scan_f64)",
                                      "steps": audit_steps, "chunks": n_audit},
            "host_s": host_s, "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    if phases != {int(p) for p in ALL_PHASES.split(",")}:
        return 0
    pallas = "ephemeris_explorer_tpu/ops/pallas_nbody.py"
    csrc = "ephemeris_explorer_tpu_torch/csrc"
    kernels = [
        {"name": name, "route": "cuda", "source": f"{csrc}/{source}", "replaces": replaces,
         **{k: record[name][k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        for name, source, replaces in (
            ("accel_df64", "accel_df64.cu", f"{pallas}:99"),
            ("accel_df64_ensemble", "accel_df64.cu", f"{pallas}:99"),
            ("accel_df64_rows", "accel_df64.cu", f"{pallas}:99"),
            ("elm2f_update", "elm2f_update.cu", "ephemeris_explorer_tpu/ops/pallas_elm2.py:310"),
            ("elm2f_update_shift", "elm2f_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:310"),
            ("accel_limbs3", "accel_limbs3.cu", f"{pallas}:383"),
            ("accel_limbs3_rows", "accel_limbs3.cu", f"{pallas}:383"),
            ("elm2q_update", "elm2q_update.cu", "ephemeris_explorer_tpu/ops/pallas_elm2.py:97"),
            ("accel_f32", "accel_f32.cu", f"{pallas}:869"),
            ("accel_mixed", "accel_mixed.cu", f"{pallas}:776"),
            ("accel_f32_masked", "accel_f32.cu", f"{pallas}:971"),
            ("strong_corr", "strong_corr.cu", f"{pallas}:1258"),
            ("strong_corr_dd", "strong_corr.cu", f"{pallas}:1171"),
            ("elm2f_update_packed", "elm2f_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:442"),
            ("elm2f_update_shift_packed", "elm2f_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:442"),
            ("elm2q_update_packed", "elm2q_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:475"),
            ("accel_sym", "accel_sym.cu", f"{pallas}:593"),
            ("gen_scan", "gen_scan.cu", "ephemeris_explorer_tpu/ops/pallas_gen.py:88"),
            ("gen_scan_f64", "gen_scan_f64.cu", "ephemeris_explorer_tpu/ops/pallas_gen.py:88"),
        )
    ]
    # kernel 11-f64's launches on each path that runs it (its main path's
    # are "launches"): phase 7 forward and backward, the session of phase 32
    kernels[-1]["launches_by_phase"] = record["gen_scan_f64"]["launches_by_phase"]
    # kernels 11 and 11-f64 run one block: bound_ms is over the whole card,
    # the kernel on one SM of SMS
    for k in kernels[-2:]:
        k["bound_one_sm_ms"] = k["bound_ms"] * SMS
        k["note"] = (f"one block on one SM: bound_ms is over the whole card, "
                     f"bound_one_sm_ms = {SMS} x bound_ms")
    print(json.dumps({"smoke_s": time.perf_counter() - t_smoke, "phases": len(phases)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
