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
  parity step ``elm2_step_qf(precise_sums=True)`` through kernel 4 and the
  3-limb route's pair force (kernel 3-f64 since slice 17; path B, phase
  10), and ``precision="extended3"`` generation of full_solar_system
  through the route's f64 force (path A, phase 11);
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
  D launch no kernel 1, only kernel 1-f64's ensemble form, each member's
  force bitwise the single-system f64 force (phase 20); the gated fused
  generation branch launches kernel 2's shift entry and no kernel 1 (phase
  6); path F's distance from native f64 on the fixed fused route beside
  kernel 1's (phase 25);
* the second half of the main path, spacecraft: 440 days of
  full_solar_system at ``"f64"`` through kernel 11-f64, then the bundled
  Mars Transfer Ship flown to 1951-01-01 by ``propagate_ship`` on the card,
  within 10,000 km of Earth and Mars at the reference's four epochs, beside
  the CPU port's flight, and the Earth Station coast on both devices
  (phase 30); fleet64, ``bench.py``'s 64 burning ships in one batch of
  ``propagate_ships``, against single-ship runs (phase 31).  Both print the
  fleet loop's iterations, host syncs and aten ops an iteration (kernel 14
  since slice 19);
* the session layer, a mission planner's session through ``api.Universe``
  on the card (phase 32): full_solar_system loaded, 440 days generated
  forward (bitwise to phase 30's coefficients) and 30 backward through
  kernel 11-f64, the Mars Transfer Ship replanned to the night after its
  Mars capture burn (bitwise to phase 30's flight up to that epoch), its SOI
  transitions and apsides (bitwise between the card's pack and the CPU's), an edit of its last burn replanned incrementally (every
  earlier knot and event kept bitwise), a background extension paused and
  resumed under a reader thread (bit-stable reads), and the interpolation
  audit re-integrating the span through kernel 11-f64; the host time of
  each step;
* the precision ladder's open rungs (slice 13): kernel 12, the tf96 pair
  force (not a TPU kernel: the JAX package's one XLA fusion), bitwise to its
  plain version on full_solar_system, sun_earth_moon, a close-pair cluster
  and on the cluster at N up to 6,457 (phase 33); ``precision="extendedF"`` over 10 days of
  full_solar_system, kernel 12 once a force evaluation, against the CPU
  port and phase 11's ``"extended3"`` state (phase 34); perturbations on
  the card: 90 days of ``"f64"`` with the Sun's 1PN term and the Earth's
  J2 through the eager loop (no kernel 11-f64, by the routing rule),
  Mercury's 1PN perihelion precession, ``"extended3"`` with 1PN through
  the 3-limb route (phase 35); the dd truth force and the CF truth stepper, card
  against CPU (phase 36); and path B judged against the compensated-state
  truth ``elm2_step_c`` (phase 10);
* the last modules (slice 14): the scale-out leftovers at one NCCL rank on
  the card, the GSPMD ensemble layout (``init_ensemble_carry``,
  ``make_sharded_ensemble_step``/``_scan`` on ``ensemble16x4096``) bitwise
  to the unsharded f64 ensemble and launching no kernel (F2), fleet64
  through ``make_sharded_fleet_propagator`` bitwise to phase 31's batch,
  and the dry run ``parallel.dryrun.dryrun_multichip`` at one NCCL rank and
  at four gloo ranks on the CPU (phase 37); the accuracy audit
  (``ephemeris_explorer_tpu_torch.audit``) of full_solar_system: 60 days
  of ``"fused"`` (the route's pair force and kernel 4) against the port's
  dd truth with ``"ref64"`` (the host) and ``"plain"`` (native f64 on the
  card, kernel 1-f64) beside it, and 2 days each of ``"expansion3"`` (the
  route) and ``"expansionF"`` (kernel 12) against the CPU port's run
  (phase 38);
* kernel 1 redesigned for the card (slice 15): kernel 1-f64, the native-f64
  pair force, bitwise to its plain version in its square form at N = 1 to
  4096 on the cluster and on full_solar_system, its rows slices and the
  members of its ensemble form (E = 16 x 4096) bitwise to the square
  form, beside kernel 1 on the same positions, both forces against the dd
  force (phase 39).  Every native-f64 force evaluation on the card goes
  through it: phases 5 (the f64 step), 6 (``"f64"`` generation at N =
  4096), 7, 30 and 32 (the startups), 20 (the f64 ensemble), 21 and 37
  (the row-sharded and GSPMD forces), 35 (perturbed ``"f64"``) and 38
  (the audit's ``plain`` mode) count one launch a force evaluation;
* kernel 2 redesigned for the card in native f64 and kernel 12 uncapped
  (slice 16): kernel 2-f64, the native-f64 ELM2 update with the ring shift
  in one launch, bitwise to its plain version on QT12 and Stormer13 at M =
  3 to 196,608, with the eager update it replaces timed beside it (phase
  40); every native-f64 step on the card is kernel 2-f64 then kernel 1-f64
  writing the new force row: phase 5 holds the f64 step at N = 4096 to two
  launches, no concatenation and no force copy, and times it beside the
  eager step in turns; phases 6, 7, 20, 35, 37 and 38 count one launch a
  step (phase 21's scans take none), phase 20 holds the f64 ensemble's
  members bitwise to the single-system steps, and phase 7 records the
  step's order-only distance from the CPU beside the eager routes'; kernel
  12 at N = 1,365, 1,366, 4,096 (shared memory past 48 KiB) and 6,457
  (global scratch), bitwise, with the pair loop read from ``cuobjdump
  -sass`` (phase 33);
* kernel 3 redesigned for the card (slice 17): kernel 3-f64, the 3-limb
  pair force in native f64, its square form (the force in f64 and as the
  pair kernel 4 consumes) bitwise to its plain version at N = 1 to 4096
  and on full_solar_system, its rows form bitwise to the square form's
  slices, beside kernel 3 on the same limbs, both forces against the dd
  force (phase 41).  Every 3-limb force on the card takes it through
  ``ops.cuda_limbs64``'s route: paths A, B, E and I and phases 35 and 38
  count its launches; phases 21 and 38 also drive their path with the route
  patched to kernel 3 (bitwise to the unsharded kernel-3 scan; 60 days of
  ``"fused"``, whose distance from the dd truth bounds the route's);
* the expansion step on the card (slice 18): kernel 13, ``elm2_step_q``'s
  update with its ring shifts in one launch, bitwise to its plain version
  at M = 3 to 12,288 on QT12 and Stormer13 in both modes, with its device
  time, bound and ptxas report; 10 days of ``"extended3"`` and 2 of
  ``"extendedF"`` through the route against the eager step on the card,
  and one step's launches and aten ops (phase 42).  Every expansion step on
  the card outside kernel 13-chunk is kernel 13 then the force writing the
  new ring row: phases 35 and 38 count one launch a scan step;
* the fleet loop on the card (slices 19-20): kernel 14, the whole loop of
  ``spacecraft.propagate_batch`` in one kernel (one block a ship: its
  warps evaluate the bodies at every stage time of an attempt at once, one
  warp runs the stages; up to ``cuda_fleet.ITERATIONS_PER_LAUNCH``
  iterations a launch), bitwise to its plain version, the eager loop, at B
  = 1, 4 and 64 on sun_earth_moon and full_solar_system for Verner87 with
  TNB burns, Verner98, DormandPrince54 and Fine45, and on a flight across
  a segment boundary, at 33, 65, 600 and 9,500 bodies (the last two past
  one window of shared memory) and at a tight tolerance, with its device time
  by CUDA events, bound and ptxas report (phase 43).  Every flight on the
  card takes it: phases 30, 31, 32 and 37 hold their flights to kernel 14
  alone, one launch a host read of the done flags;
* kernels 13 and 12 redesigned for the card (slice 21): kernel 13-chunk, a
  whole unperturbed ``"extended3"`` or ``"extendedF"`` generation chunk in
  one block (kernel 13's update, kernel 3-f64's or kernel 12's force chain,
  the emission, the rings in shared memory behind a rotating head;
  ``"extendedF"`` on a cluster of up to 8 blocks), bitwise
  to its plain version and to the two-launch route (kernel 13 then the
  force) on sun_earth_moon, full_solar_system and a cluster at its cap, for
  QT12 and Stormer13, forward and backward, precise and plain; generation
  through both routes bitwise (coefficients, carry); its device time a step
  over a 1,428-step chunk beside the route's, its bound and ptxas report
  (phase 44).  Paths A and ``"extendedF"`` take it: phases 11 and 34 hold
  each chunk to one launch, the startup's forces beside it, and run the
  same span through the two-launch route (the gate patched off) in the same
  call, bitwise; phase 42 drives the two-launch route with the gate off.

Every launch count is set to 0 just before a path is driven and read just
after.  Each phase prints one line; then the run's total seconds; the line
before the last is the kernels' JSON record (each form's launches on its
path, kernel 11-f64's and the audit's kernels' also on the other paths
that run them, error against its plain version, times, and the least time
the card could take, :func:`bound_of`) and the last line is
``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits nonzero and prints no result.
Without a CUDA device it exits nonzero at once.  It imports no JAX.

``--phases`` runs a subset (for debugging; the result lines are printed only
when all phases ran).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import tempfile
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
ALL_PHASES = ",".join(str(p) for p in range(1, 45))

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
# the fused step at depth bitwise to kernel 4's plain version plus the
# route's force (kernel 3-f64).
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
# Slice 13: the precision ladder's open rungs.  "extendedF" (the tf96 force,
# kernel 12) against "extended3" after EXT_DAYS on the carried states: the
# two forces differ at ~2^-47 of a pair force, the bar of
# test_full3_precision_generation (1 m); against the CPU port in sample
# space over the first EXTF_CPU_DAYS.  Perturbations: PERT_DAYS of "f64"
# with the Sun's 1PN term and the Earth's J2 through the eager loop,
# against the CPU port in sample space within max(FSS_BOUND, GEN_ENVELOPE x
# the same loop's own card-vs-CPU distance without perturbations): CUDA's
# f64 rsqrt and sum orders part the two devices at the ulp, which 12,960
# steps grow past FSS_BOUND (1.80e-10 perturbed, 2.07e-10 without, on an
# NVIDIA H100 80GB HBM3 at 700 W).  Its Earth displaced from the Newtonian
# run at day 25 within PN_EARTH_KM (test_pn_generation_changes_trajectory's
# bar); Mercury's 1PN perihelion precession within 10% over MERCURY_ORBITS
# whole orbits at MERCURY_H, about a year (the osculating perihelion also
# swings within an orbit, so the precession is read at the orbit's own
# phase); PERT_EXT3_DAYS of "extended3" with 1PN.  The dd truth: the CF
# stepper's day on the card against the CPU's at TRUTH_CARD_VS_CPU of
# max|y| (every dd op is one correctly rounded IEEE f64 op on both
# devices: bitwise is expected).  Path B against the compensated-state
# truth after TRUTH_STEPS, as test_fused_elm2_update_matches_unfused
# judges it.
EXTF_VS_EXT3_KM = 1e-3
EXTF_CPU_DAYS = 2.0  # the CPU port's span beside phase 34's EXT_DAYS on the card
# phase 34's seconds a step with kernel 12's plain version patched in, over
# these steps (~48 ms a step on an H100; the kernel's over a day)
PLAIN_PATCHED_STEPS = 16
PERT_DAYS = 90.0
PN_EARTH_KM = (1e-3, 100.0)
MERCURY_ORBITS = 4
MERCURY_H = 3600.0
PERT_EXT3_DAYS = 2.0
TRUTH_CARD_VS_CPU = 2.0**-90
TRUTH_STEPS = 30
TRUTH_ENVELOPE = 5.0
TRUTH_FLOOR = 2.0**-40
# Slice 4: ensembles and the row decomposition.  Path D is bench.py:379-435's
# ensemble16x4096: cluster seeds 0..15 with mu from seed 0, QT12, h = 600 s,
# in 50-step scans.  Its f64 scan (kernel 1's ensemble form, f64 in and out)
# is held to per-member native f64 after EARLY_STEPS at EARLY_BOUND, like the
# flagship step; its pair-native scan to the single-system fused step
# bitwise.  Kernel 9 is within 3e-13 per body of the f64 correction
# (test_strong_correction_df64_matches_f64's bar).
ENSEMBLE = 16
# phase 39: kernel 1-f64's square form on these N of the cluster (and on
# full_solar_system), its rows form at these N, the ensemble at E x 4096
F64_SIZES = (1, 3, 32, 255, 256, 257, 1365, 4096)
F64_ROWS_SIZES = (257, 1365, 4096)
# phase 41: kernel 3-f64's square form on these N of the cluster (and on
# full_solar_system), its rows form at these N
LIMBS64_SIZES = (1, 3, 32, 129, 1365, 4096)
LIMBS64_ROWS_SIZES = (129, 1365, 4096)
# phase 40: kernel 2-f64 at these M (3N; 12,288 the cluster, 196,608 the ensemble)
F64_UPDATE_SIZES = (3, 99, 4095, 12288, 196608)
# phase 42: kernel 13 at these M (96 full_solar_system, 1,001 ragged, 12,288
# the cluster), and the route against the eager expansion step on the card
# over EXT_DAYS of "extended3" and EXTF_CPU_DAYS of "extendedF": within
# ROUTE_VS_EAGER_KM of each other on the carried states (bitwise expected
# in the precise mode, the default of every extended precision)
ELM2QS_SIZES = (3, 96, 1001, 12288)
ROUTE_VS_EAGER_KM = 1e-6
# phase 44: kernel 13-chunk against its plain version over GENQ_PLAIN_STEPS
# and against the two-launch route (kernel 13 then the force) over
# GENQ_CASE_STEPS, on these scenes and on a seeded cluster at
# cuda_genq.MAX_BODIES_Q bodies; generation through both routes over
# GENQ_ROUTE_STEPS of full_solar_system (coefficients bitwise); its device
# time a step over a GENQ_TIMED_STEPS chunk (path A's 10 days less the
# startup) beside the route's
GENQ_SCENES = ("sun_earth_moon_2433282.5", "full_solar_system_2433282.5")
GENQ_PLAIN_STEPS = 4
GENQ_CASE_STEPS = 96
GENQ_ROUTE_STEPS = 288
GENQ_TIMED_STEPS = 1428
GENQ_BOUND_STEPS = 4
# phase 33: kernel 12 on the cluster at these N (F4: it was capped at 1,365)
FULL3_SIZES = (1365, 1366, 4096, 6457)
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
# Slice 14: the scale-out leftovers and the accuracy audit.  Phase 37 runs
# the GSPMD ensemble layout at one NCCL rank on ensemble16x4096:
# init_ensemble_carry and SHARD_STEPS steps of make_sharded_ensemble_scan
# (and one of make_sharded_ensemble_step), bitwise to
# init_fused_ensemble_carry and make_fused_ensemble_scan (one rank over
# "model" is nbody.pairwise_accel member by member on both sides), no kernel
# launched (F2); fleet64 through make_sharded_fleet_propagator, bitwise to
# phase 31's propagate_ships; then the dry run at one NCCL rank and at
# DRYRUN_GLOO gloo ranks on the CPU.  Phase 38 is the audit of
# full_solar_system (ephemeris_explorer_tpu_torch.audit): AUDIT_STEPS (60
# days) of "fused" (the 3-limb route and kernel 4) against the dd truth, within
# AUDIT_ALL_KM for all bodies and AUDIT_PLANETS_KM for the planets, with
# "ref64" between REF64_KM (the bars of tests/test_accuracy_gate.py);
# AUDIT_SHORT_STEPS (2 days) of "expansion3" (the route) and "expansionF"
# (kernel 12), each against the CPU port's run of the same mode within
# AUDIT_CARD_VS_CPU[mode] of max |y|: "expansionF" bitwise (kernel 12 is
# bitwise to its plain version), "expansion3" a few times the 1.37e-17 read
# on the card when kernel 3 ran it (within 1e-13 of its plain version, not
# bitwise); the card now runs kernel 3-f64 and the CPU kernel 3's plain
# version, whose two plain versions part by 1.37e-17 after 288 steps too.
SHARD_STEPS = 4
DRYRUN_GLOO = 4
AUDIT_STEPS = 8640
AUDIT_SHORT_STEPS = 288
AUDIT_ALL_KM = 0.010
AUDIT_PLANETS_KM = 0.001
REF64_KM = (0.010, 1.0)
AUDIT_CARD_VS_CPU = {"expansion3": 1e-15, "expansionF": 0.0}
# the 3-limb force's route stays on kernel 3-f64 only if fused through it is
# no farther from the dd truth after AUDIT_STEPS than through kernel 3 in the
# same call, within this on the worst body (both runs are deterministic)
AUDIT_ROUTE_KM = 1e-6
# aten ops that only make a view or a host scalar: no device launch
VIEW_OPS = frozenset({"aten::view", "aten::_unsafe_view", "aten::unsqueeze", "aten::squeeze",
                      "aten::select", "aten::slice", "aten::expand", "aten::as_strided",
                      "aten::t", "aten::transpose", "aten::permute", "aten::alias",
                      "aten::detach", "aten::lift_fresh", "aten::scalar_tensor",
                      "aten::_local_scalar_dense", "aten::is_nonzero"})
# Kernel 14 (phase 43), the fleet loop against its plain version, the eager
# loop, on the card: ships in low Earth orbits near the Earth Station's (7,000
# km) on sun_earth_moon and full_solar_system, B of FLEET43_SIZES a batch,
# FLEET43_SPAN_S each (+0, 5 or 10%), two 300 s burns a ship.  Each tableau
# family flies with the burns that choose its RHS's form: TNB burns about
# Earth on every ship (Verner87, the mission's and fleet64's form), inertial
# burns on the odd ships, a coast, TNB burns on the odd ships (Fine45:
# ERKNG and FSAL).  Every knot, count, reason and final segment bitwise.
FLEET43_CASES = {"Verner87": "relative", "Verner98": "inertial", "DormandPrince54": "coast",
                 "Fine45": "relative_odd"}
FLEET43_SIZES = (1, 4, 64)
FLEET43_SPAN_S = 6 * 3600.0
FLEET43_EPH_DAYS = 40.0
FLEET43_KNOTS = 1024
# PR 20's cases beside them: a flight across the Moon's first segment
# boundary on sun_earth_moon (a TNB burn ending exactly on it, so stage times
# fall on it), 33, 65 and 600 bodies (sun_earth_moon and dust: copies of its
# bodies' tables at FLEET43_DUST_MU of their mu; past ~9,400 positions a
# block's shared memory holds, 600 bodies at 16 stages run in windows of
# stages and 9,500 in one stage's chunks of bodies), and a tight tolerance
# with a slow shrink (most attempts fail).
FLEET43_BODIES = (33, 65, 600, 9500)
FLEET43_DUST_MU = 1e-9
FLEET43_TIGHT = {"h_init": 600.0, "tol_pos": 1e-10, "tol_vel": 1e-10, "fac_min": 0.98}
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


def _sass_loop(build, kernel: str, marker: str) -> dict:
    """The innermost loop of ``kernel``'s instances holding ``marker`` (an
    opcode) in ``cuobjdump -sass`` of the built library: its instructions
    by opcode, and the longest chain of dependent f32 adds and multiplies
    along its fall-through path, by a walk of the registers each
    instruction reads and writes (other instructions pass a chain on
    without adding to it).  Null fields if the toolkit has no cuobjdump."""
    try:
        return _sass_loop_of(build, kernel, marker)
    except Exception as exc:  # a reading for the record, not a check
        return {"kernel": kernel, "error": repr(exc)[:300]}


@functools.lru_cache(maxsize=None)
def _sass_text(tool: str, lib_path: str) -> str:
    """``cuobjdump -sass`` of the built library, read once a run (~20 s on
    the card's host): phases 33 and 41 both read it."""
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


def _sass_loop_of(build, kernel: str, marker: str) -> dict:
    import os

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = Path(home) / "bin" / "cuobjdump"
    lib_path = build.BUILD_ROOT / build._source_hash()[:16] / build.LIB_NAME
    if not tool.exists():
        return {"kernel": kernel, "error": f"no {tool}"}
    sass = _sass_text(str(tool), str(lib_path))
    funcs = re.split(r"\n\s*Function : ", sass)
    results = []
    for body in funcs[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        insts, labels = [], {}
        for line in body.splitlines():
            lab = re.match(r"^\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(insts)
                continue
            m = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                insts.append((int(m.group(1), 16), m.group(2)))
        addr_at = {a: i for i, (a, _) in enumerate(insts)}
        loops = []
        for i, (_, text) in enumerate(insts):
            if " BRA " not in f" {text} " and not text.startswith("BRA"):
                continue
            tgt = re.search(r"`\((\.L_x_\d+)\)", text)
            j = labels.get(tgt.group(1)) if tgt else None
            if j is None:
                hexa = re.search(r"0x([0-9a-f]+)\s*$", text)
                j = addr_at.get(int(hexa.group(1), 16)) if hexa else None
            if j is not None and j <= i and any(marker in t for _, t in insts[j:i + 1]):
                loops.append((i - j, j, i))
        if not loops:
            continue
        _, j, i = min(loops)
        ops, depth, chain = {}, {}, 0
        for _, text in insts[j:i + 1]:
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", text)
            op, _, rest = text.partition(" ")
            ops[op] = ops.get(op, 0) + 1
            args = [a.strip() for a in rest.split(",")] if rest else []
            regs = [re.findall(r"\b(U?R\d+|U?P\d)\b", a) for a in args]
            base = op.split(".")[0]
            writes = bool(args) and not base.startswith(("ST", "BRA", "BAR", "EXIT", "RED",
                                                         "CALL", "RET", "BSSY", "BSYNC"))
            writes = writes and not args[0].startswith("[")
            n_dst = 1
            while writes and n_dst < len(args) and re.fullmatch(r"U?P[T0-9]", args[n_dst]):
                n_dst += 1
            dst = [r for a in (regs[:n_dst] if writes else []) for r in a]
            src = [r for a in (regs[n_dst:] if writes else regs) for r in a]
            d = max((depth.get(r, 0) for r in src), default=0)
            d += base in ("FADD", "FMUL", "FFMA")
            for r in dst:
                depth[r] = d
            chain = max(chain, d)
        results.append({"function": name[:120], "loop_instructions": i - j + 1,
                        "f32_add_mul": sum(v for k, v in ops.items()
                                           if k.split(".")[0] in ("FADD", "FMUL", "FFMA")),
                        "ffma": sum(v for k, v in ops.items() if k.startswith("FFMA")),
                        "dependent_f32_add_mul": chain,
                        "top_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])})
    return {"kernel": kernel, "loops": results}


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


def _with_dust(packed, n_bodies: int):
    """``packed`` with bodies added up to ``n_bodies``: copies of its
    bodies' tables (the same coefficient rows) at FLEET43_DUST_MU of their
    mu, so that ships fly as they would and every lane holds several
    bodies."""
    import torch

    from ephemeris_explorer_tpu_torch.ephemeris import PackedEphemeris

    n = packed.mus.shape[0]
    idx = torch.arange(n_bodies - n, device=packed.mus.device) % n
    return PackedEphemeris(
        mus=torch.cat([packed.mus, packed.mus[idx] * FLEET43_DUST_MU]),
        **{k: torch.cat([getattr(packed, k), getattr(packed, k)[idx]])
           for k in ("starts", "intervals", "offsets", "nsegs")},
        coeffs=packed.coeffs)


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
    from ephemeris_explorer_tpu_torch.ops import cuda_elm2f64, cuda_elm2qs, cuda_limbs64, cuda_nbody64
    from ephemeris_explorer_tpu_torch.ops import cuda_fleet, cuda_genq
    from ephemeris_explorer_tpu_torch.ops import cuda_f32, cuda_gen, cuda_mixed, cuda_split
    from ephemeris_explorer_tpu_torch.ops import cuda_sym, nbody_full3, split
    from ephemeris_explorer_tpu_torch.ops import perturbations as perts
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
                 "accel_f64": cuda_nbody64.pairwise_accel_f64,
                 "accel_f64_rows": cuda_nbody64.pairwise_accel_f64_rows,
                 "accel_f64_ensemble": cuda_nbody64.pairwise_accel_f64_ensemble,
                 "accel_limbs3_rows": cuda_limbs.pairwise_accel_limbs_pair_rows,
                 "accel_limbs3_f64": cuda_limbs64.pairwise_accel_limbs64,
                 "accel_limbs3_f64_pair": cuda_limbs64.pairwise_accel_limbs64_pair,
                 "accel_limbs3_f64_rows": cuda_limbs64.pairwise_accel_limbs64_rows,
                 "strong_corr_dd": cuda_split.strong_correction_dd,
                 "elm2f_update_packed": cuda_elm2.elm2f_update_packed,
                 "elm2f_update_shift_packed": cuda_elm2.elm2f_update_shift_packed,
                 "elm2q_update_packed": cuda_elm2q.elm2q_update_packed,
                 "accel_sym": cuda_sym.pairwise_accel_df64_sym,
                 "gen_scan": cuda_gen.elm2_gen_scan,
                 "gen_scan_f64": cuda_gen.elm2_gen_scan_f64,
                 "accel_full3": nbody_full3.pairwise_accel_full3,
                 "elm2f64_update_shift": cuda_elm2f64.elm2f64_update_shift,
                 "elm2q_update_shift": cuda_elm2qs.elm2q_update_shift,
                 "fleet_scan": cuda_fleet.fleet_scan,
                 "gen_scan_q": cuda_genq.elm2_gen_scan_q}

    def reset_counts():
        for fn in launchers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in launchers.items()}

    # kernel 1-f64's forms and the ops.nbody entries that launch them on the card
    f64_forms = {"accel_f64": "pairwise_accel", "accel_f64_rows": "pairwise_accel_rows",
                 "accel_f64_ensemble": "pairwise_accel_ensemble"}

    class F64Evals:
        """Counts the native-f64 force evaluations on the card of a block by
        entry (``ops.nbody``'s three, patched for the block; calls on CPU
        tensors are not counted): the evaluations that each launch kernel
        1-f64 once; and the native-f64 steps on the card
        (``multistep._step_shift``, patched for the block), each of which
        launches kernel 2-f64 once."""

        def __enter__(self):
            self.calls = {name: 0 for name in f64_forms.values()}
            self.orig = {name: getattr(nbody, name) for name in self.calls}
            self.steps = 0
            self.orig_step = ms._step_shift

            def step(*args, **kwargs):
                self.steps += 1
                return self.orig_step(*args, **kwargs)

            ms._step_shift = step

            def counted(name, fn):
                def call(*args, **kwargs):
                    self.calls[name] += args[0].device.type == "cuda"
                    return fn(*args, **kwargs)
                return call

            for name, fn in self.orig.items():
                setattr(nbody, name, counted(name, fn))
            return self

        def __exit__(self, *exc):
            for name, fn in self.orig.items():
                setattr(nbody, name, fn)
            ms._step_shift = self.orig_step

        def matches(self, launches) -> bool:
            """Kernel 1-f64 launched once a native-f64 force evaluation, in
            the form of the entry that evaluated it, and kernel 2-f64 once a
            native-f64 step."""
            return (all(launches[k] == self.calls[name] for k, name in f64_forms.items())
                    and launches["elm2f64_update_shift"] == self.steps)

    class QSteps:
        """Counts the expansion-state steps on the card of a block
        (``multistep._step_q_shift``, patched for the block), each of which
        launches kernel 13 once."""

        def __enter__(self):
            self.steps = 0
            self.orig = ms._step_q_shift

            def step(*args, **kwargs):
                self.steps += 1
                return self.orig(*args, **kwargs)

            ms._step_q_shift = step
            return self

        def __exit__(self, *exc):
            ms._step_q_shift = self.orig

    class GenQCalls:
        """Counts the chunks of a block that take kernel 13-chunk's branch:
        the answers True of its gate ``eph._use_gen_kernel_q`` (patched for
        the block; ``_chunk_fn`` asks it only of an unperturbed extended
        chunk with steps to run), each of which launches the kernel once."""

        def __enter__(self):
            self.chunks = 0
            self.orig = eph._use_gen_kernel_q

            def gate(*args):
                taken = self.orig(*args)
                self.chunks += taken
                return taken

            eph._use_gen_kernel_q = gate
            return self

        def __exit__(self, *exc):
            eph._use_gen_kernel_q = self.orig

    @contextlib.contextmanager
    def genq_gate_off():
        """The two-launch route for a block: ``eph._use_gen_kernel_q``
        patched off, so every expansion chunk steps through kernel 13 and
        the force, the route before kernel 13-chunk."""
        gate = eph._use_gen_kernel_q
        eph._use_gen_kernel_q = lambda *a: False
        try:
            yield
        finally:
            eph._use_gen_kernel_q = gate

    def force_evals(steps):
        """Force evaluations of a generation of `steps` steps: the FSAL
        starter's (one at the start, then one a stage after the first), then
        one a scan step."""
        starter = get(tab.starter)
        return 1 + tab.order * tab.substeps * (starter.stages - 1) + steps - tab.order

    def fleet_only(launches, syncs: int) -> bool:
        """Kernel 14 alone launched, once a host read of the done flags (the
        fleet loop's syncs), and at least once."""
        return launches["fleet_scan"] == syncs == sum(launches.values()) and syncs > 0

    def but_f64(launches) -> int:
        """Launches of every kernel but the native-f64 step's: kernel 1-f64's
        forms and kernel 2-f64."""
        return sum(v for k, v in launches.items()
                   if k not in f64_forms and k != "elm2f64_update_shift")

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
        check((lib.eet_accel_f64_tile(), lib.eet_accel_f64_recv())
              == (cuda_nbody64.F64_PAIR_TILE, cuda_nbody64.F64_PAIR_RECV),
              "kernel 1-f64 was built for another tile or receiver block than "
              "cuda_nbody64._geometry partitions")
        check((lib.eet_accel_limbs3_f64_tile(), lib.eet_accel_limbs3_f64_recv())
              == (cuda_nbody64.F64_PAIR_TILE, cuda_nbody64.F64_PAIR_RECV),
              "kernel 3-f64 was built for another tile or receiver block than "
              "cuda_nbody64._geometry partitions")
        check((lib.eet_gen_scan_q_max_bodies(), lib.eet_gen_scan_q_src_tile())
              == (cuda_genq.MAX_BODIES_Q, cuda_nbody64.F64_PAIR_TILE),
              "kernel 13-chunk was built for another body cap than cuda_genq.MAX_BODIES_Q or "
              "another split tile than cuda_nbody64._geometry partitions")
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
        def accel64(t, y, out=None):
            """The native-f64 force writing the step's new ring row."""
            return nbody.pairwise_accel(y, mu_dev, out=out)

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
            """The native-f64 step: kernel 2-f64, kernel 1-f64 writing the
            new ring row."""
            return ms.elm2_step(tab, accel64, H, c, with_velocity=False)

        def eager_step(c):
            """The native-f64 step before kernel 2-f64: the eager update and
            the two ring concatenations, kernel 1-f64's force copied in."""
            return ms._step_cat(tab, accel, H, c, False)

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
        run(eager_step, carry0, 2)
        torch.cuda.synchronize()

        def timed(step):
            t0 = time.perf_counter()
            c, y_early = run(step, carry0, FLAGSHIP_STEPS)
            c = c._replace(dy=ms.elm2_velocity(tab, c, H))
            torch.cuda.synchronize()
            return c, y_early, time.perf_counter() - t0

        # the native-f64 step and the step before kernel 2-f64, in turns
        ce, ye_early, t_eager = timed(eager_step)
        reset_counts()
        with F64Evals() as evals_plain:
            cp, yp_early, t_plain = timed(plain_step)
        launches_plain = read_counts()
        cp2, _, t_plain2 = timed(plain_step)
        reset_counts()
        _, _, t_eager2 = timed(eager_step)
        launches_eager = read_counts()
        # the native-f64 step: kernel 2-f64 and kernel 1-f64's square form
        # once each a step, nothing else
        check(launches_plain["accel_f64"] == FLAGSHIP_STEPS
              and launches_plain["elm2f64_update_shift"] == FLAGSHIP_STEPS
              and evals_plain.matches(launches_plain)
              and sum(launches_plain.values()) == 2 * FLAGSHIP_STEPS,
              f"the native-f64 step did not run through kernels 2-f64 and 1-f64 once each a "
              f"step: {launches_plain}")
        check(launches_eager["accel_f64"] == FLAGSHIP_STEPS
              and sum(launches_eager.values()) == FLAGSHIP_STEPS,
              f"the step before kernel 2-f64: launches {launches_eager}")
        check(all(torch.equal(a, b) for a, b in zip(cp[1:], cp2[1:])),
              "the native-f64 step is not bitwise to itself")
        # the two steps sum in other orders: held where the cluster has not
        # yet amplified rounding, as the fused step is
        early64 = (yp_early - ye_early).abs().max().item() / ye_early.abs().max().item()
        check(early64 <= EARLY_BOUND, f"the native-f64 step vs the eager one after "
                                      f"{EARLY_STEPS} steps: {early64}")
        ops_f64, ops_eager = step_ops(plain_step, carry0), step_ops(eager_step, carry0)
        check("aten::cat" not in ops_f64 and "aten::copy_" not in ops_f64
              and ops_eager.get("aten::cat") == 2,
              f"the native-f64 step's aten ops {ops_f64}, the eager step's {ops_eager}")
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
            "plain_f64_ms_per_step": [t / FLAGSHIP_STEPS * 1e3 for t in (t_plain, t_plain2)],
            "plain_f64_launches": {k: v for k, v in launches_plain.items() if v},
            "plain_f64_aten_ops_per_step": ops_f64,
            "eager_f64": {"ms_per_step": [t / FLAGSHIP_STEPS * 1e3 for t in (t_eager, t_eager2)],
                          "body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / min(t_eager, t_eager2),
                          "launches": {k: v for k, v in launches_eager.items() if v},
                          "aten_ops_per_step": ops_eager,
                          f"rel_pos_diff_after_{EARLY_STEPS}": early64},
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
        record.setdefault("accel_f64", {}).setdefault("launches_by_phase", {})["5"] = (
            launches_plain["accel_f64"])
        record.setdefault("elm2f64_update_shift", {})["launches"] = (
            launches_plain["elm2f64_update_shift"])
        record["elm2f64_update_shift"].setdefault("launches_by_phase", {})["5"] = (
            launches_plain["elm2f64_update_shift"])

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
        with F64Evals() as evals_plain:
            t0 = time.perf_counter()
            e_plain = generate()
            t_plain = time.perf_counter() - t0
        launches_plain = read_counts()
        # no kernel 1, 2 or 11 (F1): kernel 1-f64's square form once a force
        # evaluation, the startup's included, and kernel 2-f64 once a step
        check(launches_plain["accel_f64"] == evals_plain.calls["pairwise_accel"] > GEN_STEPS
              and evals_plain.matches(launches_plain) and but_f64(launches_plain) == 0,
              f"default f64 generation at N=4096: launches {launches_plain}, expected kernel "
              f"1-f64 alone, once a force evaluation ({evals_plain.calls})")
        record.setdefault("accel_f64", {})["launches"] = launches_plain["accel_f64"]
        record["accel_f64"].setdefault("launches_by_phase", {})["6"] = launches_plain["accel_f64"]
        record.setdefault("elm2f64_update_shift", {}).setdefault("launches_by_phase", {})["6"] = (
            launches_plain["elm2f64_update_shift"])

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
            "default_route_launches": {k: v for k, v in launches_plain.items() if v},
            "default_route_force_evals": evals_plain.calls["pairwise_accel"],
            "default_route_steps": evals_plain.steps,
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
        with F64Evals() as evals_y:
            e_gpu, t_year = generate_year()
        launches_y = read_counts()
        # one kernel 11-f64 launch a chunk; the startup's force evaluations
        # through kernel 1-f64
        check(launches_y["gen_scan_f64"] == n_chunks and but_f64(launches_y) == n_chunks
              and evals_y.matches(launches_y),
              f"phase 7: launches {launches_y}, expected one of kernel 11-f64 per chunk "
              f"({n_chunks}) and kernel 1-f64 once a startup force evaluation "
              f"({evals_y.calls})")
        # the native-f64 step loop beside it, kernel 11-f64's gate patched
        # off: its force kernel 1-f64, once an evaluation, its update kernel
        # 2-f64, once a step
        gate = eph._use_gen_kernel_f64
        eph._use_gen_kernel_f64 = lambda n, d: False
        try:
            reset_counts()
            with F64Evals() as evals_e:
                e_eager, t_eager = generate_year()
            launches_e = read_counts()
        finally:
            eph._use_gen_kernel_f64 = gate
        check(but_f64(launches_e) == 0 and evals_e.matches(launches_e)
              and launches_e["accel_f64"] > GEN_YEAR_STEPS,
              f"phase 7 eager route: launches {launches_e}, expected kernels 1-f64 and 2-f64 "
              f"alone, once a force evaluation ({evals_e.calls}) and a step ({evals_e.steps})")
        record.setdefault("accel_f64", {}).setdefault("launches_by_phase", {}).update(
            {"7_startup": launches_y["accel_f64"], "7_eager_year": launches_e["accel_f64"]})
        record.setdefault("elm2f64_update_shift", {}).setdefault("launches_by_phase", {})[
            "7_eager_year"] = launches_e["elm2f64_update_shift"]
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
        # (made on the CPU), kernel 11-f64, the CUDA step loop (kernels 2-f64
        # and 1-f64), the eager step with kernel 1-f64's force (the route
        # before kernel 2-f64) and the eager step with torch's eager force
        # (the route before kernel 1-f64: torch's CUDA sum orders) against
        # the CPU's eager loop, all native f64.  The bar holds kernel 11-f64
        # and the step loop to the torch-order loop's distance, as before
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
        c_t = c_1 = c_g
        for _ in range(steps):
            c_g = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_g), h, c_g,
                               with_velocity=False)
            c_1 = ms._step_cat(tab, lambda t, y: nbody.pairwise_accel(y, mu_g), h, c_1, False)
            c_t = ms._step_cat(tab, lambda t, y: nbody._pairwise_accel_rows_eager(y, y, 0, mu_g),
                               h, c_t, False)
            c_c = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_c), h, c_c,
                               with_velocity=False)
        y_cpu = c_c.ys[0]
        d_k, d_e = c_k.ys[0].to(cpu) - y_cpu, c_g.ys[0].to(cpu) - y_cpu
        d_t, d_1 = c_t.ys[0].to(cpu) - y_cpu, c_1.ys[0].to(cpu) - y_cpu
        km_k, km_e = d_k.norm(dim=1).max().item(), d_e.norm(dim=1).max().item()
        km_t, km_1 = d_t.norm(dim=1).max().item(), d_1.norm(dim=1).max().item()
        env = max(GEN_ENVELOPE * km_t, GEN_FLOOR * y_cpu.abs().max().item())
        check(km_k <= env, f"phase 7 after {steps} steps: kernel 11-f64 {km_k} km from the CPU, "
                           f"> {env} km (eager CUDA, torch's order, {km_t} km)")
        check(km_e <= env, f"phase 7 after {steps} steps: the step loop through kernels 2-f64 "
                           f"and 1-f64 {km_e} km from the CPU, > {env} km (torch's order {km_t} "
                           "km)")

        # backward generation through kernel 11-f64 (h < 0), one launch a
        # chunk, against the CPU's eager loop in sample space (the backward
        # fit matrices) at the forward year's bar
        back = port.Duration.from_days(BACK_DAYS)
        n_chunks_b = -(-round(back.as_seconds() / h) // eph.CHUNK_STEPS)
        reset_counts()
        with F64Evals() as evals_b:
            t0 = time.perf_counter()
            e_back = eph.generate_ephemeris(fss.state, fss.settings, back, direction=-1,
                                            device=dev)
            torch.cuda.synchronize()
            t_back = time.perf_counter() - t0
        launches_b = read_counts()
        check(launches_b["gen_scan_f64"] == n_chunks_b and but_f64(launches_b) == n_chunks_b
              and evals_b.matches(launches_b),
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
            f"eager_torch_order_km_vs_cpu_after_{steps}": km_t,
            f"eager_update_kernel1_f64_km_vs_cpu_after_{steps}": km_1,
            "ratio_to_eager": km_k / km_e if km_e else None,
            "ratio_to_torch_order": km_k / km_t if km_t else None, "envelope_km": env,
            "worst_bodies_km": _worst_bodies(d_k, fss),
            "eager_worst_bodies_km": _worst_bodies(d_e, fss),
            "backward": {"sim_days": BACK_DAYS, "chunks": n_chunks_b, "launches": launches_b,
                         "generation_s": t_back, "coeff_err_vs_cpu": err_b, "bound": FSS_BOUND},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- the expansion-state engine (kernels 3 and 4) ------------------------
    fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")

    def limb_forces(mu64):
        """(accel_limbs, accel_pair) through the 3-limb force's route
        (``cuda_limbs64.limbs_force_pair``: kernel 3-f64 on the card) for
        (N,) f64 mu; accel_limbs is the pair combined, so the fused and the
        unfused step see the same force."""
        mh, ml = cuda_nbody.split_f64(mu64.reshape(1, -1))
        mu_n = mu64.reshape(-1)

        def accel_pair(t, limbs):
            return cuda_limbs64.limbs_force_pair(*limbs, mu_n, mh, ml)

        def accel_limbs(t, limbs):
            return cuda_nbody.combine_f64(*accel_pair(t, limbs))

        return accel_limbs, accel_pair

    @contextlib.contextmanager
    def kernel3_route():
        """The 3-limb force's route patched, for a block, to kernel 3 (the
        two-float kernel it took before kernel 3-f64), to drive a path
        through both forces in one call."""
        orig = {n: getattr(cuda_limbs64, n)
                for n in ("limbs_force", "limbs_force_pair", "limbs_force_pair_rows")}
        cuda_limbs64.limbs_force = (
            lambda l0, l1, l2, mu, mh, ml: cuda_limbs.pairwise_accel_limbs(l0, l1, l2, mh, ml))
        cuda_limbs64.limbs_force_pair = (
            lambda l0, l1, l2, mu, mh, ml: cuda_limbs.pairwise_accel_limbs_pair(l0, l1, l2, mh,
                                                                                ml))
        cuda_limbs64.limbs_force_pair_rows = (
            lambda p0, p1, p2, mu, mh, ml, r0, r1, r2, row0:
            cuda_limbs.pairwise_accel_limbs_pair_rows(p0, p1, p2, mh, ml, r0, r1, r2, row0))
        try:
            yield
        finally:
            for n, fn in orig.items():
                setattr(cuda_limbs64, n, fn)

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

    # expansion-state startups (the 3-limb route for every force), shared by
    # 9, 10, 22 and 28
    if phases & {9, 10, 22, 28}:
        cl_limbs, cl_pair = limb_forces(mu_dev)

        def kernel1_accel(t, y):
            return cuda_nbody.pairwise_accel(y, mu_hi, mu_lo)

        def init_cluster():
            """bench.py:bench_parity's startup: elm2_init_q with the kernel-1
            drop-in as `accel` and the 3-limb route as `accel_limbs` (which
            then carries every startup force)."""
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
        check(launches_b["accel_limbs3_f64_pair"] > 0 and launches_b["elm2q_update"] > 0
              and launches_b["accel_limbs3"] == 0,
              f"path B did not launch kernels 3-f64 and 4 (and not kernel 3): {launches_b}")
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
        # the fused step at depth: kernel 4's plain version, then the route's force
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
        check(composed, f"path B step {EARLY_STEPS + 1} is not kernel 4's plain version + "
                        f"kernel 3-f64")
        check(shadow <= SHADOW_FACTOR, f"path B fused run does not shadow the unfused: {shadow}")
        # both engines judged against the compensated-state truth (the
        # two-float state on the f64 force, elm2_step_c) after TRUTH_STEPS
        def f64_accel(t, y):
            return nbody.pairwise_accel(y, mu_dev)

        c_t = ms.elm2_init_c(tab, f64_accel, 0.0, torch.as_tensor(pos, dtype=f64, device=dev),
                             torch.as_tensor(vel, dtype=f64, device=dev), H)
        for _ in range(TRUTH_STEPS):
            c_t = ms.elm2_step_c(tab, f64_accel, H, c_t)
        truth = c_t.ys.hi[0] + c_t.ys.lo[0]
        err_q = (exp_head(run(unfused_step, q0, TRUTH_STEPS)[0].ys) - truth).abs().max().item()
        err_f = (exp_head(run(fused_step, qf0, TRUTH_STEPS)[0].ys) - truth).abs().max().item()
        truth_floor = TRUTH_FLOOR * truth.abs().max().item()
        check(err_f <= max(TRUTH_ENVELOPE * err_q, truth_floor),
              f"path B against the C truth: {err_f} km, unfused {err_q}, floor {truth_floor}")
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
            f"km_vs_c_truth_after_{TRUTH_STEPS}": {"fused": err_f, "unfused": err_q,
                                                   "floor": truth_floor,
                                                   "envelope": TRUTH_ENVELOPE},
            "fused_qf_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_fused,
            "unfused_q_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_unfused,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))
        for k in ("accel_limbs3_f64_pair", "elm2q_update"):
            record.setdefault(k, {})["launches"] = launches_b[k]

    # -- phase 11: path A, "extended3" generation of full_solar_system --------
    ext_heads = {}  # phase 11's carried "extended3" state after EXT_DAYS, for phase 34
    if 11 in phases:
        t_phase = time.perf_counter()
        span = port.Duration.from_days(EXT_DAYS)

        def generate(precision, device):
            e = eph.generate_ephemeris(fss.state, fss.settings, span, precision=precision,
                                       device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return e

        for route in ("chunk", "two_launch"):  # warm-up
            with genq_gate_off() if route == "two_launch" else contextlib.nullcontext():
                eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(1),
                                       precision="extended3", device=dev)
        torch.cuda.synchronize()
        reset_counts()
        with QSteps() as qs_a, GenQCalls() as gq_a:
            t0 = time.perf_counter()
            e_gpu = generate("extended3", dev)
            t_gpu = time.perf_counter() - t0
        launches_a = read_counts()
        startup_evals = force_evals(tab.order)
        check(launches_a["accel_limbs3_f64"] > 0 and launches_a["accel_limbs3"] == 0
              and launches_a["elm2q_update"] == 0,
              f"path A must run kernel 3-f64, and neither kernel 3 nor kernel 4: {launches_a}")
        # kernel 13-chunk once a chunk; kernel 3-f64 only in the startup; no
        # kernel 13 in the scan
        check(gq_a.chunks > 0 and launches_a["gen_scan_q"] == gq_a.chunks and qs_a.steps == 0
              and launches_a["elm2q_update_shift"] == 0
              and launches_a["accel_limbs3_f64"] == startup_evals
              and sum(launches_a.values()) == startup_evals + gq_a.chunks,
              f"path A: kernel 13-chunk once a chunk ({gq_a.chunks}) and kernel 3-f64 only in "
              f"the startup ({startup_evals}): {launches_a}")
        record.setdefault("accel_limbs3_f64", {})["launches"] = launches_a["accel_limbs3_f64"]
        record.setdefault("gen_scan_q", {})["launches"] = launches_a["gen_scan_q"]
        # the same span through the two-launch route (kernel 13 then kernel
        # 3-f64 a scan step), the route before kernel 13-chunk, then the chunk
        # kernel again: bitwise, and the rates of both in one call
        reset_counts()
        with genq_gate_off(), QSteps() as qs_r:
            t0 = time.perf_counter()
            e_route = generate("extended3", dev)
            t_route = time.perf_counter() - t0
        launches_r = read_counts()
        check(launches_r["gen_scan_q"] == 0 and launches_r["elm2q_update_shift"] == qs_r.steps > 0,
              f"path A through the two-launch route: kernel 13 once a scan step: {launches_r}")
        record.setdefault("elm2q_update_shift", {}).setdefault("launches_by_phase", {})[
            "11_two_launch"] = launches_r["elm2q_update_shift"]
        t0 = time.perf_counter()
        generate("extended3", dev)
        t_gpu_again = time.perf_counter() - t0
        same_route = all(np.array_equal(e_gpu[n].coeffs, e_route[n].coeffs) for n in e_gpu.names)
        check(same_route, "path A through kernel 13-chunk is not bitwise to the two-launch route")
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
        ext_heads["extended3"] = heads["extended3"]
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
            "bodies_fitted": len(fitted), "launches": launches_a, "chunks": gq_a.chunks,
            "sim_days_per_s": EXT_DAYS / t_gpu, "sim_days_per_s_again": EXT_DAYS / t_gpu_again,
            "two_launch_route": {"sim_days_per_s": EXT_DAYS / t_route, "scan_steps": qs_r.steps,
                                 "launches": {k: v for k, v in launches_r.items() if v},
                                 "coefficients_bitwise": same_route},
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
            # the f64 startup takes the native-f64 force, kernel 1-f64's
            # ensemble form (F2)
            reset_counts()
            with F64Evals() as evals_s:
                t0 = time.perf_counter()
                ens_cache["carry0"] = sh.init_fused_ensemble_carry(tab, mu, 0.0, ens_pos, ens_vel,
                                                                   H, device=dev)
                torch.cuda.synchronize()
                ens_cache["startup_s"] = time.perf_counter() - t0
            ens_cache["startup_launches"] = read_counts()
            ens_cache["startup_evals"] = evals_s.calls
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
        sl = start["startup_launches"]
        check(but_f64(sl) == 0 and sl["accel_f64_ensemble"]
              == start["startup_evals"]["pairwise_accel_ensemble"] > 0
              and sl["accel_f64"] == sl["accel_f64_rows"] == 0,
              f"path D: the f64 ensemble startup launched {sl}, expected kernel 1-f64's "
              f"ensemble form alone, once a force evaluation (F2)")
        # F2: the f64 ensemble force is each member's single-system force,
        # the square kernel 1-f64's, bitwise
        ens_force = sh._fused_ensemble_accel(mu, dev)(0.0, start["pos"])
        force_bitwise = all(torch.equal(ens_force[m], nbody.pairwise_accel(start["pos"][m], mu_dev))
                            for m in range(ENSEMBLE))
        check(force_bitwise, "path D: an ensemble member's f64 force is not the single-system "
                             "force, kernel 1-f64's square form (F2)")
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
        t0 = time.perf_counter()
        e64 = run64(c0)
        torch.cuda.synchronize()
        scan64_s = time.perf_counter() - t0
        launches_64 = read_counts()
        check(launches_64["accel_f64_ensemble"] == EARLY_STEPS
              and launches_64["elm2f64_update_shift"] == EARLY_STEPS
              and sum(launches_64.values()) == 2 * EARLY_STEPS,
              f"path D: the f64 ensemble scan launched {launches_64}, expected kernel 1-f64's "
              f"ensemble form and kernel 2-f64 once each a step (F2)")
        # the same scan again, timed alone (the first run above is timed too)
        t0 = time.perf_counter()
        run64(c0)
        torch.cuda.synchronize()
        scan64_s = [scan64_s, time.perf_counter() - t0]
        record.setdefault("elm2f64_update_shift", {}).setdefault("launches_by_phase", {})[
            "20_scan"] = launches_64["elm2f64_update_shift"]
        record.setdefault("accel_f64_ensemble", {})["launches"] = (
            sl["accel_f64_ensemble"] + launches_64["accel_f64_ensemble"])
        record["accel_f64_ensemble"]["launches_by_phase"] = {
            "20_startup": sl["accel_f64_ensemble"], "20_scan": launches_64["accel_f64_ensemble"]}
        # each member's rings bitwise the single system's native-f64 steps
        # (kernels 2-f64 and 1-f64's square form) on that member
        worst, members64 = 0.0, True
        for m in range(ENSEMBLE):
            cm = ms.ELM2Carry(t=c0.t, ys=c0.ys[:, m].contiguous(),
                              ddys=c0.ddys[:, m].contiguous(), dy=c0.dy[m])
            for _ in range(EARLY_STEPS):
                cm = ms.elm2_step(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), H, cm,
                                  with_velocity=False)
            worst = max(worst, ((e64.ys[0, m] - cm.ys[0]).abs().max() / cm.ys[0].abs().max()).item())
            members64 &= bool(torch.equal(e64.ys[:, m], cm.ys) and torch.equal(e64.ddys[:, m], cm.ddys))
        check(members64 and worst <= EARLY_BOUND,
              f"path D f64 ensemble scan vs the single-system f64 steps: members bitwise "
              f"{members64}, {worst}")
        best = min(scan_s)
        print(json.dumps({
            "phase": 20, "path": "D", "config": "ensemble16x4096", "e": ENSEMBLE, "n": N_BODIES,
            "h_s": H, "scan_steps": ENS_SCAN_STEPS, "timed_scans": ENS_TIMED_SCANS,
            "scan_s": scan_s, "startup_s": start["startup_s"],
            "startup_launches": {k: v for k, v in sl.items() if v},
            "f64_scan_launches": {k: v for k, v in launches_64.items() if v},
            "f64_scan_s": scan64_s, "f64_scan_steps": EARLY_STEPS,
            "f64_scan_body_steps_per_s": [ENSEMBLE * N_BODIES * EARLY_STEPS / t for t in scan64_s],
            "f64_scan_members_bitwise_to_single": members64,
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
            a_64 = sh.pairwise_accel_rowsharded(mesh, p64, m64)  # the row-sharded f64 force
            torch.cuda.synchronize()
            t_path = time.perf_counter() - t0
            launches_e = read_counts()
            # the expansion scan again with the route patched to kernel 3's rows form
            with kernel3_route():
                reset_counts()
                run_qf3, _ = sh.make_rowsharded_scan_qf(mesh, tab, mu, H, EARLY_STEPS,
                                                        precise_sums=True)
                out_qf3 = run_qf3(qf0)
                torch.cuda.synchronize()
                launches_e3 = read_counts()
            check(launches_e3["accel_limbs3_rows"] == EARLY_STEPS
                  and launches_e3["elm2q_update"] == EARLY_STEPS
                  and sum(launches_e3.values()) == 2 * EARLY_STEPS,
                  f"path E through kernel 3: {launches_e3}")
            for k in ("accel_df64_rows", "accel_limbs3_f64_rows", "elm2f_update_shift",
                      "elm2q_update", "accel_f32_masked", "strong_corr", "accel_df64_ensemble",
                      "accel_f64_rows"):
                check(launches_e[k] > 0, f"path E did not launch {k}: {launches_e}")
            check(launches_e["accel_df64"] == launches_e["accel_limbs3"] == 0
                  and launches_e["accel_f64"] == launches_e["accel_limbs3_f64_pair"] == 0
                  and launches_e["accel_limbs3_f64"] == launches_e["accel_limbs3_rows"] == 0,
                  f"path E launched a square pair kernel or kernel 3: {launches_e}")
            # its scans are the two-float and expansion steps: no native-f64
            # step, so no kernel 2-f64 (the GSPMD f64 steps are phase 37's)
            check(launches_e["elm2f64_update_shift"] == 0,
                  f"path E launched kernel 2-f64: {launches_e}")

            # the unsharded references
            ref_f = f0
            for _ in range(EARLY_STEPS):
                ref_f = ms.elm2_step_f(tab, accel_pair_square, H, ref_f)
            ref_qf = qf0
            for _ in range(EARLY_STEPS):
                ref_qf = ms.elm2_step_qf(tab, cl_pair, H, ref_qf, precise_sums=True)
            ref_qf3 = qf0
            with kernel3_route():
                for _ in range(EARLY_STEPS):
                    ref_qf3 = ms.elm2_step_qf(tab, cl_pair, H, ref_qf3, precise_sums=True)
            idx = split.strong_pair_indices(p64, m64, k=STRONG_K)
            mask = split.strong_pair_mask(idx, N_BODIES)
            a_ref = cuda_split.pairwise_accel_split(p64, m64, idx, mask)

            def same(a, b):
                return all(torch.equal(x, y) for x, y in zip(a, b))

            results = {
                "scan_f": same((*out_f.ys, *out_f.dd), (*ref_f.ys, *ref_f.dd)),
                "scan_qf_precise": same((*out_qf.ys, *out_qf.dd), (*ref_qf.ys, *ref_qf.dd)),
                "scan_qf_precise_kernel3": same((*out_qf3.ys, *out_qf3.dd),
                                                (*ref_qf3.ys, *ref_qf3.dd)),
                "split_refresh": bool(torch.equal(idx_s, idx) and torch.equal(mask_s, mask)),
                "split_force": bool(torch.equal(a_s, a_ref)),
                "shardmap_ensemble": same((*out_e.ys, *out_e.dd), (*ens["f25"].ys, *ens["f25"].dd)),
                "rowsharded_f64_force": bool(torch.equal(a_64, nbody.pairwise_accel(p64, m64))),
            }
            for what, ok in results.items():
                check(ok, f"path E {what} is not the unsharded result bitwise")
        finally:
            dist.destroy_process_group()
        for k in ("accel_df64_rows", "accel_limbs3_f64_rows"):
            record.setdefault(k, {})["launches"] = launches_e[k]
        # kernel 3's rows form: path E's expansion scan with the route on kernel 3
        record.setdefault("accel_limbs3_rows", {})["launches"] = launches_e3["accel_limbs3_rows"]
        record.setdefault("accel_f64_rows", {}).setdefault("launches_by_phase", {})["21"] = (
            launches_e["accel_f64_rows"])
        print(json.dumps({"phase": 21, "path": "E", "ranks": 1, "backend": "nccl", "n": N_BODIES,
                          "steps": EARLY_STEPS, "bitwise": results, "launches": launches_e,
                          "launches_kernel3_route": launches_e3,
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
              and launches_i["accel_limbs3_f64_pair"] == EARLY_STEPS
              and sum(launches_i.values()) == 2 * EARLY_STEPS,
              f"path I: launches {launches_i}, expected {EARLY_STEPS} each of kernels 4' and "
              f"3-f64")
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
        with F64Evals() as evals_m:
            t0 = time.perf_counter()
            e_m = eph.generate_ephemeris(fss_m.state, fss_m.settings, span, device=dev)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        launches_gen = read_counts()
        check(launches_gen["gen_scan_f64"] == n_chunks and but_f64(launches_gen) == n_chunks
              and evals_m.matches(launches_gen),
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
        check(fleet_only(launches_fly, fly_syncs),
              f"phase 30: the flight launched {launches_fly} in {fly_syncs} host reads")
        record.setdefault("fleet_scan", {})["launches"] = launches_fly["fleet_scan"]
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
        st_g, st_s, st_it, st_syncs = fleet_run(
            lambda: sc_.propagate_ship(e_sem, sem.ships[0], device=dev))
        launches_st = read_counts()
        check(fleet_only(launches_st, st_syncs),
              f"phase 30: the Earth Station flight launched {launches_st} in {st_syncs} reads")
        record["fleet_scan"].setdefault("launches_by_phase", {})["30_earth_station"] = (
            launches_st["fleet_scan"])
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
    fleet64 = {}  # phase 31's ephemeris, ships and trajectories, which phase 37 is held to
    if 31 in phases:
        t_phase = time.perf_counter()
        fss_f = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        e_f = eph.generate_ephemeris(fss_f.state, fss_f.settings,
                                     port.Duration.from_days(FLEET_EPH_DAYS), device=dev)
        ships = _fleet_ships(fss_f, e_f, FLEET_SHIPS, FLEET_DAYS)

        def fleet():
            return sc_.propagate_ships(e_f, ships, max_knots=FLEET_KNOTS, device=dev)

        first, warm_s, _, _ = fleet_run(fleet)
        fleet64.update(eph=e_f, ships=ships, first=first)
        spans = [tr.end_s - tr.start_s for tr in first.values()]
        check(min(spans) > FLEET_MIN_SPAN_DAYS * 86400.0,
              f"fleet64: a ship spans only {min(spans) / 86400.0} days")
        reset_counts()
        runs = [fleet_run(fleet) for _ in range(FLEET_RUNS)]
        launches_fleet = read_counts()
        check(fleet_only(launches_fleet, sum(r[3] for r in runs)),
              f"fleet64 launched {launches_fleet} in {sum(r[3] for r in runs)} host reads")
        record.setdefault("fleet_scan", {}).setdefault("launches_by_phase", {})["31"] = (
            launches_fleet["fleet_scan"])
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
        with F64Evals() as evals_fwd:
            timed("generate_forward", lambda: u.generate(span))
        launches_fwd = read_counts()
        check(launches_fwd["gen_scan_f64"] == n_fwd and but_f64(launches_fwd) == n_fwd
              and evals_fwd.matches(launches_fwd),
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
        sc_.propagate_batch.syncs = 0
        traj = timed("replan", lambda: u.replan(ship.name, max_knots=MISSION_KNOTS))
        launches_replan = read_counts()
        check(fleet_only(launches_replan, sc_.propagate_batch.syncs),
              f"phase 32: the replan launched {launches_replan} in "
              f"{sc_.propagate_batch.syncs} host reads")
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
        with F64Evals() as evals_bwd:
            timed("generate_backward", lambda: u.extend(back, -1))
        launches_bwd = read_counts()
        check(launches_bwd["gen_scan_f64"] == n_bwd and but_f64(launches_bwd) == n_bwd
              and evals_bwd.matches(launches_bwd),
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
        sc_.propagate_batch.syncs = 0
        traj2 = timed("replan_incremental", lambda: u.replan(ship.name, max_knots=MISSION_KNOTS))
        launches_edit = read_counts()
        check(fleet_only(launches_edit, sc_.propagate_batch.syncs),
              f"phase 32: the edit's replan launched {launches_edit} in "
              f"{sc_.propagate_batch.syncs} host reads")
        record.setdefault("fleet_scan", {}).setdefault("launches_by_phase", {}).update(
            {"32_replan": launches_replan["fleet_scan"],
             "32_edit": launches_edit["fleet_scan"]})
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
        with F64Evals() as evals_ext:
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
        check(launches_ext["gen_scan_f64"] >= 1 and but_f64(launches_ext)
              == launches_ext["gen_scan_f64"] and evals_ext.matches(launches_ext),
              f"phase 32: the extension launched {launches_ext}")

        # the interpolation audit over the generated span
        t0_s = u.state.epoch.as_offset_seconds()
        audit_steps = int((u.ephemeris.end.as_offset_seconds() - t0_s) / h) - tab.order
        n_audit = -(-audit_steps // eph.CHUNK_STEPS)
        reset_counts()
        with F64Evals() as evals_audit:
            errs = timed("interpolation_error", lambda: api.interpolation_error(
                u.ephemeris, u.state, u.settings, device=dev))
        launches_audit = read_counts()
        check(launches_audit["gen_scan_f64"] == n_audit
              and but_f64(launches_audit) == n_audit and evals_audit.matches(launches_audit),
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

    # -- slice 13: the precision ladder's open rungs ---------------------------
    def fss_specs(sc_):
        """The Sun's 1PN term and the Earth's J2 on a scene's bodies."""
        names = [b.name for b in sc_.state.bodies]
        return (perts.spec_schwarzschild(names.index("Sun")),
                perts.spec_j2(names.index("Earth"), perts.EARTH_J2, perts.EARTH_RADIUS_KM))

    # -- phase 33: kernel 12 (the tf96 force) against its plain version ---------
    full3_plain_ops = None  # aten ops of one plain tf96 force on full_solar_system
    if 33 in phases:
        t_phase = time.perf_counter()
        lib = _build.library()
        check(lib.eet_accel_full3_smem_bodies() == nbody_full3.SMEM_BODIES,
              "kernel 12 was built for another shared-memory limit than nbody_full3.SMEM_BODIES")
        sem_sc = scene.load_scene(ROOT / "systems" / "sun_earth_moon_2433282.5")
        rng = np.random.default_rng(11)
        cl_pos = rng.normal(size=(8, 3)) * 1.0e8
        cl_pos[1] = cl_pos[0] + rng.normal(size=3) * 1.0e3  # test_torch_tf96.py's close pair
        cl_mu = 10.0 ** rng.uniform(3, 11, size=8)
        cases = [("full_solar_system", fss.state.positions(), fss.state.mus()),
                 ("sun_earth_moon", sem_sc.state.positions(), sem_sc.state.mus()),
                 ("close_cluster", cl_pos, cl_mu)]
        # the cluster at the first version's cap (1,365: one block's default
        # 48 KiB), one past it (F4), at 4,096 (shared memory after the opt-in)
        # and one past what the opt-in holds (global scratch)
        cases += [(f"cluster{n}", *_cluster(n, seed=3)[::2]) for n in FULL3_SIZES]
        out = []
        for name, p, m in cases:
            n = len(p)
            limbs = ex.from_f64_host(p, dev)[:3]
            m_dev = torch.as_tensor(m, dtype=f64, device=dev)
            reset_counts()
            k = nbody_full3.pairwise_accel_full3(*limbs, m_dev)
            launched = nbody_full3.pairwise_accel_full3.launches
            r = nbody_full3.pairwise_accel_full3_plain(*limbs, m_dev)
            torch.cuda.synchronize()
            abs_err = (k - r).abs().max().item()
            check(launched == 1, f"kernel 12 on {name}: {launched} launches, expected 1")
            check(bool(torch.isfinite(k).all()), f"kernel 12 non-finite on {name}")
            check(torch.equal(k, r), f"kernel 12 vs plain on {name}: not bitwise, max|d| = "
                                     f"{abs_err}")
            big = n > 1366
            aten = step_ops(lambda _: nbody_full3.pairwise_accel_full3_plain(*limbs, m_dev), None)
            kms = cuda_ms(lambda: nbody_full3.pairwise_accel_full3(*limbs, m_dev), 5 if big else 20)
            gms = graph_ms(lambda: nbody_full3.pairwise_accel_full3(*limbs, m_dev), 5 if big else 20)
            pms = cuda_ms(lambda: nbody_full3.pairwise_accel_full3_plain(*limbs, m_dev),
                          1 if big else 3, 1)
            b = bound_of(lambda: nbody_full3.pairwise_accel_full3_plain(*limbs, m_dev),
                         [*limbs, m_dev, k])
            del r
            out.append({"input": name, "n": n, "bitwise": True,
                        "route": "shared" if n <= nbody_full3.SMEM_BODIES else "global scratch",
                        "kernel_us": kms * 1e3, "kernel_device_us": gms * 1e3, "plain_ms": pms,
                        "plain_aten_ops": sum(aten.values()), "bound": b,
                        "bound_share": b["bound_ms"] / (gms if gms > 0 else float("inf"))})
            if name == "full_solar_system":
                record["accel_full3"] = kernel_record(abs_err, kms, pms, b)
                full3_plain_ops = sum(aten.values())
        torch.cuda.empty_cache()
        print(json.dumps({"phase": 33, "kernel": "accel_full3", "cases": out,
                          "pair_loop_sass": _sass_loop(_build, "accel_full3_kernel", "MUFU.RSQ"),
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 34: "extendedF" generation of full_solar_system through kernel 12 --
    if 34 in phases:
        t_phase = time.perf_counter()
        span = port.Duration.from_days(EXT_DAYS)
        n_steps = int(round(span.as_seconds() / fss.settings.dt.as_seconds()))
        for route in ("chunk", "two_launch"):  # warm-up
            with genq_gate_off() if route == "two_launch" else contextlib.nullcontext():
                eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(1),
                                       precision="extendedF", device=dev)
        torch.cuda.synchronize()
        props = []  # the propagator generate_ephemeris makes, for its carried state
        Prop = eph.NBodyPropagator

        class Kept(Prop):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                props.append(self)

        eph.NBodyPropagator = Kept
        try:
            reset_counts()
            with QSteps() as qs_f, GenQCalls() as gq_f:
                t0 = time.perf_counter()
                e_gpu = eph.generate_ephemeris(fss.state, fss.settings, span,
                                               precision="extendedF", device=dev)
                torch.cuda.synchronize()
                t_gpu = time.perf_counter() - t0
            launches_f = read_counts()
        finally:
            eph.NBodyPropagator = Prop
        evals = force_evals(tab.order)
        check(launches_f["accel_full3"] == evals and launches_f["accel_limbs3"] == 0,
              f"\"extendedF\": kernel 12 once a startup force evaluation ({evals}), no kernel "
              f"3: {launches_f}")
        # kernel 13-chunk once a chunk, and neither kernel 13 nor kernel 12
        # in the scan
        check(gq_f.chunks > 0 and launches_f["gen_scan_q"] == gq_f.chunks and qs_f.steps == 0
              and launches_f["elm2q_update_shift"] == 0
              and sum(launches_f.values()) == evals + gq_f.chunks,
              f"\"extendedF\": kernel 13-chunk once a chunk ({gq_f.chunks}): {launches_f}")
        head_f = exp_head(props[0]._carry.ms.ys)
        # the same span through the two-launch route (kernel 13 then kernel
        # 12 a scan step), the route before kernel 13-chunk: bitwise, and
        # its rate in the same call
        reset_counts()
        with genq_gate_off(), QSteps() as qs_fr:
            t0 = time.perf_counter()
            e_route = eph.generate_ephemeris(fss.state, fss.settings, span,
                                             precision="extendedF", device=dev)
            torch.cuda.synchronize()
            t_route = time.perf_counter() - t0
        launches_fr = read_counts()
        check(launches_fr["gen_scan_q"] == 0 and qs_fr.steps == n_steps - tab.order
              and launches_fr["elm2q_update_shift"] == qs_fr.steps
              and launches_fr["accel_full3"] == force_evals(n_steps),
              f"\"extendedF\" through the two-launch route: {launches_fr}")
        same_route = all(np.array_equal(e_gpu[n].coeffs, e_route[n].coeffs) for n in e_gpu.names)
        check(same_route, "\"extendedF\" through kernel 13-chunk is not bitwise to the "
                          "two-launch route")
        # the CPU port over the span's first EXTF_CPU_DAYS (its eager tf96
        # force runs ~0.1-0.2 sim-days/s): the same steps, so the same
        # leading segments
        t0 = time.perf_counter()
        e_cpu = eph.generate_ephemeris(fss.state, fss.settings,
                                       port.Duration.from_days(EXTF_CPU_DAYS),
                                       precision="extendedF", device="cpu")
        t_cpu = time.perf_counter() - t0
        err = _coeff_err({n: e_cpu[n].coeffs for n in e_cpu.names},
                         {n: e_gpu[n].coeffs[:len(e_cpu[n].coeffs)] for n in e_gpu.names},
                         fss.settings)
        if "extended3" not in ext_heads:
            prop = eph.NBodyPropagator(fss.state, fss.settings, precision="extended3", device=dev)
            prop.step_chunk(n_steps)
            ext_heads["extended3"] = exp_head(prop._carry.ms.ys)
        d_km = (head_f - ext_heads["extended3"]).abs().max().item()
        check(bool(torch.isfinite(head_f).all()), "\"extendedF\" state not finite")
        check(err <= FSS_BOUND, f"\"extendedF\" CUDA vs CPU: {err}")
        check(d_km < EXTF_VS_EXT3_KM, f"\"extendedF\" vs \"extended3\": {d_km} km")
        # PLAIN_PATCHED_STEPS more with kernel 12's plain version patched in,
        # against one day through the kernel: the launches and seconds a
        # step it saves, on the two-launch route (kernel 13-chunk does not
        # call kernel 12)
        day = int(round(86400.0 / fss.settings.dt.as_seconds()))
        prop = eph.NBodyPropagator(fss.state, fss.settings, precision="extendedF", device=dev)
        prop.step_chunk(tab.order)
        per_step = {}
        wrapper = nbody_full3.pairwise_accel_full3
        gate_q = eph._use_gen_kernel_q
        eph._use_gen_kernel_q = lambda *a: False

        def plain_into(l0, l1, l2, mu, out=None):
            acc = nbody_full3.pairwise_accel_full3_plain(l0, l1, l2, mu)
            return acc if out is None else out.copy_(acc)

        for label in ("kernel", "plain", "kernel_again"):
            steps = day
            if label == "plain":
                nbody_full3.pairwise_accel_full3 = plain_into
                steps = PLAIN_PATCHED_STEPS
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prop.step_chunk(steps)
                torch.cuda.synchronize()
                per_step[label] = (time.perf_counter() - t0) / steps
            finally:
                nbody_full3.pairwise_accel_full3 = wrapper
        eph._use_gen_kernel_q = gate_q
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prop.step_chunk(day)
        torch.cuda.synchronize()
        per_step["kernel13_chunk"] = (time.perf_counter() - t0) / day
        print(json.dumps({
            "phase": 34, "path": "extendedF", "scene": "full_solar_system_2433282.5",
            "n": fss.state.n, "sim_days": EXT_DAYS, "steps": n_steps, "force_evaluations": evals,
            "chunks": gq_f.chunks,
            "launches": launches_f, "sim_days_per_s": EXT_DAYS / t_gpu,
            "two_launch_route": {"sim_days_per_s": EXT_DAYS / t_route, "scan_steps": qs_fr.steps,
                                 "launches": {k: v for k, v in launches_fr.items() if v},
                                 "coefficients_bitwise": same_route},
            "cpu_sim_days_per_s": EXTF_CPU_DAYS / t_cpu, "cpu_days": EXTF_CPU_DAYS,
            "coeff_err_vs_cpu": err, "bound": FSS_BOUND, "max_km_vs_extended3": d_km, "extended3_km_bound": EXTF_VS_EXT3_KM,
            "one_day_s_per_step": per_step, "plain_steps": PLAIN_PATCHED_STEPS,
            "plain_patched_launches_per_step_saved": full3_plain_ops - 1 if full3_plain_ops else None,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))
        record.setdefault("accel_full3", {})["launches"] = launches_f["accel_full3"]
        record["accel_full3"].setdefault("launches_by_phase", {})["34_two_launch"] = (
            launches_fr["accel_full3"])
        record.setdefault("elm2q_update_shift", {}).setdefault("launches_by_phase", {})[
            "34_two_launch"] = launches_fr["elm2q_update_shift"]
        record.setdefault("gen_scan_q", {}).setdefault("launches_by_phase", {})["34"] = (
            launches_f["gen_scan_q"])

    # -- phase 35: perturbations on the card -------------------------------------
    if 35 in phases:
        t_phase = time.perf_counter()
        spec = fss_specs(fss)
        span = port.Duration.from_days(PERT_DAYS)
        reset_counts()
        with F64Evals() as evals_p:
            t0 = time.perf_counter()
            e_pert = eph.generate_ephemeris(fss.state, fss.settings, span, perturbations=spec,
                                            device=dev)
            torch.cuda.synchronize()
            t_pert = time.perf_counter() - t0
        launches_p = read_counts()
        check(but_f64(launches_p) == 0 and evals_p.matches(launches_p)
              and launches_p["accel_f64"] > 0,
              f"perturbed \"f64\" launched {launches_p}: kernel 11-f64 must not run, kernel "
              f"1-f64 once a force evaluation ({evals_p.calls})")
        record.setdefault("accel_f64", {}).setdefault("launches_by_phase", {})["35"] = (
            launches_p["accel_f64"])
        e_cpu = eph.generate_ephemeris(fss.state, fss.settings, span, perturbations=spec,
                                       device="cpu")
        err = _coeff_err({n: e_cpu[n].coeffs for n in e_cpu.names},
                         {n: e_pert[n].coeffs for n in e_pert.names}, fss.settings)
        # the same eager native-f64 loop without perturbations (kernel 11-f64
        # gated off), card against CPU: the route's own rounding distance
        gate = eph._use_gen_kernel_f64
        eph._use_gen_kernel_f64 = lambda n, d: False
        try:
            e_eager = eph.generate_ephemeris(fss.state, fss.settings, span, device=dev)
        finally:
            eph._use_gen_kernel_f64 = gate
        e_newton_cpu = eph.generate_ephemeris(fss.state, fss.settings, span, device="cpu")
        err_eager = _coeff_err({n: e_newton_cpu[n].coeffs for n in e_newton_cpu.names},
                               {n: e_eager[n].coeffs for n in e_eager.names}, fss.settings)
        check(err <= max(FSS_BOUND, GEN_ENVELOPE * err_eager),
              f"perturbed \"f64\" CUDA vs CPU: {err} (the eager loop's own: {err_eager})")
        e_newton = eph.generate_ephemeris(fss.state, fss.settings, span, device=dev)
        t25 = fss.state.epoch.as_offset_seconds() + 25 * 86400.0
        d_earth = float(np.linalg.norm(e_pert["Earth"].position(t25)
                                       - e_newton["Earth"].position(t25)))
        check(PN_EARTH_KM[0] < d_earth < PN_EARTH_KM[1],
              f"Earth's displacement by 1PN + J2 at day 25: {d_earth} km")

        # Mercury's perihelion precession: Sun + Mercury, whole orbits
        a_m, e_m = 5.7909e7, 0.20563
        mu_sun = 1.32712440041279419e11
        rp = a_m * (1 - e_m)
        vp = np.sqrt(mu_sun * (2 / rp - 1 / a_m))
        pos0 = np.array([[0.0, 0.0, 0.0], [rp, 0.0, 0.0]])
        vel0 = np.array([[0.0, 0.0, 0.0], [0.0, vp, 0.0]])
        mu_m = torch.tensor([mu_sun, 22031.86855], dtype=f64, device=dev)
        pert = perts.build((perts.spec_schwarzschild(0),))

        def accel_pn(t, y, dy):
            return nbody.pairwise_accel(y, mu_m) + pert(t, y, dy, mu_m)

        accel_pn.needs_velocity = True
        period = 2 * np.pi * np.sqrt(a_m**3 / mu_sun)
        n_mer = int(round(MERCURY_ORBITS * period / MERCURY_H))
        t0 = time.perf_counter()
        c = ms.elm2_init(tab, accel_pn, 0.0, torch.as_tensor(pos0, device=dev),
                         torch.as_tensor(vel0, device=dev), MERCURY_H)
        for _ in range(n_mer - tab.order):
            c = ms.elm2_step(tab, accel_pn, MERCURY_H, c)
        p1, v1 = c.ys[0].cpu().numpy(), c.dy.cpu().numpy()
        t_mer = time.perf_counter() - t0

        def lrl(p, v):
            return np.cross(v, np.cross(p, v)) / mu_sun - p / np.linalg.norm(p)

        e0, e1 = lrl(pos0[1], vel0[1]), lrl(p1[1] - p1[0], v1[1] - v1[0])
        measured = float(np.arccos(np.clip(np.dot(e0, e1) / (np.linalg.norm(e0)
                                                             * np.linalg.norm(e1)), -1, 1)))
        expected = (6 * np.pi * mu_sun / (perts.C_LIGHT_KM_S**2 * a_m * (1 - e_m**2))
                    * n_mer * MERCURY_H / period)
        check(abs(measured - expected) / expected < 0.10,
              f"Mercury's precession {measured} rad, expected {expected}")

        # "extended3" with 1PN: kernel 3-f64 for every force evaluation
        span3 = port.Duration.from_days(PERT_EXT3_DAYS)
        n3 = int(round(span3.as_seconds() / fss.settings.dt.as_seconds()))
        reset_counts()
        with QSteps() as qs_3:
            t0 = time.perf_counter()
            eph.generate_ephemeris(fss.state, fss.settings, span3, precision="extended3",
                                   perturbations=spec[:1], device=dev)
            torch.cuda.synchronize()
            t_ext3 = time.perf_counter() - t0
        launches_3 = read_counts()
        check(launches_3["accel_limbs3_f64"] == force_evals(n3)
              and launches_3["elm2q_update_shift"] == qs_3.steps == n3 - tab.order
              and sum(launches_3.values()) == force_evals(n3) + qs_3.steps,
              f"perturbed \"extended3\": kernel 3-f64 once a force evaluation "
              f"({force_evals(n3)}), kernel 13 once a scan step: {launches_3}")
        # kernel 13's main path since kernel 13-chunk took the unperturbed
        # chunks: the chunks the gate sends through it, perturbed ones here
        record.setdefault("elm2q_update_shift", {})["launches"] = launches_3["elm2q_update_shift"]
        record["elm2q_update_shift"].setdefault("launches_by_phase", {})["35"] = (
            launches_3["elm2q_update_shift"])
        print(json.dumps({
            "phase": 35, "path": "perturbations", "scene": "full_solar_system_2433282.5",
            "specs": [list(s[:1]) for s in spec],
            "f64": {"sim_days": PERT_DAYS, "launches": launches_p, "sim_days_per_s":
                    PERT_DAYS / t_pert, "coeff_err_vs_cpu": err,
                    "newtonian_eager_coeff_err_vs_cpu": err_eager,
                    "bound": max(FSS_BOUND, GEN_ENVELOPE * err_eager),
                    "earth_km_at_day_25": d_earth, "earth_km_bounds": PN_EARTH_KM},
            "mercury": {"orbits": MERCURY_ORBITS, "steps": n_mer, "h_s": MERCURY_H,
                        "measured_rad": measured, "expected_rad": expected,
                        "rel_err": abs(measured - expected) / expected, "seconds": t_mer},
            "extended3_1pn": {"sim_days": PERT_EXT3_DAYS, "launches": launches_3,
                              "force_evaluations": force_evals(n3),
                              "sim_days_per_s": PERT_EXT3_DAYS / t_ext3},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 36: the dd truth steppers on the card ------------------------------
    if 36 in phases:
        t_phase = time.perf_counter()
        cpu = torch.device("cpu")
        pos_f, vel_f, mu_f = fss.state.positions(), fss.state.velocities(), fss.state.mus()
        h_f = fss.settings.dt.as_seconds()
        on = {}
        for label, d in (("card", dev), ("cpu", cpu)):
            mu_d = torch.as_tensor(mu_f, dtype=f64, device=d)
            lo = torch.as_tensor(pos_f * np.random.default_rng(2).uniform(-2.0**-54, 2.0**-54,
                                                                          pos_f.shape), device=d)
            force = nbody.pairwise_accel_dd(TwoFloat(torch.as_tensor(pos_f, device=d), lo), mu_d)

            def accel_dd(t, y, mu_d=mu_d):
                return nbody.pairwise_accel_dd(y, mu_d)

            day = int(round(86400.0 / h_f))
            t0 = time.perf_counter()
            c = ms.elm2_init_cf(tab, accel_dd, 0.0, torch.as_tensor(pos_f, device=d),
                                torch.as_tensor(vel_f, device=d), h_f)
            for _ in range(day - tab.order):
                c = ms.elm2_step_cf(tab, accel_dd, h_f, c)
            if d.type == "cuda":
                torch.cuda.synchronize()
            on[label] = {"force": [x.cpu() for x in force], "carry": c,
                         "seconds": time.perf_counter() - t0}
        g, cpu_r = on["card"], on["cpu"]
        force_same = all(torch.equal(a, b) for a, b in zip(g["force"], cpu_r["force"]))
        check(force_same, "pairwise_accel_dd on the card is not bitwise the CPU's")
        yg = (g["carry"].ys.hi[0].cpu(), g["carry"].ys.lo[0].cpu())
        yc = (cpu_r["carry"].ys.hi[0], cpu_r["carry"].ys.lo[0])
        dy = ((yg[0] - yc[0]) + (yg[1] - yc[1])).abs().max().item()
        ymax = yc[0].abs().max().item()
        check(dy <= TRUTH_CARD_VS_CPU * ymax, f"the CF truth's day, card vs CPU: {dy / ymax}")
        print(json.dumps({
            "phase": 36, "path": "dd truth", "scene": "full_solar_system_2433282.5",
            "dd_force_bitwise_card_vs_cpu": force_same, "steps": day,
            "cf_rel_diff_card_vs_cpu": dy / ymax, "bound": TRUTH_CARD_VS_CPU,
            "cf_bitwise": bool(torch.equal(yg[0], yc[0]) and torch.equal(yg[1], yc[1])),
            "card_s": g["seconds"], "cpu_s": cpu_r["seconds"],
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 37: scale-out on the card ------------------------------------------
    if 37 in phases:
        import torch.distributed as dist
        from ephemeris_explorer_tpu_torch.parallel import dryrun

        t_phase = time.perf_counter()
        start = ensemble_start()
        ens_pos = np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(ENSEMBLE)])
        ens_vel = np.stack([_cluster(N_BODIES, seed=i)[1] for i in range(ENSEMBLE)])
        if not fleet64:
            fss_f = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
            e_f = eph.generate_ephemeris(fss_f.state, fss_f.settings,
                                         port.Duration.from_days(FLEET_EPH_DAYS), device=dev)
            ships = _fleet_ships(fss_f, e_f, FLEET_SHIPS, FLEET_DAYS)
            fleet64.update(eph=e_f, ships=ships, first=sc_.propagate_ships(
                e_f, ships, max_knots=FLEET_KNOTS, device=dev))
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            mesh = sh.make_mesh(1, 1)
            reset_counts()
            with F64Evals() as evals_ens:
                t0 = time.perf_counter()
                c = sh.init_ensemble_carry(mesh, tab, mu, 0.0, ens_pos, ens_vel, H)
                torch.cuda.synchronize()
                init_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = sh.make_sharded_ensemble_scan(mesh, tab, mu, H, SHARD_STEPS)(c)
                torch.cuda.synchronize()
                scan_s = time.perf_counter() - t0
                stepped = sh.make_sharded_ensemble_step(mesh, tab, mu, H)(c)
                torch.cuda.synchronize()
            launches_ens = read_counts()
            # the GSPMD force: each local member's rows through kernel 1-f64's
            # rows form, once a member a force evaluation, no other kernel (F2)
            check(but_f64(launches_ens) == 0 and evals_ens.matches(launches_ens)
                  and launches_ens["accel_f64_rows"] > 0 and launches_ens["accel_f64"] == 0,
                  f"phase 37: the sharded f64 ensemble launched {launches_ens}, expected kernel "
                  f"1-f64's rows form and kernel 2-f64 alone (F2)")
            record.setdefault("accel_f64_rows", {})["launches"] = launches_ens["accel_f64_rows"]
            record["accel_f64_rows"].setdefault("launches_by_phase", {})["37"] = (
                launches_ens["accel_f64_rows"])
            # kernel 2-f64 once a GSPMD step: SHARD_STEPS of the scan, one step
            check(launches_ens["elm2f64_update_shift"] == SHARD_STEPS + 1,
                  f"phase 37: kernel 2-f64 launched {launches_ens['elm2f64_update_shift']} "
                  f"times, expected {SHARD_STEPS + 1}")
            record.setdefault("elm2f64_update_shift", {}).setdefault("launches_by_phase", {})[
                "37"] = launches_ens["elm2f64_update_shift"]

            c0 = start["carry0"]
            ref = sh.make_fused_ensemble_scan(tab, mu, H, SHARD_STEPS, device=dev)(c0)
            ref1 = ms.elm2_step(tab, sh._fused_ensemble_accel(mu, dev), H, c0)

            def same(a, b):  # member-major shard against a ring-major whole carry
                return (torch.equal(a.ys, b.ys.transpose(0, 1))
                        and torch.equal(a.ddys, b.ddys.transpose(0, 1))
                        and torch.equal(a.dy, b.dy) and a.t == b.t)

            ens_same = {"init": same(c, c0), "scan": same(out, ref), "step": same(stepped, ref1)}
            for what, ok in ens_same.items():
                check(ok, f"phase 37: the sharded ensemble {what} is not the unsharded one bitwise")
            del c, out, stepped, ref, ref1

            # fleet64 through the sharded propagator, against phase 31's batch
            e_f, ships, first = fleet64["eph"], fleet64["ships"], fleet64["first"]
            index = {n: i for i, n in enumerate(e_f.names)}
            tls = sc_.stack_timelines([sc_.build_timeline(x.burns, index) for x in ships])
            t0s = np.asarray([x.start.as_offset_seconds() for x in ships])
            ends = np.asarray([x.end.as_offset_seconds() for x in ships])
            p0s = np.stack([x.position for x in ships]).astype(np.float64)
            v0s = np.stack([x.velocity for x in ships]).astype(np.float64)
            fn, place = sh.make_sharded_fleet_propagator(mesh, "Verner87",
                                                         sc_.ship_params(ships[0]), FLEET_KNOTS)
            reset_counts()
            sc_.propagate_batch.syncs = 0
            t0 = time.perf_counter()
            res = sh.gather_fleet(mesh, fn(*place(e_f.pack(dev), tls, t0s, p0s, v0s, ends)))
            torch.cuda.synchronize()
            fleet_s = time.perf_counter() - t0
            launches_fleet = read_counts()
            check(fleet_only(launches_fleet, sc_.propagate_batch.syncs),
                  f"phase 37: the fleet launched {launches_fleet} in "
                  f"{sc_.propagate_batch.syncs} host reads")
            record.setdefault("fleet_scan", {}).setdefault("launches_by_phase", {})["37"] = (
                launches_fleet["fleet_scan"])
            r = sc_._fetch(res)
            fleet_same = all(
                int(r.reason[i]) != sc_.DONE_KNOTS_FULL
                and np.array_equal(r.ts[i, :int(r.count[i])], first[x.name].ts)
                and np.array_equal(r.pos[i, :int(r.count[i])], first[x.name].pos)
                for i, x in enumerate(ships))
            check(fleet_same, "phase 37: the sharded fleet is not phase 31's propagate_ships bitwise")
        finally:
            dist.destroy_process_group()
        dry = {}
        for n in (1, DRYRUN_GLOO):
            dry[n] = dryrun.dryrun_multichip(n)
        check(dry[1]["backend"] == "nccl" and dry[DRYRUN_GLOO]["backend"] == "gloo",
              f"phase 37: dry run backends {dry[1]['backend']}, {dry[DRYRUN_GLOO]['backend']}")
        print(json.dumps({
            "phase": 37, "path": "scale-out", "ranks": 1, "backend": "nccl",
            "config": "ensemble16x4096", "e": ENSEMBLE, "n": N_BODIES, "steps": SHARD_STEPS,
            "ensemble_bitwise": ens_same, "ensemble_launches": launches_ens,
            "init_s": init_s, "scan_s": scan_s, "fleet": "fleet64", "ships": FLEET_SHIPS,
            "fleet_bitwise_to_phase_31": fleet_same, "fleet_s": fleet_s,
            "fleet_launches": launches_fleet,
            "dryrun": {str(n): {k: d[k] for k in ("backend", "mesh", "seconds", "rank_seconds",
                                                  "checks")} for n, d in dry.items()},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 38: the accuracy audit on the card ---------------------------------
    if 38 in phases:
        from ephemeris_explorer_tpu_torch import audit as audit_

        t_phase = time.perf_counter()
        fss_a = "full_solar_system_2433282.5"
        reset_counts()
        # ref64 runs on the host by the audit's design (audit.CPU_MODES);
        # plain is the same native-f64 engine on the card; the truth is kept
        # for fused's run through kernel 3 below
        cache = tempfile.TemporaryDirectory()
        with F64Evals() as evals_a:
            res = audit_.audit(fss_a, AUDIT_STEPS, 1, ["fused", "ref64", "plain"], device=dev,
                               verbose=False, traj_cache=cache.name)
        launches_fused = read_counts()
        truth60 = np.load(next(Path(cache.name).glob("*_dd.npy")))
        cache.cleanup()
        sc_a = scene.load_scene(ROOT / "systems" / fss_a)
        h_a = sc_a.settings.dt.as_seconds()
        names = [b.name for b in sc_a.state.bodies]
        # the same 60 days of fused with the route on kernel 3, in this call:
        # the route stays on kernel 3-f64 only if it is no farther from the
        # dd truth than kernel 3, within AUDIT_ROUTE_KM on the worst body
        with kernel3_route():
            reset_counts()
            fused3, info3 = audit_.trajectory("fused", sc_a.state, h_a, AUDIT_STEPS, 1,
                                              device=dev)
            launches_fused3 = read_counts()
        check(launches_fused3["accel_limbs3"] > 0
              and launches_fused3["elm2q_update"] == launches_fused["elm2q_update"]
              and sum(launches_fused3.values()) == launches_fused3["accel_limbs3"]
              + launches_fused3["elm2q_update"],
              f"phase 38: fused through kernel 3 launched {launches_fused3}")
        rows3, per_body3 = audit_.errors(fused3, truth60, names, info3["days"])
        info = res["__info__"]
        (days, fused_all, fused_pl) = res["fused"][-1]
        ref_all = res["ref64"][-1][1]
        plain_all = res["plain"][-1][1]
        check(fused_all < AUDIT_ALL_KM and fused_pl < AUDIT_PLANETS_KM,
              f"phase 38: fused {fused_all} km (planets {fused_pl}) from the dd truth at {days} d")
        k3_all = rows3[-1][1]
        check(fused_all <= k3_all + AUDIT_ROUTE_KM,
              f"phase 38: fused through kernel 3-f64 {fused_all} km from the dd truth, through "
              f"kernel 3 {k3_all} km: the route must go back to kernel 3")
        check(REF64_KM[0] < ref_all < REF64_KM[1], f"phase 38: ref64 {ref_all} km at {days} d")
        check(REF64_KM[0] < plain_all < REF64_KM[1],
              f"phase 38: plain (native f64 on the card) {plain_all} km at {days} d")
        # fused: kernels 3-f64 (the pair) and 4; plain: kernel 1-f64 once a
        # force evaluation; ref64 (the host) none
        check(launches_fused["accel_limbs3_f64_pair"] > 0 and launches_fused["elm2q_update"] > 0
              and but_f64(launches_fused) == launches_fused["accel_limbs3_f64_pair"]
              + launches_fused["elm2q_update"] and evals_a.matches(launches_fused)
              and launches_fused["accel_f64"] > AUDIT_STEPS,
              f"phase 38: fused, ref64 and plain launched {launches_fused}, expected kernels "
              f"3-f64 and 4, kernel 1-f64 once a plain force evaluation ({evals_a.calls}) and "
              f"kernel 2-f64 once a plain step ({evals_a.steps})")
        record.setdefault("accel_f64", {}).setdefault("launches_by_phase", {})["38_plain"] = (
            launches_fused["accel_f64"])
        record.setdefault("elm2f64_update_shift", {}).setdefault("launches_by_phase", {})[
            "38_plain"] = launches_fused["elm2f64_update_shift"]
        modes = {"fused": {"days": days, "max_all_km": fused_all, "max_planets_km": fused_pl,
                           "worst_body": res["__per_body__"]["fused"][-1][0],
                           "launches": {k: v for k, v in launches_fused.items()
                                        if v and k not in f64_forms
                                        and k != "elm2f64_update_shift"},
                           "seconds": info["fused"]["seconds"]},
                 "fused_kernel3": {"days": rows3[-1][0], "max_all_km": k3_all,
                                   "max_planets_km": rows3[-1][2],
                                   "worst_body": per_body3[-1][0],
                                   "launches": {k: v for k, v in launches_fused3.items() if v},
                                   "seconds": info3["seconds"]},
                 "ref64": {"days": days, "max_all_km": ref_all,
                           "worst_body": res["__per_body__"]["ref64"][-1][0],
                           "device": "cpu", "seconds": info["ref64"]["seconds"]},
                 "plain": {"days": days, "max_all_km": plain_all,
                           "worst_body": res["__per_body__"]["plain"][-1][0],
                           "launches": {"accel_f64": launches_fused["accel_f64"],
                                        "elm2f64_update_shift":
                                            launches_fused["elm2f64_update_shift"]},
                           "seconds": info["plain"]["seconds"]}}

        truth2, _ = audit_.trajectory("dd", sc_a.state, h_a, AUDIT_SHORT_STEPS, 1)
        for mode, kernel in (("expansion3", "accel_limbs3_f64"), ("expansionF", "accel_full3")):
            reset_counts()
            with QSteps() as qs_m:
                card, info_g = audit_.trajectory(mode, sc_a.state, h_a, AUDIT_SHORT_STEPS, 1,
                                                 device=dev)
            launches_m = read_counts()
            check(launches_m[kernel] > 0 and qs_m.steps == AUDIT_SHORT_STEPS - tab.order
                  and launches_m["elm2q_update_shift"] == qs_m.steps
                  and sum(launches_m.values()) == launches_m[kernel] + qs_m.steps,
                  f"phase 38: {mode} launched {launches_m}, expected {kernel} and kernel 13 "
                  f"once a step ({qs_m.steps})")
            cpu, info_c = audit_.trajectory(mode, sc_a.state, h_a, AUDIT_SHORT_STEPS, 1,
                                            device="cpu")
            gap = float(np.abs(card - cpu).max() / np.abs(cpu).max())
            check(gap <= AUDIT_CARD_VS_CPU[mode], f"phase 38: {mode} card vs CPU port: {gap}")
            rows, per_body = audit_.errors(card, truth2, names, info_g["days"])
            modes[mode] = {"days": rows[-1][0], "max_all_km": rows[-1][1],
                           "max_planets_km": rows[-1][2], "worst_body": per_body[-1][0],
                           "card_vs_cpu_rel": gap, "bound": AUDIT_CARD_VS_CPU[mode],
                           "launches": {k: v for k, v in launches_m.items() if v},
                           "seconds": info_g["seconds"], "cpu_seconds": info_c["seconds"]}
            record.setdefault(kernel, {}).setdefault("launches_by_phase", {})[f"38_{mode}"] = (
                launches_m[kernel])
            record.setdefault("elm2q_update_shift", {}).setdefault("launches_by_phase", {})[
                f"38_{mode}"] = launches_m["elm2q_update_shift"]
        for k in ("accel_limbs3_f64_pair", "elm2q_update"):
            record.setdefault(k, {}).setdefault("launches_by_phase", {})["38_fused"] = (
                launches_fused[k])
        # kernel 3's square form: the audit's fused mode with the route on kernel 3
        record.setdefault("accel_limbs3", {})["launches"] = launches_fused3["accel_limbs3"]
        print(json.dumps({
            "phase": 38, "path": "audit", "scene": fss_a, "truth": "dd",
            "truth_s": info["dd"]["seconds"], "modes": modes,
            "bars_km": {"all": AUDIT_ALL_KM, "planets": AUDIT_PLANETS_KM, "ref64": REF64_KM,
                        "plain": REF64_KM, "route_vs_kernel3": AUDIT_ROUTE_KM},
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }))

    # -- phase 39: kernel 1-f64, the native-f64 pair force, against its plain version
    def f64_timed(kernel, plain, reps, plain_reps=2):
        return {"kernel_us": cuda_ms(kernel, reps) * 1e3,
                "kernel_device_us": graph_ms(kernel, reps) * 1e3,
                "plain_us": cuda_ms(plain, plain_reps, 1) * 1e3}

    def ptxas_of(kernel):
        """ptxas's lines on the entry functions whose names hold ``kernel``
        (registers, shared memory, spills), from this process's build, or
        from the build.log saved beside the library it loaded from the
        cache."""
        log = _build.build_log
        saved = _build.BUILD_ROOT / _build._source_hash()[:16] / "build.log"
        if not log and saved.exists():
            log = saved.read_text()
        out, mine = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties for" in ln:
                mine = kernel in ln
            if mine:
                out.append(ln.strip())
        return out

    if 39 in phases:
        t_phase = time.perf_counter()

        def dd_errors(a, p, m):
            """max |a - a_dd| / max |a_dd| and the worst row's |a - a_dd| /
            |a_dd| against the double-double force on the same inputs."""
            dd = nbody.pairwise_accel_dd(TwoFloat(p, torch.zeros_like(p)), m)
            err = (a - dd.hi) - dd.lo
            return {"rel_to_max": (err.abs().max() / dd.hi.abs().max()).item(),
                    "worst_row_rel": (err.norm(dim=1) / dd.hi.norm(dim=1)).max().item()}

        scenes = [(f"cluster{n}", *_cluster(n, seed=n)[::2]) for n in F64_SIZES]
        scenes.append(("full_solar_system", fss.state.positions(), fss.state.mus()))
        square, side = [], []
        for name, p, m in scenes:
            tp, tm = dev64(p, m)
            n = len(p)
            k = cuda_nbody64.pairwise_accel_f64(tp, tm)
            pl = cuda_nbody64.pairwise_accel_f64_plain(tp, tm)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k, pl))
            err = (k - pl).abs().max().item()
            check(bitwise, f"kernel 1-f64 on {name}: not bitwise to its plain version "
                           f"(max |d| {err})")
            check(bool(torch.isfinite(k).all()), f"kernel 1-f64 non-finite on {name}")
            out = torch.full_like(k, float("nan"))
            check(cuda_nbody64.pairwise_accel_f64(tp, tm, out=out) is out and torch.equal(out, k),
                  f"kernel 1-f64 on {name}: out= is not the result")
            reps = 50 if n >= 1024 else 200
            case = {"input": name, "n": n, "bitwise": bitwise, "max_abs_err": err,
                    "splits_tiles": list(cuda_nbody64._geometry(n)),
                    **f64_timed(lambda: cuda_nbody64.pairwise_accel_f64(tp, tm),
                                lambda: cuda_nbody64.pairwise_accel_f64_plain(tp, tm), reps)}
            if n > 1:
                b = bound_of(lambda: cuda_nbody64.pairwise_accel_f64_plain(tp, tm), [tp, tm, k])
                case["bound"] = b
                case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
            square.append(case)
            if name in ("cluster4096", "full_solar_system", "cluster1365", "cluster256"):
                # the same positions through kernel 1 (two-float) beside it
                mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
                ph, plo = cuda_nbody.split_f64(tp, transpose=True)
                k1 = cuda_nbody.pairwise_accel(tp, mh, ml)
                side.append({
                    "input": name, "n": n,
                    "kernel1_f64_device_us": case["kernel_device_us"],
                    "kernel1_df64_device_us": graph_ms(
                        lambda: cuda_nbody.pairwise_accel_df64(ph, plo, mh, ml), reps) * 1e3,
                    "kernel1_df64_dropin_us": cuda_ms(
                        lambda: cuda_nbody.pairwise_accel(tp, mh, ml), reps) * 1e3,
                    "kernel1_f64_vs_dd": dd_errors(k, tp, tm),
                    "kernel1_df64_vs_dd": dd_errors(k1, tp, tm),
                    "native_f64_bound_us": case["bound"]["bound_ms"] * 1e3,
                })
                side[-1]["kernel1_df64_share_of_f64_bound"] = (
                    side[-1]["native_f64_bound_us"] / side[-1]["kernel1_df64_device_us"])
            if name == "cluster4096":
                record.setdefault("accel_f64", {}).update(kernel_record(
                    err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"]))
        # pairs off CUDA rsqrt's fast path (two bodies at one place: r^2 = 0;
        # two 1e-161 km apart: a subnormal r^2): their tiles run again
        # through rsqrt(); the infinities and NaNs where the plain version's are
        p, _, m = _cluster(300, seed=300)
        p[50] = p[7]
        p[8], p[260] = 0.0, (1e-161, 0.0, 0.0)
        tp, tm = dev64(p, m)
        k = cuda_nbody64.pairwise_accel_f64(tp, tm)
        pl = cuda_nbody64.pairwise_accel_f64_plain(tp, tm)

        def same_nan(a, b):
            inf = float("inf")
            return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(
                a.nan_to_num(0.0, inf, -inf), b.nan_to_num(0.0, inf, -inf)))

        slow = {"input": "cluster300 with r^2 = 0 and a subnormal r^2", "n": 300,
                "non_finite_rows": int((~torch.isfinite(k).all(1)).sum()),
                "bitwise_but_nan_payloads": same_nan(k, pl)}
        check(slow["bitwise_but_nan_payloads"] and slow["non_finite_rows"] > 0,
              f"kernel 1-f64 off rsqrt's fast path: {slow}")
        # rows slices: bitwise to the square form's rows and to the plain rows
        rows_cases = []
        for n in F64_ROWS_SIZES:
            p, _, m = _cluster(n, seed=n)
            tp, tm = dev64(p, m)
            sq = cuda_nbody64.pairwise_accel_f64(tp, tm)
            for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1), (n - 1, 1),
                           (n // 2, 300)):
                rows = tp[r0:r0 + nl]
                got = cuda_nbody64.pairwise_accel_f64_rows(tp, rows, r0, tm)
                plain = cuda_nbody64.pairwise_accel_f64_rows_plain(tp, rows, r0, tm)
                check(torch.equal(got, sq[r0:r0 + nl]) and torch.equal(got, plain),
                      f"kernel 1-f64 rows {r0}:{r0 + nl} of {n}: not bitwise to the square "
                      f"form's slice and to the plain rows")
            plain = cuda_nbody64.pairwise_accel_f64_rows_plain(tp, tp, 0, tm)
            err = (cuda_nbody64.pairwise_accel_f64_rows(tp, tp, 0, tm) - plain).abs().max().item()
            case = {"form": "rows", "n": n, "row0s_bitwise": True, "max_abs_err": err,
                    **f64_timed(lambda: cuda_nbody64.pairwise_accel_f64_rows(tp, tp, 0, tm),
                                lambda: cuda_nbody64.pairwise_accel_f64_rows_plain(tp, tp, 0, tm),
                                50)}
            if n == N_BODIES:
                b = bound_of(lambda: cuda_nbody64.pairwise_accel_f64_rows_plain(tp, tp, 0, tm),
                             [tp, tm, sq])
                case["bound"] = b
                case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
                record.setdefault("accel_f64_rows", {}).update(kernel_record(
                    err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, b))
            rows_cases.append(case)
        # the ensemble at E x 4096: bitwise to its plain version, each member
        # to the square form
        pe = torch.as_tensor(np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(ENSEMBLE)]),
                             dtype=f64, device=dev)
        ke = cuda_nbody64.pairwise_accel_f64_ensemble(pe, mu_dev)
        pe_plain = cuda_nbody64.pairwise_accel_f64_ensemble_plain(pe, mu_dev)
        members = all(torch.equal(ke[i], cuda_nbody64.pairwise_accel_f64(pe[i], mu_dev))
                      for i in range(ENSEMBLE))
        err = (ke - pe_plain).abs().max().item()
        check(torch.equal(ke, pe_plain) and members,
              f"kernel 1-f64 ensemble {ENSEMBLE} x {N_BODIES}: plain {torch.equal(ke, pe_plain)}, "
              f"members to the square form {members}")
        del pe_plain
        ens = {"form": "ensemble", "e": ENSEMBLE, "n": N_BODIES, "bitwise": True,
               "max_abs_err": err,
               "members_bitwise_to_square": members,
               **f64_timed(lambda: cuda_nbody64.pairwise_accel_f64_ensemble(pe, mu_dev),
                           lambda: cuda_nbody64.pairwise_accel_f64_ensemble_plain(pe, mu_dev),
                           10, 1)}
        ens["square_x16_device_us"] = graph_ms(
            lambda: [cuda_nbody64.pairwise_accel_f64(pe[i], mu_dev) for i in range(ENSEMBLE)],
            5) * 1e3
        ens["bound"] = bound_of(
            lambda: cuda_nbody64.pairwise_accel_f64_ensemble_plain(pe, mu_dev), [pe, mu_dev, ke])
        ens["bound_share"] = ens["bound"]["bound_ms"] * 1e3 / ens["kernel_device_us"]
        # kernel 1's ensemble form on the same members (two-float), beside it
        ph_e, pl_e = cuda_nbody.split_f64(pe.transpose(1, 2))
        ens["kernel1_df64_ensemble_device_us"] = graph_ms(
            lambda: cuda_nbody.pairwise_accel_df64_ensemble(ph_e, pl_e, mu_hi, mu_lo), 5) * 1e3
        del ph_e, pl_e
        record.setdefault("accel_f64_ensemble", {}).update(kernel_record(
            ens["max_abs_err"], ens["kernel_us"] / 1e3, ens["plain_us"] / 1e3, ens["bound"]))
        print(json.dumps({"phase": 39, "kernel": "accel_f64 (kernel 1-f64)", "square": square,
                          "off_fast_path": slow,
                          "rows": rows_cases, "ensemble": ens, "beside_kernel1": side,
                          "ptxas": ptxas_of("accel_f64"),
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))
        del pe, ke

    # -- phase 40: kernel 2-f64, the native-f64 ELM2 update and ring shift ----------
    if 40 in phases:
        t_phase = time.perf_counter()
        cases = []
        for name in ("QuinlanTremaine12", "Stormer13"):
            t = get(name)
            coef = cuda_elm2f64._plan(t, H).coef
            for m in F64_UPDATE_SIZES:
                rng = np.random.default_rng(m)
                ys = torch.as_tensor(rng.normal(size=(t.order, m)) * 1e8, device=dev)
                dd = torch.as_tensor(rng.normal(size=(t.order, m)) * 1e-6, device=dev)
                reset_counts()
                y, ys_new, dd_new = cuda_elm2f64.elm2f64_update_shift(t, H, ys, dd)
                launched = cuda_elm2f64.elm2f64_update_shift.launches
                py, pys, pdd = cuda_elm2f64.elm2f64_update_shift_plain(coef, ys, dd)
                torch.cuda.synchronize()
                same = bool(torch.equal(y, py) and torch.equal(ys_new, pys)
                            and torch.equal(dd_new[1:], pdd[1:]))
                err = (y - py).abs().max().item()
                check(launched == 1 and same and bool(torch.isfinite(y).all()),
                      f"kernel 2-f64 on {name} at M = {m}: launches {launched}, bitwise {same}, "
                      f"max|d| {err}")
                case = {"tableau": name, "m": m, "bitwise": same, "max_abs_err": err}
                if m >= 12288:
                    s_ = H * H / t.beta_d

                    def eager_update():
                        """What kernel 2-f64 replaces in the step: the eager
                        update and the two ring concatenations (a ring row
                        standing in for the force)."""
                        y_e = (ms._wsum(ms._coef(t.c_y, ys), ys)
                               + ms._wsum(ms._coef(t.c_dy, ys), dd) * s_)
                        torch.cat([y_e[None], ys[:-1]])
                        torch.cat([dd[0][None], dd[:-1]])

                    case["kernel_us"] = cuda_ms(
                        lambda: cuda_elm2f64.elm2f64_update_shift(t, H, ys, dd), 200) * 1e3
                    case["kernel_device_us"] = graph_ms(
                        lambda: cuda_elm2f64.elm2f64_update_shift(t, H, ys, dd), 200) * 1e3
                    case["eager_update_and_cats_device_us"] = graph_ms(eager_update, 200) * 1e3
                    case["kernel_device_us_again"] = graph_ms(
                        lambda: cuda_elm2f64.elm2f64_update_shift(t, H, ys, dd), 200) * 1e3
                    case["eager_update_and_cats_device_us_again"] = graph_ms(eager_update,
                                                                             200) * 1e3
                    case["plain_us"] = cuda_ms(
                        lambda: cuda_elm2f64.elm2f64_update_shift_plain(coef, ys, dd), 20) * 1e3
                    b = bound_of(lambda: cuda_elm2f64.elm2f64_update_shift_plain(coef, ys, dd),
                                 [ys, dd, ys_new, dd_new[1:]])
                    case["bound"] = b
                    case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
                    if name == "QuinlanTremaine12" and m == 12288:
                        record.setdefault("elm2f64_update_shift", {}).update(kernel_record(
                            err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, b))
                cases.append(case)
                del ys, dd, y, ys_new, dd_new, py, pys, pdd
        one = torch.zeros(1, device=dev)
        floor_us = graph_ms(lambda: one.add_(1.0), 200) * 1e3
        ptxas = [ln.strip() for ln in _build.build_log.splitlines()
                 if "elm2_f64_update" in ln or "elm2_f64" in ln]
        print(json.dumps({"phase": 40, "kernel": "elm2f64_update_shift (kernel 2-f64)",
                          "cases": cases, "one_element_add_device_us": floor_us,
                          "ptxas": ptxas[:8], "phase_s": time.perf_counter() - t_phase,
                          "card": smi}))

    # -- phase 41: kernel 3-f64, the native-f64 3-limb pair force, against its plain version
    if 41 in phases:
        t_phase = time.perf_counter()

        def dd_error(a, p, m):
            """max |a - a_dd| / max |a_dd| and the worst row's |a - a_dd| /
            |a_dd| against the double-double force on the limbs' positions
            (exact: the host split of the f64 positions)."""
            dd = nbody.pairwise_accel_dd(TwoFloat(p, torch.zeros_like(p)), m)
            err = (a - dd.hi) - dd.lo
            return {"rel_to_max": (err.abs().max() / dd.hi.abs().max()).item(),
                    "worst_row_rel": (err.norm(dim=1) / dd.hi.norm(dim=1)).max().item()}

        def both_same(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b))

        scenes = [(f"cluster{n}", *_cluster(n, seed=n)[::2]) for n in LIMBS64_SIZES]
        scenes.append(("full_solar_system", fss.state.positions(), fss.state.mus()))
        square, side = [], []
        for name, p, m in scenes:
            tp, tm = dev64(p, m)
            n = len(p)
            limbs = ex.from_f64_host(p, dev)[:3]
            k = cuda_limbs64.pairwise_accel_limbs64(*limbs, tm)
            kp = cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm)
            pl = cuda_limbs64.pairwise_accel_limbs64_plain(*limbs, tm)
            plp = cuda_limbs64.pairwise_accel_limbs64_pair_plain(*limbs, tm)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k, pl)) and both_same(kp, plp)
            err = (k - pl).abs().max().item()
            check(bitwise, f"kernel 3-f64 on {name}: not bitwise to its plain version "
                           f"(max |d| {err})")
            check(both_same(kp, cuda_nbody.split_f64(k)),
                  f"kernel 3-f64 on {name}: the pair is not split_f64 of the f64 force")
            check(bool(torch.isfinite(k).all()), f"kernel 3-f64 non-finite on {name}")
            reps = 50 if n >= 1024 else 200
            case = {"input": name, "n": n, "bitwise": bitwise, "max_abs_err": err,
                    "splits_tiles": list(cuda_nbody64._geometry(n)),
                    **f64_timed(lambda: cuda_limbs64.pairwise_accel_limbs64(*limbs, tm),
                                lambda: cuda_limbs64.pairwise_accel_limbs64_plain(*limbs, tm),
                                reps),
                    "pair_kernel_us": cuda_ms(
                        lambda: cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm), reps) * 1e3,
                    "pair_kernel_device_us": graph_ms(
                        lambda: cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm), reps) * 1e3}
            if n > 1:
                b = bound_of(lambda: cuda_limbs64.pairwise_accel_limbs64_plain(*limbs, tm),
                             [*limbs, tm, k])
                case["bound"] = b
                case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
            square.append(case)
            if name in ("cluster4096", "cluster1365", "full_solar_system"):
                # kernel 3 (two-float) on the same limbs beside it
                mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
                k3 = cuda_limbs.pairwise_accel_limbs(*limbs, mh, ml)
                side.append({
                    "input": name, "n": n,
                    "kernel3_f64_device_us": case["kernel_device_us"],
                    "kernel3_f64_pair_device_us": case["pair_kernel_device_us"],
                    "kernel3_f64_wrapper_us": case["pair_kernel_us"],
                    "kernel3_device_us": graph_ms(
                        lambda: cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml), reps) * 1e3,
                    "kernel3_wrapper_us": cuda_ms(
                        lambda: cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml), reps) * 1e3,
                    "kernel3_f64_again_device_us": graph_ms(
                        lambda: cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm), reps) * 1e3,
                    "kernel3_f64_vs_dd": dd_error(k, tp, tm),
                    "kernel3_vs_dd": dd_error(k3, tp, tm),
                    "native_f64_bound_us": case["bound"]["bound_ms"] * 1e3,
                })
                side[-1]["kernel3_share_of_f64_bound"] = (
                    side[-1]["native_f64_bound_us"] / side[-1]["kernel3_device_us"])
                check(side[-1]["kernel3_f64_vs_dd"]["rel_to_max"]
                      <= side[-1]["kernel3_vs_dd"]["rel_to_max"],
                      f"kernel 3-f64 is farther from the dd force than kernel 3 on {name}: "
                      f"{side[-1]}")
            if name == "cluster4096":
                record.setdefault("accel_limbs3_f64", {}).update(kernel_record(
                    err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, case["bound"]))
                pair_err = max((a - b).abs().max().item() for a, b in zip(kp, plp))
                record.setdefault("accel_limbs3_f64_pair", {}).update(kernel_record(
                    pair_err, case["pair_kernel_us"] / 1e3,
                    cuda_ms(lambda: cuda_limbs64.pairwise_accel_limbs64_pair_plain(*limbs, tm),
                            2, 1),
                    bound_of(lambda: cuda_limbs64.pairwise_accel_limbs64_pair_plain(*limbs, tm),
                             [*limbs, tm, *kp])))
        # pairs off CUDA rsqrt's fast path (two bodies at one place: r^2 = 0)
        p, _, m = _cluster(300, seed=300)
        p[50] = p[7]
        limbs = ex.from_f64_host(p, dev)[:3]
        tm = torch.as_tensor(m, dtype=f64, device=dev)
        k = cuda_limbs64.pairwise_accel_limbs64(*limbs, tm)
        pl = cuda_limbs64.pairwise_accel_limbs64_plain(*limbs, tm)
        inf = float("inf")
        slow = {"input": "cluster300 with r^2 = 0", "n": 300,
                "non_finite_rows": int((~torch.isfinite(k).all(1)).sum()),
                "bitwise_but_nan_payloads": bool(torch.equal(k.isnan(), pl.isnan()) and torch.equal(
                    k.nan_to_num(0.0, inf, -inf), pl.nan_to_num(0.0, inf, -inf)))}
        check(slow["bitwise_but_nan_payloads"] and slow["non_finite_rows"] > 0,
              f"kernel 3-f64 off rsqrt's fast path: {slow}")
        # rows slices: bitwise to the square form's rows and to the plain rows
        rows_cases = []
        for n in LIMBS64_ROWS_SIZES:
            p, _, m = _cluster(n, seed=n)
            limbs = ex.from_f64_host(p, dev)[:3]
            tm = torch.as_tensor(m, dtype=f64, device=dev)
            src = [l.t().contiguous() for l in limbs]
            sq = cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm)
            for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1), (n - 1, 1)):
                recv = [l[r0:r0 + nl].contiguous() for l in limbs]
                got = cuda_limbs64.pairwise_accel_limbs64_rows(*src, tm, *recv, r0)
                plain = cuda_limbs64.pairwise_accel_limbs64_rows_plain(*src, tm, *recv, r0)
                check(both_same(got, (sq[0][r0:r0 + nl], sq[1][r0:r0 + nl]))
                      and both_same(got, plain),
                      f"kernel 3-f64 rows {r0}:{r0 + nl} of {n}: not bitwise to the square "
                      f"form's slice and to the plain rows")

            def rows_call():
                return cuda_limbs64.pairwise_accel_limbs64_rows(*src, tm, *limbs, 0)

            def rows_plain():
                return cuda_limbs64.pairwise_accel_limbs64_rows_plain(*src, tm, *limbs, 0)

            got, plain = rows_call(), rows_plain()
            err = max((a - b).abs().max().item() for a, b in zip(got, plain))
            case = {"form": "rows", "n": n, "row0s_bitwise": True, "max_abs_err": err,
                    **f64_timed(rows_call, rows_plain, 50)}
            if n == N_BODIES:
                b = bound_of(rows_plain, [*src, tm, *limbs, *got])
                case["bound"] = b
                case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
                record.setdefault("accel_limbs3_f64_rows", {}).update(kernel_record(
                    err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, b))
            rows_cases.append(case)
        print(json.dumps({"phase": 41, "kernel": "accel_limbs3_f64 (kernel 3-f64)",
                          "square": square, "off_fast_path": slow, "rows": rows_cases,
                          "beside_kernel3": side, "ptxas": ptxas_of("accel_limbs3_f64"),
                          "sass_pair_loop": _sass_loop(_build, "accel_limbs3_f64", "RSQ64H"),
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 42: kernel 13, the expansion step's update with its ring shifts --
    if 42 in phases:
        t_phase = time.perf_counter()
        cases = []
        for tab_name in ("QuinlanTremaine12", "Stormer13"):
            t_ = get(tab_name)
            for m in ELM2QS_SIZES:
                rng = np.random.default_rng(m)
                ys = ex.from_f64_host(rng.normal(size=(t_.order, m)) * 1e8, dev)
                dd = torch.as_tensor(rng.normal(size=(t_.order, m)) * 1e-6
                                     * np.exp2(rng.integers(-20, 1, size=(t_.order, m))),
                                     device=dev)
                for precise in (True, False):
                    plan = cuda_elm2qs._plan(t_, H, precise)
                    reset_counts()
                    y_k, ys_k, dd_k = cuda_elm2qs.elm2q_update_shift(t_, H, ys, dd, precise)
                    launched = cuda_elm2qs.elm2q_update_shift.launches
                    y_p, ys_p, dd_p = cuda_elm2qs.elm2q_update_shift_plain(plan, ys, dd)
                    torch.cuda.synchronize()
                    same = (all(torch.equal(a, b) for a, b in zip(ys_k, ys_p))
                            and torch.equal(dd_k[1:], dd_p[1:]))
                    err = max((a.double() - b.double()).abs().max().item()
                              for a, b in zip(y_k, y_p))
                    check(launched == 1 and same
                          and all(bool(torch.isfinite(l).all()) for l in y_k),
                          f"kernel 13 on {tab_name} at M = {m} (precise={precise}): launches "
                          f"{launched}, bitwise {same}, max|d| {err}")
                    case = {"tableau": tab_name, "m": m, "precise": precise, "bitwise": same,
                            "max_abs_err": err}
                    if tab_name == "QuinlanTremaine12" and m in (96, 12288):
                        def call():
                            return cuda_elm2qs.elm2q_update_shift(t_, H, ys, dd, precise)

                        def plain():
                            return cuda_elm2qs.elm2q_update_shift_plain(plan, ys, dd)

                        def eager():
                            """What kernel 13 replaces in the step: the eager
                            update and the five ring concatenations (a ring
                            row standing in for the force)."""
                            sum1 = ms._exp_wsum_alpha(t_.c_y, ys)
                            if precise:
                                w = ms._precise_weights(t_.c_dy, H * H, float(t_.beta_d))
                                pair = ms._split_pair(dd)
                                inc = ms._wsum_precise(w, pair.hi, pair.lo)
                            else:
                                inc = ex.from_f64(ms._wsum(ms._coef(t_.c_dy, dd), dd)
                                                  * (H * H / t_.beta_d))
                            y_e = ex.add(sum1, inc)
                            torch.cat([dd[0][None], dd[:-1]])
                            return tuple(torch.cat([a[None], b[:-1]]) for a, b in zip(y_e, ys))

                        case["kernel_us"] = cuda_ms(call, 200) * 1e3
                        case["kernel_device_us"] = graph_ms(call, 200) * 1e3
                        case["eager_update_and_cats_us"] = cuda_ms(eager, 10) * 1e3
                        case["kernel_device_us_again"] = graph_ms(call, 200) * 1e3
                        case["eager_update_and_cats_us_again"] = cuda_ms(eager, 10) * 1e3
                        case["plain_us"] = cuda_ms(plain, 5, 1) * 1e3
                        eager_ys = eager()
                        case["eager_bitwise"] = all(torch.equal(a, b)
                                                    for a, b in zip(eager_ys, ys_k))
                        b = bound_of(plain, [*ys, dd, *ys_k, dd_k[1:]])
                        case["bound"] = b
                        case["bound_share"] = b["bound_ms"] * 1e3 / case["kernel_device_us"]
                        if m == 96 and precise:
                            record.setdefault("elm2q_update_shift", {}).update(kernel_record(
                                err, case["kernel_us"] / 1e3, case["plain_us"] / 1e3, b))
                    cases.append(case)
                del ys, dd, y_k, ys_k, dd_k, y_p, ys_p, dd_p
        # torch's own row sums on the card against the left-to-right folds
        # kernel 13 takes: the level-3 roundings' f32 sum (52 rows at QT12;
        # the port's _wsum_precise folds them since kernel 13) and the plain
        # mode's f64 dot (12 rows, multistep._wsum, shared with elm2_step)
        rng = np.random.default_rng(42)
        sums = {}
        for rows, dt in ((52, torch.float32), (12, torch.float64)):
            x = torch.as_tensor(rng.normal(size=(rows, 12288))
                                * np.exp2(rng.integers(-30, 1, size=(rows, 12288))),
                                dtype=dt, device=dev)
            acc = x[0]
            for r in x[1:]:
                acc = acc + r
            sums[f"{rows}_{str(dt)[6:]}"] = int((x.sum(0) != acc).sum().item())

        # the route against the eager step on the card: path A's 10 days and
        # 2 days of "extendedF", the carried states, launches and host time
        mu_f = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        mh_f, ml_f = cuda_nbody.split_f64(mu_f.reshape(1, -1))

        @ms.writes_into
        def limbs_f(t, limbs, out=None):
            return cuda_limbs64.limbs_force(*limbs, mu_f, mh_f, ml_f, out=out)

        spans = {}
        for precision, days in (("extended3", EXT_DAYS), ("extendedF", EXTF_CPU_DAYS)):
            n = int(round(days * 86400.0 / fss.settings.dt.as_seconds()))
            out = {"sim_days": days, "steps": n}
            carries = {}
            for route in ("kernel13", "eager"):
                orig = ms._step_q_shift
                if route == "eager":
                    ms._step_q_shift = ms._step_q_cat
                try:
                    reset_counts()
                    # the step route of generation: kernel 13-chunk's gate off
                    with QSteps() as qs, genq_gate_off():
                        prop = eph.NBodyPropagator(fss.state, fss.settings, precision=precision,
                                                   device=dev)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        prop.step_chunk(n)
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t0
                    launched = read_counts()
                finally:
                    ms._step_q_shift = orig
                carries[route] = prop._carry.ms
                out[route] = {"s_per_step": secs / n, "scan_steps": qs.steps,
                              "launches": {k: v for k, v in launched.items() if v}}
                if route == "kernel13":
                    check(launched["elm2q_update_shift"] == qs.steps == n - tab.order,
                          f"phase 42: {precision} through kernel 13 launched {launched}")
                    record.setdefault("elm2q_update_shift", {}).setdefault(
                        "launches_by_phase", {})[f"42_{precision}"] = (
                        launched["elm2q_update_shift"])
                else:
                    check(launched["elm2q_update_shift"] == 0,
                          f"phase 42: the eager {precision} step launched kernel 13")
            a, b = carries["kernel13"], carries["eager"]
            d_km = (exp_head(a.ys) - exp_head(b.ys)).abs().max().item()
            out["bitwise"] = (all(torch.equal(x, y) for x, y in zip(a.ys, b.ys))
                              and torch.equal(a.ddys, b.ddys))
            out["max_km_route_vs_eager"] = d_km
            check(d_km <= ROUTE_VS_EAGER_KM,
                  f"phase 42: {precision} through kernel 13 {d_km} km from the eager step")
            spans[precision] = out

        # one unperturbed step of each route: device launches and aten ops
        c = carries["kernel13"]
        one = {}
        for route, step in (("kernel13", ms._step_q_shift), ("eager", ms._step_q_cat)):
            reset_counts()
            step(tab, None, H, c, limbs_f, False, True)
            torch.cuda.synchronize()
            launched = {k: v for k, v in read_counts().items() if v}
            ops = step_ops(lambda c_: step(tab, None, H, c_, limbs_f, False, True), c)
            one[route] = {"launches": launched, "aten_ops": sum(ops.values()),
                          "aten_cat": ops.get("aten::cat", 0),
                          "aten_copy": ops.get("aten::copy_", 0)}
        check(one["kernel13"]["launches"] == {"accel_limbs3_f64": 1, "elm2q_update_shift": 1}
              and one["kernel13"]["aten_cat"] == 0 and one["kernel13"]["aten_copy"] == 0,
              f"phase 42: an unperturbed step must be kernel 13 and kernel 3-f64: {one}")

        ptxas = {}
        for ln in ptxas_of("elm2q_step_kernel"):
            j = re.search(r"elm2q_step_kernelILi(\d+)E", ln)
            if j:
                key = j.group(1)
            elif "registers" in ln or "spill" in ln:
                ptxas.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
        print(json.dumps({"phase": 42, "kernel": "elm2q_update_shift (kernel 13)",
                          "cases": cases, "torch_sum_vs_fold_differing": sums,
                          "spans": spans, "one_step": one,
                          "ptxas_by_beta_rows": {k: ptxas[k] for k in ("0", "11", "13")
                                                 if k in ptxas},
                          "ptxas_max_registers": max(
                              (int(m_.group(1)) for v in ptxas.values() for ln in v
                               for m_ in [re.search(r"Used (\d+) registers", ln)] if m_),
                              default=None),
                          "ptxas_spill_lines": sorted({ln for v in ptxas.values() for ln in v
                                                       if "spill" in ln}),
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 43: kernel 14, the fleet loop ------------------------------------
    if 43 in phases:
        from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

        t_phase = time.perf_counter()
        params43 = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
        scenes43 = {}
        for name in ("sun_earth_moon_2433282.5", "full_solar_system_2433282.5"):
            sc43 = scene.load_scene(ROOT / "systems" / name)
            e43 = (mission["eph"] if mission and name.startswith("full") else
                   eph.generate_ephemeris(sc43.state, sc43.settings,
                                          port.Duration.from_days(FLEET43_EPH_DAYS), device=dev))
            scenes43[name] = (sc43, e43)

        def fleet43_inputs(sc43, e43, b, burns, t0=None, burn_end=None):
            """(stacked timelines, t0s, p0s, v0s, ends) of b ships in low
            Earth orbits at ``t0`` (the scene's epoch), ``burns`` as in
            FLEET43_CASES; with ``burn_end``, each ship's first burn ends
            there."""
            index = {n: i for i, n in enumerate(e43.names)}
            t0 = sc43.state.epoch.as_offset_seconds() if t0 is None else t0
            ep, ev = e43["Earth"].state_vector(t0)
            r = 7000.0
            v_circ = float(np.sqrt(sc43.state.bodies[index["Earth"]].mu / r))
            tls = []
            for k in range(b):
                acc = np.array([2e-3, -1e-3, 5e-4]) * (1.0 + 0.01 * k)
                relative = burns == "relative" or (burns == "relative_odd" and k % 2)
                inertial = burns == "inertial" and k % 2
                starts = [t0 + 1800.0 + 97.0 * k + j * 7200.0 for j in range(2)]
                if burn_end is not None:
                    starts[0] = burn_end - 300.0
                tls.append(sc_.build_timeline([
                    scene.ShipBurn(start=port.Epoch.from_offset_seconds(st),
                                   duration=port.Duration.from_seconds(300.0), acceleration=acc,
                                   reference="Earth" if relative else None)
                    for st in starts if relative or inertial], index))
            k = np.arange(b)
            p0s = ep[None] + np.stack([r + 40.0 * k, -25.0 * k, 10.0 * k], -1)
            v0s = ev[None] + np.stack([0.0 * k, v_circ * (1.0 + 1e-4 * k), 0.0 * k], -1)
            return (sc_.stack_timelines(tls), np.full(b, t0), p0s, v0s,
                    t0 + FLEET43_SPAN_S * (1.0 + 0.05 * (k % 3)))

        def timed_fleet(fly):
            """(result, device ms of kernel 14's launches by CUDA events, per
            ship the iterations kernel 14 ran): ``fly()`` with
            cuda_fleet.fleet_scan wrapped for the call (uncounted)."""
            orig, spans, iters = cuda_fleet.fleet_scan, [], []

            def scan(p, eph_, tl, end_t, fstate, istate, knots, *a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                orig(p, eph_, tl, end_t, fstate, istate, knots, *a, **kw)
                e1.record()
                spans.append((e0, e1))
                iters.append(istate[cuda_fleet.I_ITERS].clone())

            scan.launches = 0
            cuda_fleet.fleet_scan = scan
            try:
                out = fly()
                torch.cuda.synchronize()
            finally:
                cuda_fleet.fleet_scan = orig
            return (out, sum(a.elapsed_time(b_) for a, b_ in spans), len(spans),
                    torch.stack(iters).sum(0).cpu().numpy())

        def case43(scene_name, packed, method, burns, b, inputs, params=params43,
                   done=sc_.DONE_END, **extra):
            """Kernel 14 against the plain loop on one batch: bitwise, kernel
            14 alone once a host read, and its device time by CUDA events."""
            tab43 = get(method)

            def fly(route=sc_.propagate_batch):
                return route(tab43, packed, *inputs, params, max_knots=FLEET43_KNOTS)

            reset_counts()
            sc_.propagate_batch.syncs = sc_.propagate_batch.iterations = 0
            k43 = fly()
            torch.cuda.synchronize()
            launched = read_counts()
            syncs, iters = sc_.propagate_batch.syncs, sc_.propagate_batch.iterations
            k43b, dev_ms, n_launch, ship_iters = timed_fleet(fly)
            sc_.propagate_batch.iterations = 0
            t0 = time.perf_counter()
            p43 = fly(sc_.propagate_batch_plain)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain_iters = sc_.propagate_batch.iterations
            same = all(torch.equal(x, y) for x, y in zip(k43, p43))
            again = all(torch.equal(x, y) for x, y in zip(k43, k43b))
            err = max(((x - y).abs().max().item() for x, y in
                       ((k43.pos, p43.pos), (k43.vel, p43.vel))
                       if torch.isfinite(x).all() and torch.isfinite(y).all()),
                      default=float("nan"))
            check(fleet_only(launched, syncs) and same and again
                  and bool((k43.count > 10).all())
                  and bool((k43.reason == done).all()),
                  f"phase 43: kernel 14 on {scene_name}, {method} at B = {b} {extra}: launches "
                  f"{launched} in {syncs} reads, bitwise to plain {same}, to itself "
                  f"{again}, counts {k43.count.tolist()[:8]}, reasons "
                  f"{k43.reason.tolist()[:8]}")
            case = {"scene": scene_name, "method": method, "burns": burns, "b": b,
                    "n_bodies": int(packed.mus.shape[0]), **extra,
                    "bitwise": same, "knots": int(k43.count.sum()),
                    "launches": launched["fleet_scan"], "iterations": iters,
                    "ship_iterations": int(ship_iters.sum()),
                    "device_ms": dev_ms, "device_us_per_launch": dev_ms * 1e3 / n_launch,
                    "device_us_per_iteration": dev_ms * 1e3 / iters,
                    "plain_ms": plain_ms, "plain_iterations": plain_iters,
                    "plain_ms_per_iteration": plain_ms / plain_iters}
            return case, (k43, p43, err, dev_ms, plain_ms, plain_iters, ship_iters, fly)

        cases43 = []
        for scene_name, (sc43, e43) in scenes43.items():
            packed = e43.pack(dev)
            for method, burns in FLEET43_CASES.items():
                for b in FLEET43_SIZES:
                    inputs = fleet43_inputs(sc43, e43, b, burns)
                    case, (k43, p43, err, dev_ms, plain_ms, plain_iters, ship_iters, fly) = (
                        case43(scene_name, packed, method, burns, b, inputs))
                    if method == "Verner87" and scene_name.startswith("full") and b in (1, 64):
                        # bytes: the segments the flights span, each body's
                        # tables, the knots written, the ships' start and end
                        kmax = int(k43.count.max())
                        seg_rows = []
                        for i in range(packed.mus.shape[0]):
                            lo, hi = (int(min(max(np.ceil((t - float(packed.starts[i]))
                                                          / float(packed.intervals[i])) - 1, 0),
                                              int(packed.nsegs[i]) - 1))
                                      for t in (float(inputs[1].min()), float(inputs[4].max())))
                            off = int(packed.offsets[i])
                            seg_rows.append(packed.coeffs[off + lo:off + hi + 1])
                        b43 = bound_of(lambda: fly(sc_.propagate_batch_plain),
                                       [*seg_rows, packed.mus, packed.starts, packed.intervals,
                                        packed.offsets, packed.nsegs, k43.ts[:, :kmax],
                                        k43.pos[:, :kmax], k43.vel[:, :kmax],
                                        torch.as_tensor(inputs[2]), torch.as_tensor(inputs[3])])
                        # the plain loop computes every ship every iteration: count
                        # the share of (ship, iteration) pairs the ships ran
                        share = float(ship_iters.sum()) / (b * plain_iters)
                        for key in ("bound_ms",):
                            b43[key] = b43[key] * share
                        b43["ops"] = {dt: n * share for dt, n in b43["ops"].items()}
                        b43["ship_iteration_share"] = share
                        case["bound"] = b43
                        case["bound_share"] = b43["bound_ms"] / dev_ms
                        case["bound_b_sms_ms"] = b43["bound_ms"] * SMS / min(b, SMS)
                        if b == 1:
                            record.setdefault("fleet_scan", {}).update(
                                kernel_record(err, dev_ms, plain_ms, b43))
                            record["fleet_scan"]["bound_b_sms_ms"] = case["bound_b_sms_ms"]
                    cases43.append(case)

        # PR 20's cases (FLEET43_BODIES ...): the Moon's first segment
        # boundary on sun_earth_moon, a TNB burn ending exactly on it
        sem43, e_sem = scenes43["sun_earth_moon_2433282.5"]
        p_sem = e_sem.pack(dev)
        t_b = float(p_sem.starts[2] + p_sem.intervals[2])
        for method in ("Verner87", "Fine45"):
            inputs = fleet43_inputs(sem43, e_sem, 4, "relative", t0=t_b - 1800.0, burn_end=t_b)
            case, (k43, *_) = case43("sun_earth_moon_2433282.5", p_sem, method, "relative", 4,
                                     inputs, straddles=t_b)
            ts = k43.ts[torch.isfinite(k43.ts)]
            case["knots_before_at_after"] = [int((ts < t_b).sum()), int((ts == t_b).sum()),
                                             int((ts > t_b).sum())]
            check(all(case["knots_before_at_after"]),
                  f"phase 43: the flight does not cross the boundary {case}")
            cases43.append(case)
        for n_bodies in FLEET43_BODIES:
            dusty = _with_dust(p_sem, n_bodies)
            method = "Verner98" if n_bodies > 100 else "Verner87"
            case, _ = case43("sun_earth_moon_2433282.5", dusty, method, "relative", 4,
                             fleet43_inputs(sem43, e_sem, 4, "relative"))
            cases43.append(case)
        tight = AdaptiveParams(**FLEET43_TIGHT)
        case, _ = case43("sun_earth_moon_2433282.5", p_sem, "Verner87", "relative", 4,
                         fleet43_inputs(sem43, e_sem, 4, "relative"), params=tight,
                         tight=FLEET43_TIGHT)
        case["attempts_failed_share"] = 1.0 - case["knots"] / case["ship_iterations"]
        check(case["attempts_failed_share"] > 0.5, f"phase 43: the tight case {case}")
        cases43.append(case)
        ptxas = {}
        for ln in ptxas_of("fleet_scan_kernel"):
            # an instance's tableau, tableau::<name> (mangled: its length,
            # then the name)
            j = re.search(r"fleet_scan_kernelIN7tableau(\d+)(\w+)", ln)
            if j:
                key = j.group(2)[:int(j.group(1))]
            elif "registers" in ln or "spill" in ln:
                ptxas.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
        spills = sorted({ln for v in ptxas.values() for ln in v
                         if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
        check(not spills, f"phase 43: kernel 14 spills registers: {spills}")
        # every instance's lines, so that no spill check passes on none
        check(sorted(ptxas) == sorted(name for name, *_ in cuda_fleet.instances())
              and all(any("registers" in ln for ln in v) for v in ptxas.values()),
              f"phase 43: kernel 14's ptxas lines are not one set an instance: {sorted(ptxas)}")
        print(json.dumps({"phase": 43, "kernel": "fleet_scan (kernel 14)", "cases": cases43,
                          "iterations_per_launch": cuda_fleet.ITERATIONS_PER_LAUNCH,
                          "ptxas": ptxas, "ptxas_spill_lines": spills,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

    # -- phase 44: kernel 13-chunk, the expansion generation chunk in one kernel
    if 44 in phases:
        t_phase = time.perf_counter()
        lib = _build.library()
        check(lib.eet_gen_scan_q_max_bodies() == cuda_genq.MAX_BODIES_Q,
              "kernel 13-chunk was built for another body cap than cuda_genq.MAX_BODIES_Q")
        forces = {"extended3": cuda_limbs64.pairwise_accel_limbs64,
                  "extendedF": nbody_full3.pairwise_accel_full3}

        def route_force(force, m64):
            """The two-launch route's force (kernel 3-f64's f64 form, or
            kernel 12), writing the new force-ring row."""
            kernel = forces[force]

            @ms.writes_into
            def accel_limbs(t, limbs, out=None):
                return kernel(*limbs, m64, out=out)

            return accel_limbs

        def route_steps(t_, h, c, force, precise, m64, steps):
            """`steps` steps of the two-launch route from c: kernel 13 then
            the force a step (multistep._step_q_shift); the emitted heads and
            the carry."""
            accel_limbs = route_force(force, m64)
            heads = []
            for _ in range(steps):
                c = ms._step_q_shift(t_, None, h, c, accel_limbs, False, precise)
                heads.append(exp_head(c.ys))
            return torch.stack(heads), c

        def same_carry(a, b) -> bool:
            return (all(torch.equal(x, y) for x, y in zip(a.ys, b.ys))
                    and torch.equal(a.ddys, b.ddys) and a.t == b.t)

        def carry_from_cpu(t_, p_np, v_np, m_np, h):
            """The inputs' ELM2CarryQ: elm2_init_q with the native-f64 force
            from the exact host limb split, run on the CPU (its ~49,000
            small ops take a third of the card's time there), then moved to
            the card."""
            m_cpu = torch.as_tensor(m_np, dtype=f64)
            c = ms.elm2_init_q(t_, lambda t, y: nbody.pairwise_accel(y, m_cpu), 0.0,
                               torch.as_tensor(p_np, dtype=f64), torch.as_tensor(v_np, dtype=f64),
                               h, y0_limbs=ex.from_f64_host(p_np))
            return ms.ELM2CarryQ(t=c.t, ys=tuple(l.to(dev) for l in c.ys), ddys=c.ddys.to(dev),
                                 dy=c.dy.to(dev))

        inputs = []
        for name in GENQ_SCENES:
            sc = scene.load_scene(ROOT / "systems" / name)
            inputs.append((name.split("_2")[0], sc.state.positions(), sc.state.velocities(),
                           sc.state.mus(), sc.settings.dt.as_seconds()))
        p_c, v_c, m_c = _cluster(cuda_genq.MAX_BODIES_Q, seed=8)
        inputs.append((f"cluster{cuda_genq.MAX_BODIES_Q}", p_c, v_c, m_c, H))
        cases = []
        for name, p_np, v_np, m_np, dt in inputs:
            m64 = torch.as_tensor(m_np, dtype=f64, device=dev)
            for tab_name in ("QuinlanTremaine12", "Stormer13"):
                t_ = get(tab_name)
                for direction in (1, -1):
                    h = dt * direction
                    c0 = carry_from_cpu(t_, p_np, v_np, m_np, h)
                    for force in ("extended3", "extendedF"):
                        for precise in (True, False):
                            reset_counts()
                            ys_k, c_k = cuda_genq.elm2_gen_scan_q(t_, h, c0, m64,
                                                                  GENQ_CASE_STEPS, force, precise)
                            launched = read_counts()
                            ys_p, c_p = cuda_genq.elm2_gen_scan_q_plain(
                                t_, h, c0, m64, GENQ_PLAIN_STEPS, force, precise)
                            ys_s, c_s = cuda_genq.elm2_gen_scan_q(t_, h, c0, m64,
                                                                  GENQ_PLAIN_STEPS, force, precise)
                            ys_r, c_r = route_steps(t_, h, c0, force, precise, m64,
                                                    GENQ_CASE_STEPS)
                            torch.cuda.synchronize()
                            plain_same = torch.equal(ys_s, ys_p) and same_carry(c_s, c_p)
                            route_same = torch.equal(ys_k, ys_r) and same_carry(c_k, c_r)
                            err = max((ys_s - ys_p).abs().max().item(),
                                      (ys_k - ys_r).abs().max().item())
                            what = (f"kernel 13-chunk on {name}, {tab_name}, h = {h}, {force}, "
                                    f"precise={precise}")
                            check(launched == {**{k: 0 for k in launched}, "gen_scan_q": 1},
                                  f"{what}: launches {launched}")
                            check(bool(torch.isfinite(ys_k).all()), f"{what}: not finite")
                            check(plain_same, f"{what}: not bitwise to its plain version, "
                                              f"max|d| {(ys_s - ys_p).abs().max().item()}")
                            check(route_same, f"{what}: not bitwise to the two-launch route, "
                                              f"max|d| {(ys_k - ys_r).abs().max().item()}")
                            cases.append({"input": name, "n": len(m_np), "tableau": tab_name,
                                          "h_s": h, "force": force, "precise": precise,
                                          "bitwise_plain": plain_same,
                                          "bitwise_route": route_same, "max_abs_err": err})
                    del c0
        seconds = {"cases": time.perf_counter() - t_phase}
        # generation through both routes: carry, emitted rows (the samples)
        # and fitted coefficients, full_solar_system, one GENQ_ROUTE_STEPS chunk
        t_part = time.perf_counter()
        gens = []
        for tab_name in ("QuinlanTremaine12", "Stormer13"):
            for precision in ("extended3", "extendedF"):
                for direction in (1, -1):
                    prop = eph.NBodyPropagator(fss.state, fss.settings, direction=direction,
                                               method=tab_name, precision=precision, device=dev)
                    prop.step_chunk(get(tab_name).order)  # the startup alone, either mode's
                    start, done, spec = prop._carry, prop._n_steps_done, prop.spec
                    for precise in (True, False):
                        prop.spec = dataclasses.replace(spec, precise_sums=precise)
                        out = {}
                        for route in ("chunk", "two_launch"):
                            prop._carry, prop._n_steps_done = start, done
                            reset_counts()
                            with (genq_gate_off() if route == "two_launch"
                                  else contextlib.nullcontext()):
                                coeffs = prop.step_chunk(GENQ_ROUTE_STEPS)
                            out[route] = (coeffs, prop._carry, read_counts())
                        (ca, ka, la), (cb, kb, lb) = out["chunk"], out["two_launch"]
                        same = (all(np.array_equal(ca[n], cb[n]) for n in ca)
                                and same_carry(ka.ms, kb.ms) and torch.equal(ka.ms.dy, kb.ms.dy)
                                and torch.equal(ka.samp.ring, kb.samp.ring))
                        what = f"generation, {tab_name}, {precision}, {direction}, {precise}"
                        check(la["gen_scan_q"] == 1 and la["elm2q_update_shift"] == 0
                              and lb["gen_scan_q"] == 0
                              and lb["elm2q_update_shift"] == GENQ_ROUTE_STEPS,
                              f"{what}: launches {la} / {lb}")
                        check(same, f"{what}: kernel 13-chunk is not bitwise to the two-launch "
                                    f"route")
                        gens.append({"tableau": tab_name, "precision": precision,
                                     "direction": direction, "precise": precise,
                                     "segments": sum(len(v) for v in ca.values()),
                                     "bitwise": same})
        seconds["generation"] = time.perf_counter() - t_part
        # device time a step over a long chunk (CUDA events around one
        # launch), beside the two-launch route's: its two kernels' device
        # time by graph replay, and its wall time a step over the same steps
        t_part = time.perf_counter()
        m_f = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        c0 = carry_from_cpu(tab, fss.state.positions(), fss.state.velocities(), fss.state.mus(),
                            H)
        timing = {}
        for force in ("extended3", "extendedF"):
            def chunk(steps=GENQ_TIMED_STEPS, force=force):
                return cuda_genq.elm2_gen_scan_q(tab, H, c0, m_f, steps, force, True)

            kernel_ms = cuda_ms(chunk, 3, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            kernel_wall = time.perf_counter() - t0
            limbs = tuple(l[0] for l in c0.ys[:3])
            f_out = torch.empty_like(c0.ddys[0])
            k13_ms = graph_ms(lambda: cuda_elm2qs.elm2q_update_shift(tab, H, c0.ys, c0.ddys, True),
                              200)
            force_ms = graph_ms(lambda: forces[force](*limbs, m_f, out=f_out), 200)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            route_steps(tab, H, c0, force, True, m_f, GENQ_TIMED_STEPS)
            torch.cuda.synchronize()
            route_wall = time.perf_counter() - t0
            kernel_ms_again = cuda_ms(chunk, 3, 1)
            ys_b, c_b = chunk(GENQ_BOUND_STEPS)
            b = bound_of(lambda: cuda_genq.elm2_gen_scan_q_plain(tab, H, c0, m_f,
                                                                 GENQ_BOUND_STEPS, force, True),
                         [*c0.ys, c0.ddys, m_f, ys_b, *c_b.ys, c_b.ddys])
            # the bound of a step: the operations of GENQ_BOUND_STEPS steps
            # scaled to one, and the chunk's bytes (rings in and out, mu, the
            # emission) over its GENQ_TIMED_STEPS steps
            t_ops = sum(n_ / PEAK_OPS_S[dt] for dt, n_ in b["ops"].items()) / GENQ_BOUND_STEPS
            chunk_bytes = b["bytes"] + (GENQ_TIMED_STEPS - GENQ_BOUND_STEPS) * ys_b[0].numel() * 8
            t_bytes = chunk_bytes / PEAK_BYTES_S / GENQ_TIMED_STEPS
            bound_us = max(t_ops, t_bytes) * 1e6
            sms = 1 if force == "extended3" else min(8, fss.state.n)  # the cluster's blocks
            timing[force] = {
                "steps": GENQ_TIMED_STEPS, "sms": sms, "kernel_device_us_per_step":
                    kernel_ms * 1e3 / GENQ_TIMED_STEPS,
                "kernel_device_us_per_step_again": kernel_ms_again * 1e3 / GENQ_TIMED_STEPS,
                "kernel_wall_us_per_step": kernel_wall * 1e6 / GENQ_TIMED_STEPS,
                "two_launch_device_us_per_step": (k13_ms + force_ms) * 1e3,
                "two_launch_kernel13_device_us": k13_ms * 1e3,
                "two_launch_force_device_us": force_ms * 1e3,
                "two_launch_wall_us_per_step": route_wall * 1e6 / GENQ_TIMED_STEPS,
                "launches_per_step": 1 / GENQ_TIMED_STEPS, "two_launch_launches_per_step": 2,
                "bound_us_per_step": bound_us, "bound_by": "bytes" if t_bytes >= t_ops
                else "operations", "bound_one_sm_us_per_step": bound_us * SMS,
                "bound_its_sms_us_per_step": bound_us * SMS / sms,
                "ops_per_step": {dt: n_ / GENQ_BOUND_STEPS for dt, n_ in b["ops"].items()}}
            if force == "extended3":
                pms = cuda_ms(lambda: cuda_genq.elm2_gen_scan_q_plain(tab, H, c0, m_f,
                                                                      GENQ_BOUND_STEPS, force,
                                                                      True), 1, 1)
                record.setdefault("gen_scan_q", {}).update(kernel_record(
                    max(c_["max_abs_err"] for c_ in cases), kernel_ms / GENQ_TIMED_STEPS, pms / GENQ_BOUND_STEPS,
                    {"bound_ms": bound_us / 1e3, "bound_by": timing[force]["bound_by"]}))
                record["gen_scan_q"]["per"] = "step"
        seconds["timing"] = time.perf_counter() - t_part
        ptxas = {}
        for ln in ptxas_of("gen_scan_q"):
            j = re.search(r"gen_scan_qILi(\d+)ELi(\d+)ELi(\d+)E", ln)
            if j:
                key = "order{} J{} {}".format(j.group(1), j.group(2),
                                              ("extended3", "extendedF")[int(j.group(3))])
            elif "registers" in ln or "spill" in ln:
                ptxas.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
        spills = sorted({ln for v in ptxas.values() for ln in v
                         if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
        check(len(ptxas) == 8 or not _build.build_log,
              f"phase 44: ptxas reported {sorted(ptxas)}, expected the 8 instances")
        check(not spills, f"phase 44: kernel 13-chunk spills registers: {spills}")
        print(json.dumps({"phase": 44, "kernel": "gen_scan_q (kernel 13-chunk)",
                          "max_bodies": cuda_genq.MAX_BODIES_Q, "cases": cases,
                          "generation": gens, "timing": timing, "ptxas": ptxas,
                          "ptxas_spill_lines": spills, "seconds": seconds,
                          "phase_s": time.perf_counter() - t_phase, "card": smi}))

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
            ("accel_f64", "accel_f64.cu", f"{pallas}:99"),
            ("accel_f64_rows", "accel_f64.cu", f"{pallas}:99"),
            ("accel_f64_ensemble", "accel_f64.cu", f"{pallas}:99"),
            ("elm2f_update", "elm2f_update.cu", "ephemeris_explorer_tpu/ops/pallas_elm2.py:310"),
            ("elm2f_update_shift", "elm2f_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:310"),
            ("elm2f64_update_shift", "elm2_f64_update.cu",
             "ephemeris_explorer_tpu/ops/pallas_elm2.py:310"),
            ("accel_limbs3", "accel_limbs3.cu", f"{pallas}:383"),
            ("accel_limbs3_rows", "accel_limbs3.cu", f"{pallas}:383"),
            ("accel_limbs3_f64", "accel_limbs3_f64.cu", f"{pallas}:383"),
            ("accel_limbs3_f64_pair", "accel_limbs3_f64.cu", f"{pallas}:383"),
            ("accel_limbs3_f64_rows", "accel_limbs3_f64.cu", f"{pallas}:383"),
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
            ("accel_full3", "accel_full3.cu", "ephemeris_explorer_tpu/ops/nbody_full3.py:27"),
            ("elm2q_update_shift", "elm2q_step.cu",
             "ephemeris_explorer_tpu/integrators/multistep.py:788"),
            ("fleet_scan", "fleet_scan.cu", "ephemeris_explorer_tpu/spacecraft.py:253"),
            ("gen_scan_q", "gen_scan_q.cu", "ephemeris_explorer_tpu/ephemeris.py:805"),
        )
    ]
    by_name = {k["name"]: k for k in kernels}
    by_name["accel_full3"]["note"] = ("not a Pallas kernel: the JAX package leaves this force to "
                                      "one XLA fusion")
    by_name["elm2q_update_shift"]["note"] = (
        "not a Pallas kernel: the JAX package runs elm2_step_q's update as one XLA program; the "
        "nearest TPU kernel is ephemeris_explorer_tpu/ops/pallas_elm2.py:97 (kernel 4)")
    by_name["fleet_scan"]["note"] = (
        "not a Pallas kernel: the JAX package runs propagate's nested lax.while_loops "
        "(ephemeris_explorer_tpu/spacecraft.py:253, vmapped at :715) as one XLA program; "
        "launches: the Mars mission's flight (phase 30); ms, plain_ms and bound_ms: phase 43's "
        "B = 1 Verner87 case on full_solar_system, the whole propagation (device ms by CUDA "
        "events over its launches), the bound scaled to the ship-iterations run; "
        "bound_b_sms_ms: one ship is one block on one SM")
    by_name["fleet_scan"]["bound_b_sms_ms"] = record["fleet_scan"]["bound_b_sms_ms"]
    by_name["gen_scan_q"]["note"] = (
        "not a Pallas kernel: the JAX package runs the expansion chunk body (elm2_step_q, then "
        "to_f64 of the head; ephemeris_explorer_tpu/ephemeris.py:805-812) as one XLA program; "
        "it redesigns kernels 13 and 12 (and kernel 3-f64's chain) for the unperturbed "
        "\"extended3\"/\"extendedF\" chunk (\"extendedF\" on a cluster of up to 8 blocks); "
        "launches: path A (phase 11, one a chunk); ms, plain_ms and bound_ms a step: phase "
        "44's full_solar_system \"extended3\" QT12 chunk (1,428 steps by CUDA events, one "
        "block; the plain version over 4 steps)")
    by_name["elm2q_update_shift"]["launches_note"] = (
        "phase 35 (perturbed \"extended3\"): since kernel 13-chunk the unperturbed chunks "
        "do not step through kernel 13")
    # launches on the other paths that run a form (its main path's are
    # "launches"): kernel 11-f64's in phase 7 forward and backward and in the
    # session of phase 32; kernels 3, 4 and 12's in the audit's modes (phase 38)
    for k in kernels:
        if "launches_by_phase" in record[k["name"]]:
            k["launches_by_phase"] = record[k["name"]]["launches_by_phase"]
    # kernels 11 and 11-f64 run one block: bound_ms is over the whole card,
    # the kernel on one SM of SMS
    # (kernel 13-chunk's numbers are its "extended3" chunk's, one block;
    # its "extendedF" chunk runs a cluster of up to 8)
    for k in (by_name["gen_scan"], by_name["gen_scan_f64"], by_name["gen_scan_q"]):
        k["bound_one_sm_ms"] = k["bound_ms"] * SMS
        one_sm = (f"one block on one SM: bound_ms is over the whole card, "
                  f"bound_one_sm_ms = {SMS} x bound_ms")
        k["note"] = f"{k['note']}; {one_sm}" if "note" in k else one_sm
    print(json.dumps({"smoke_s": time.perf_counter() - t_smoke, "phases": len(phases)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
