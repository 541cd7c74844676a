#!/usr/bin/env python3
"""Where kernel 14's time goes inside an iteration, on one NVIDIA GPU.

    python3 tools/fleet_scan_timeline.py [--method Verner87] [--out FILE]

Applies ``tools/fleet_scan_clocks.patch`` (the clock stamps) to a copy of
``ephemeris_explorer_tpu_torch/csrc/fleet_scan.cu`` and builds it with the
port's nvcc flags into a library of its own under ``build/timeline/``
(never the port's; it stops with a message where a hunk no longer matches
the kernel's source), flies ``chip_smoke.py`` phase 43's case through it
(one ship in a low Earth orbit on 40 days of full_solar_system, two 300 s
TNB burns, 6 h), bitwise to the port's kernel 14 on the same inputs, and
reads the lead lane's clock64 stamps of the first 256 iterations: the
cycles an iteration spends before its stages, waiting for its first
stage's bodies, in each stage (and in the parts of stage 6: its state, the
gravity, the lane sums with the burn, the store of k_s and the new state's
and error's terms), in the controller and in the commit, as medians over
the iterations that attempt a step, and the SM clock (clock64 cycles over
the global timer across the launch).  Prints one JSON line (with the
card's ``nvidia-smi`` name and power limit) and writes it to ``--out``.
Imports no JAX; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PATCH = ROOT / "tools" / "fleet_scan_clocks.patch"
# the patch's marks (kMark*): the iteration's, each stage's start, and
# inside stage PROBE_STAGE its state, gravity, lane sums and end
CLOCK_ITERS, MARKS, MAX_STAGES, PROBE_STAGE = 256, 28, 16, 6
MARK_TOP, MARK_STAGES, MARK_STAGE0 = 0, 1, 2
MARK_SUMS = MARK_STAGE0 + MAX_STAGES
(MARK_CONTROL, MARK_END, MARK_WINDOW, MARK_WINDOW_DONE, MARK_STATE, MARK_GRAVITY,
 MARK_LANE_SUMS, MARK_STAGE_END) = range(MARK_SUMS + 1, MARK_SUMS + 9)


def stamped_source(src: str, patch: str, name: str = PATCH.name) -> str:
    """``src`` with the unified diff ``patch`` (the file ``name``) applied:
    each hunk's old lines (context and removals) found in order and replaced
    by its new ones."""
    lines = src.splitlines(keepends=True)
    out, pos = [], 0
    for k, hunk in enumerate(re.split(r"^@@[^\n]*\n", patch, flags=re.M)[1:]):
        body = [ln for ln in hunk.splitlines(keepends=True) if ln[:1] in " -+"]
        old = [ln[1:] for ln in body if ln[0] in " -"]
        new = [ln[1:] for ln in body if ln[0] in " +"]
        at = next((i for i in range(pos, len(lines) - len(old) + 1)
                   if lines[i:i + len(old)] == old), None)
        if at is None:
            raise SystemExit(f"hunk {k + 1} of {name} no longer matches the kernel's source")
        out += lines[pos:at] + new
        pos = at + len(old)
    return "".join(out + lines[pos:])


def build() -> ctypes.CDLL:
    """fleet_scan.cu with the clock stamps, as a library of its own."""
    sys.path.insert(0, str(ROOT))
    from ephemeris_explorer_tpu_torch import _build

    text = stamped_source((_build.CSRC / "fleet_scan.cu").read_text(), PATCH.read_text())
    flags = [*_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC)]
    headers = b"".join(p.read_bytes() for p in sorted(_build.CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text.encode() + headers + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = ROOT / "build" / "timeline" / digest / "libfleet_timeline.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        src = lib_path.parent / "fleet_scan_clocks.cu"
        src.write_text(text)
        subprocess.run([_build._nvcc(), *flags, "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.eet_fleet_scan.argtypes = _build.library().eet_fleet_scan.argtypes
    lib.eet_fleet_scan.restype = ctypes.c_int
    lib.eet_fleet_clocks.argtypes = [ctypes.c_void_p]
    lib.eet_fleet_clocks.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="Verner87")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "fleet_scan_timeline.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fleet_scan_timeline: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ephemeris_explorer_tpu_torch import Duration, Epoch, _build
    from ephemeris_explorer_tpu_torch import ephemeris as eph
    from ephemeris_explorer_tpu_torch import spacecraft as sc_
    from ephemeris_explorer_tpu_torch.integrators import get
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams
    from ephemeris_explorer_tpu_torch.io import scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sc = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
    e = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0), device=dev)
    packed = e.pack(dev)
    index = {n: i for i, n in enumerate(e.names)}
    t0 = sc.state.epoch.as_offset_seconds()
    ep, ev = e["Earth"].state_vector(t0)
    v_circ = float(np.sqrt(sc.state.bodies[index["Earth"]].mu / 7000.0))
    tl = sc_.stack_timelines([sc_.build_timeline([
        scene.ShipBurn(start=Epoch.from_offset_seconds(t0 + 1800.0 + j * 7200.0),
                       duration=Duration.from_seconds(300.0),
                       acceleration=np.array([2e-3, -1e-3, 5e-4]), reference="Earth")
        for j in range(2)], index)])
    inputs = (tl, np.array([t0]), (ep + np.array([7000.0, 0.0, 0.0]))[None],
              (ev + np.array([0.0, v_circ, 0.0]))[None], np.array([t0 + 6 * 3600.0]))
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
    tab = get(args.method)
    ref = sc_.propagate_batch(tab, packed, *inputs, params, max_knots=1024)
    lib = build()
    stamps = np.zeros(CLOCK_ITERS * MARKS + 4, dtype=np.int64)
    orig = _build.library
    _build.library = lambda: lib
    try:
        got = sc_.propagate_batch(tab, packed, *inputs, params, max_knots=1024)
        torch.cuda.synchronize()
        _build.check(lib.eet_fleet_clocks(stamps.ctypes.data), "eet_fleet_clocks")
    finally:
        _build.library = orig
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    if not same:
        raise SystemExit("fleet_scan_timeline: the stamped kernel differs from kernel 14")
    s = stamps[:CLOCK_ITERS * MARKS].reshape(CLOCK_ITERS, MARKS).astype(np.float64)
    c0, n0, c1, n1 = stamps[CLOCK_ITERS * MARKS:]
    # the iterations that attempted a step (the others stamp no sums)
    s = s[(s[:, MARK_TOP] > 0) & (s[:, MARK_END] > s[:, MARK_TOP]) & (s[:, MARK_SUMS] > 0)]
    stages = tab.stages
    stage_cycles = [float(np.median(s[:, MARK_STAGE0 + k + 1] - s[:, MARK_STAGE0 + k]))
                    for k in range(stages - 1)]
    stage_cycles.append(float(np.median(s[:, MARK_SUMS] - s[:, MARK_STAGE0 + stages - 1])))
    windowed = s[s[:, MARK_WINDOW_DONE] > s[:, MARK_TOP]]
    out = {
        "tool": "fleet_scan_timeline", "method": tab.name, "stages": stages,
        "bitwise_to_kernel14": same,
        "iterations_stamped": int(len(s)),
        "sm_mhz": (c1 - c0) / (n1 - n0) * 1e3 if n1 > n0 else None,
        "cycles_per_iteration": float(np.median(s[:, MARK_END] - s[:, MARK_TOP])),
        "before_stages": float(np.median(s[:, MARK_STAGES] - s[:, MARK_TOP])),
        "window": float(np.median(windowed[:, MARK_WINDOW_DONE] - windowed[:, MARK_WINDOW])),
        "stage_cycles_median": stage_cycles,
        "stages_total": float(np.median(s[:, MARK_SUMS] - s[:, MARK_STAGE0])),
        "probe_stage": PROBE_STAGE,
        "probe_stage_parts": {
            name: float(np.median(s[:, b] - s[:, a])) for name, a, b in (
                ("state", MARK_STAGE0 + PROBE_STAGE, MARK_STATE),
                ("gravity", MARK_STATE, MARK_GRAVITY),
                ("lane_sums_burn", MARK_GRAVITY, MARK_LANE_SUMS),
                ("store_and_sums", MARK_LANE_SUMS, MARK_STAGE_END),
                # the last stage ends where the sums begin
                ("to_next_stage", MARK_STAGE_END, MARK_STAGE0 + PROBE_STAGE + 1
                 if PROBE_STAGE + 1 < stages else MARK_SUMS))},
        "new_state_error_and_control": float(np.median(s[:, MARK_CONTROL] - s[:, MARK_SUMS])),
        "commit_and_end": float(np.median(s[:, MARK_END] - s[:, MARK_CONTROL])),
        "card": smi,
    }
    print(json.dumps(out))
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
