#!/usr/bin/env python3
"""Where the time goes on the port's step and force loops, on one NVIDIA GPU.

    python3 profile_port.py [--loops A,B,C,D,F,G,H] [--out FILE]

Profiles these loops with ``torch.profiler`` (CPU and CUDA activity):

* path B fused: 50 steps of ``elm2_step_qf(precise_sums=True)`` at N = 4096
  (kernel 4 then kernel 3 each step), as ``chip_smoke.py`` phase 10 runs it;
* path B unfused: 10 steps of ``elm2_step_q(precise_sums=True)`` with kernel
  3 as the force (the eager expansion chain);
* path A: one 144-step chunk of ``NBodyPropagator(precision="extended3")``
  on full_solar_system, after a first chunk that runs the startup;
* path C: 400 force evaluations of each rung of the force-mode ladder at
  N = 4096 (f32: kernel 5; mixed: kernel 6; split, K = 16: kernels 7 and 8,
  the strong set built once), as ``chip_smoke.py`` phase 16 runs them;
* path D: one 50-step scan of ``make_fused_ensemble_scan_f`` at E = 16 x
  N = 4096 (kernel 1's ensemble form then kernel 2 each step), as
  ``chip_smoke.py`` phase 20 runs it (``bench.py``'s ensemble16x4096);
* path F: one ``CHUNK_STEPS`` chunk of full_solar_system through kernel 11
  (``elm2_gen_scan``, one launch), as ``chip_smoke.py`` phase 25 runs it;
* path G: 400 evaluations of kernel 10's f64 drop-in at N = 4096, as
  ``chip_smoke.py`` phase 26 runs them;
* path H: one 50-step scan of ``make_fused_ensemble_scan_fp`` at E = 16 x
  N = 4096 (kernel 1's ensemble form then kernel 2'), as phase 27 runs it.

``--loops`` picks the paths (default all seven).  For each: wall µs per step (synchronised host timer around the profiled
loop), device µs per step (the sum of the CUDA kernels' self time), the
idle share 1 - device / wall, and the kernels by device time with their
launches per step.  Each loop is also timed without the profiler.  Prints
one JSON line per loop and writes all of them, with the card's
``nvidia-smi`` name and power limit, to ``--out``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOP = 12


def _device_events(prof, torch):
    """(name, self device µs, count) of the CUDA-side events, largest first."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.device_type == cuda and e.self_device_time_total > 0]
    return sorted(out, key=lambda x: -x[1])


def profile_loop(torch, name: str, body, steps: int, sync) -> dict:
    """Profile `body()` (which runs `steps` steps), then time it unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    body()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        sync()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    body()
    sync()
    unprofiled = time.perf_counter() - t0
    events = _device_events(prof, torch)
    if not events:
        raise SystemExit(f"profile_port: {name}: the profiler recorded no device time")
    device_us = sum(us for _, us, _ in events)
    wall_us = wall * 1e6
    return {
        "loop": name, "steps": steps,
        "wall_us_per_step": wall_us / steps,
        "device_us_per_step": device_us / steps,
        "idle_share": 1.0 - device_us / wall_us,
        "unprofiled_us_per_step": unprofiled * 1e6 / steps,
        "launches_per_step": sum(c for _, _, c in events) / steps,
        "top": [{"kernel": k[:120], "us_per_step": us / steps, "share": us / device_us,
                 "calls_per_step": c / steps} for k, us, c in events[:TOP]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loops", default="A,B,C,D,F,G,H")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_port.json"))
    args = ap.parse_args(argv)
    paths = set(args.loops.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ENS_SCAN_STEPS, ENSEMBLE, H, N_BODIES, _cluster, ladder_loops
    from ephemeris_explorer_tpu_torch import ephemeris as eph
    from ephemeris_explorer_tpu_torch.integrators import get
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.io import scene
    from ephemeris_explorer_tpu_torch.ops import cuda_gen, cuda_limbs, cuda_nbody, cuda_sym, nbody
    from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize
    f64 = torch.float64
    tab = get("QuinlanTremaine12")

    pos, vel, mu = _cluster(N_BODIES)
    mu_dev = torch.as_tensor(mu, dtype=f64, device=dev)
    mh, ml = cuda_nbody.split_f64(mu_dev.reshape(1, -1))

    def accel_pair(t, limbs):
        return cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)

    def accel_limbs(t, limbs):
        return cuda_nbody.combine_f64(*accel_pair(t, limbs))

    results = []
    if "B" in paths:
        q0 = ms.elm2_init_q(tab, None, 0.0, torch.as_tensor(pos, dtype=f64, device=dev),
                            torch.as_tensor(vel, dtype=f64, device=dev), H,
                            accel_limbs=accel_limbs)
        qf0 = ms.elm2_qf_from_q(q0)

        def fused(steps):
            def body():
                c = qf0
                for _ in range(steps):
                    c = ms.elm2_step_qf(tab, accel_pair, H, c, precise_sums=True)
            return body

        def unfused(steps):
            def body():
                c = q0
                for _ in range(steps):
                    c = ms.elm2_step_q(tab, None, H, c, accel_limbs=accel_limbs,
                                       with_velocity=False, precise_sums=True)
            return body

        results += [profile_loop(torch, "path_B_fused_step", fused(50), 50, sync),
                    profile_loop(torch, "path_B_unfused_step", unfused(10), 10, sync)]
    if "A" in paths:
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        prop = eph.NBodyPropagator(fss.state, fss.settings, precision="extended3", device=dev)
        prop.step_chunk(144)  # the startup chunk; each profiled call is one more chunk
        results.append(profile_loop(torch, "path_A_extended3_chunk",
                                    lambda: prop.step_chunk(144), 144, sync))
    if "C" in paths:
        p64 = torch.as_tensor(pos, dtype=f64, device=dev)
        for mode, (loop, start, _) in ladder_loops(p64, mu_dev).items():
            results.append(profile_loop(torch, f"path_C_{mode}_eval",
                                        lambda: loop(start, 400), 400, sync))
    if "D" in paths:
        ens_pos = np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(ENSEMBLE)])
        ens_vel = np.stack([_cluster(N_BODIES, seed=i)[1] for i in range(ENSEMBLE)])
        carry0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, ens_pos, ens_vel, H, device=dev)
        run, to_f = sh.make_fused_ensemble_scan_f(tab, mu, H, ENS_SCAN_STEPS, device=dev)
        f0 = to_f(carry0)
        results.append(profile_loop(torch, "path_D_ensemble16x4096_step", lambda: run(f0),
                                    ENS_SCAN_STEPS, sync))
    if "F" in paths:
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        fmu = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
        c0 = ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, fmu), 0.0,
                          torch.as_tensor(fss.state.positions(), dtype=f64, device=dev),
                          torch.as_tensor(fss.state.velocities(), dtype=f64, device=dev), H)
        mu_pair = TwoFloat(*cuda_nbody.split_f64(fmu.reshape(1, -1)))
        results.append(profile_loop(
            torch, "path_F_full_solar_system_chunk",
            lambda: cuda_gen.elm2_gen_scan(tab, H, c0, mu_pair, eph.CHUNK_STEPS),
            eph.CHUNK_STEPS, sync))
    if "G" in paths:
        p64 = torch.as_tensor(pos, dtype=f64, device=dev)

        def sym_loop():
            p = p64
            for _ in range(400):
                p = p + cuda_sym.pairwise_accel_sym(p, mh, ml) * 1e-30

        results.append(profile_loop(torch, "path_G_kernel10_eval", sym_loop, 400, sync))
    if "H" in paths:
        ens_pos = np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(ENSEMBLE)])
        ens_vel = np.stack([_cluster(N_BODIES, seed=i)[1] for i in range(ENSEMBLE)])
        carry0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, ens_pos, ens_vel, H, device=dev)
        run, to_fp = sh.make_fused_ensemble_scan_fp(tab, mu, H, ENS_SCAN_STEPS,
                                                    (ENSEMBLE, N_BODIES, 3), device=dev)
        fp0 = to_fp(carry0)
        results.append(profile_loop(torch, "path_H_packed_ensemble16x4096_step",
                                    lambda: run(fp0), ENS_SCAN_STEPS, sync))
    for r in results:
        print(json.dumps({k: v for k, v in r.items() if k != "top"} | {"card": smi}))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "loops": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
