#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``ephemeris_explorer_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's main path: QT12 generation of fitted, evaluable ephemerides at
N = 4096 through both kernels, and the bundled full_solar_system scene.
Each phase prints one line; the line before the last is the kernels' JSON
record and the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits nonzero and prints no result.  Without a
CUDA device it exits nonzero at once.  It imports no JAX.

``--phases`` runs a subset (for debugging; the result lines are printed only
when all phases ran).
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
N_BODIES = 4096
H = 600.0              # step, seconds
FLAGSHIP_STEPS = 400
GEN_STEPS = 2048
GEN_CHUNK = 1024

KERNEL1_VS_PLAIN = 1e-13   # max|d| / max|ref|, kernel 1 against its plain version
KERNEL1_VS_F64 = 1e-12     # against native f64 (test_pallas_accel_matches_f64's bar)
# ... except on full_solar_system: the two-float positions round at 2^-48 of
# the heliocentric radius, ~1e-10 of the Phobos-Mars separation; the JAX
# package's kernel shows 5.2e-12 there too (3-limb positions fix it, kernel 3)
KERNEL1_VS_F64_FSS = 1e-11
KERNEL2_BOUND = 2.0**-48   # times max|y|; same ops in the same order: expect bitwise
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
# CUDA's f64 rsqrt is not correctly rounded, so the CUDA and CPU runs part at
# the ulp level; the multistep grows that over 4320 steps to ~1e-13 of the
# positions.  Coefficients are compared in sample space (see _coeff_err).
FSS_BOUND = 1e-10


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


def _raw_coeff_err(a: dict, b: dict) -> float:
    return max(
        float(np.abs(a[n] - b[n]).max() / np.abs(a[n]).max()) for n in a if a[n].size
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

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
    from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_nbody, nbody
    from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat

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

    record = {}

    # -- phase 2: build -------------------------------------------------------
    if 2 in phases:
        t0 = time.perf_counter()
        _build.library()
        regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
                if "registers" in ln]
        print(json.dumps({"phase": 2, "build_s": round(time.perf_counter() - t0, 3),
                          "ptxas": regs, "card": smi}))

    pos, vel, mu = _cluster(N_BODIES)
    mu_dev = torch.as_tensor(mu, dtype=f64, device=dev)
    mu_hi, mu_lo = cuda_nbody.split_f64(mu_dev.reshape(1, -1))

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
            k = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml))
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
                record["accel_df64"] = {"max_abs_err": abs_err, "ms": kms, "plain_ms": pms}
        print(json.dumps({"phase": 3, "kernel": "accel_df64", "cases": out, "card": smi}))

    # QT12 startup at N=4096 in native f64 (shared by phases 4 and 5)
    if phases & {4, 5}:
        def accel(t, y):
            return nbody.pairwise_accel(y, mu_dev)

        def accel_pair(t, y: TwoFloat) -> TwoFloat:
            return TwoFloat(*cuda_nbody.pairwise_accel_df64(
                y.hi.t().contiguous(), y.lo.t().contiguous(), mu_hi, mu_lo))

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
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(yk.hi, yp.hi) and torch.equal(yk.lo, yp.lo))
            diff = ((yk.hi.to(f64) - yp.hi.to(f64)) + (yk.lo.to(f64) - yp.lo.to(f64))).abs().max().item()
            ymax = c.ys[0].abs().max().item()
            check(diff <= KERNEL2_BOUND * ymax, f"kernel 2 vs plain on {name}: {diff} > 2^-48 max|y|")
            kms = cuda_ms(lambda: cuda_elm2.elm2f_update(tab, H, f.ys, f.dd), 200)
            pms = cuda_ms(lambda: cuda_elm2.elm2f_update_plain(coef, c_y, f.ys, f.dd), 20)
            gms = graph_ms(lambda: cuda_elm2.elm2f_update(tab, H, f.ys, f.dd), 200)
            out.append({"input": name, "m": f.ys.hi[0].numel(), "bitwise": bitwise,
                        "max_abs_err": diff,
                        "why_not_bitwise": None if bitwise else "results differ; within 2^-48 max|y|",
                        "kernel_us": kms * 1e3, "kernel_device_us": gms * 1e3,
                        "plain_us": pms * 1e3})
            if name == "cluster4096":
                record["elm2f_update"] = {"max_abs_err": diff, "ms": kms, "plain_ms": pms}
        print(json.dumps({"phase": 4, "kernel": "elm2f_update", "cases": out, "card": smi}))

    # -- phase 5: flagship step ----------------------------------------------
    if 5 in phases:
        def plain_step(c):
            return ms.elm2_step(tab, accel, H, c, with_velocity=False)

        def fused_step(c):
            return ms.elm2_step_f(tab, accel_pair, H, c)

        def run(step, c, steps):
            """`steps` steps; also returns the ring head after EARLY_STEPS."""
            early = None
            for i in range(steps):
                c = step(c)
                if i + 1 == EARLY_STEPS:
                    early = c.ys[0] if isinstance(c.ys, torch.Tensor) else (c.ys.hi[0], c.ys.lo[0])
            return c, early

        run(plain_step, carry0, 2), run(fused_step, ms.elm2_f_from(carry0), 2)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp, yp_early = run(plain_step, carry0, FLAGSHIP_STEPS)
        cp = cp._replace(dy=ms.elm2_velocity(tab, cp, H))
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        cf, yf_early = run(fused_step, ms.elm2_f_from(carry0), FLAGSHIP_STEPS)
        cf = cf._replace(dy=ms.elm2_velocity_f(tab, cf, H))
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
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
            "plain_f64_body_steps_per_s": N_BODIES * FLAGSHIP_STEPS / t_plain, "card": smi,
        }))

    # -- phase 6: generation at N=4096 through both kernels -------------------
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

        check(eph._use_fused_f(N_BODIES, dev), "the fused branch is not taken at N=4096")
        cuda_nbody.pairwise_accel_df64.launches = 0
        cuda_elm2.elm2f_update.launches = 0
        t0 = time.perf_counter()
        e_fused = generate()
        t_fused = time.perf_counter() - t0
        launches = {"accel_df64": cuda_nbody.pairwise_accel_df64.launches,
                    "elm2f_update": cuda_elm2.elm2f_update.launches}
        check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

        fused_gate = eph._use_fused_f
        eph._use_fused_f = lambda n, d: False
        t0 = time.perf_counter()
        e_plain = generate()
        t_plain = time.perf_counter() - t0
        eph._use_fused_f = fused_gate

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
            "first_segment_coeff_err": err, "bound": EARLY_BOUND,
            "all_segments_coeff_err": _coeff_err(cp, cf, settings),
            "fused_body_steps_per_s": N_BODIES * GEN_STEPS / t_fused,
            "plain_f64_body_steps_per_s": N_BODIES * GEN_STEPS / t_plain, "card": smi,
        }))
        for k, v in launches.items():
            record.setdefault(k, {})["launches"] = v

    # -- phase 7: full_solar_system, one year --------------------------------
    if 7 in phases:
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        year = port.Duration.from_days(365.25)
        eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(2), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_gpu = eph.generate_ephemeris(fss.state, fss.settings, year, device=dev)
        torch.cuda.synchronize()
        t_year = time.perf_counter() - t0
        e_cpu = eph.generate_ephemeris(fss.state, fss.settings, port.Duration.from_days(30))
        c_cpu = {n: e_cpu[n].coeffs for n in e_cpu.names}
        c_gpu = {n: e_gpu[n].coeffs[: c_cpu[n].shape[0]] for n in e_cpu.names}
        err = _coeff_err(c_cpu, c_gpu, fss.settings)
        t_end = e_gpu.end.as_offset_seconds()
        check(np.isfinite(e_gpu.positions(t_end)).all(), "full_solar_system positions not finite")
        check(err <= FSS_BOUND, f"full_solar_system CUDA vs CPU: {err}")
        print(json.dumps({
            "phase": 7, "scene": "full_solar_system_2433282.5", "n": fss.state.n,
            "sim_days": 365.25, "sim_days_per_s": 365.25 / t_year,
            "coeff_err_vs_cpu_30d": err, "raw_coeff_err_vs_cpu_30d": _raw_coeff_err(c_cpu, c_gpu),
            "bound": FSS_BOUND, "card": smi,
        }))

    if phases != {1, 2, 3, 4, 5, 6, 7}:
        return 0
    kernels = [
        {"name": "accel_df64", "route": "cuda",
         "source": "ephemeris_explorer_tpu_torch/csrc/accel_df64.cu",
         "replaces": "ephemeris_explorer_tpu/ops/pallas_nbody.py:99", **record["accel_df64"]},
        {"name": "elm2f_update", "route": "cuda",
         "source": "ephemeris_explorer_tpu_torch/csrc/elm2f_update.cu",
         "replaces": "ephemeris_explorer_tpu/ops/pallas_elm2.py:310", **record["elm2f_update"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
