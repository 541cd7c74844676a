#!/usr/bin/env python3
"""Where the time goes on the port's step and force loops, on one NVIDIA GPU.

    python3 profile_port.py [--loops A,AF,B,C,D,F,F64,FS,G,H,K,L,M,P,S,W,Y] [--out FILE] [--root DIR]

Profiles these loops with ``torch.profiler`` (CPU and CUDA activity):

* FS: 50 steps of the fused two-float F step at N = 4096 (``elm2_step_f``:
  kernel 2's shift entry, two transposes, kernel 1 writing the new force
  row), as ``chip_smoke.py`` phase 5 runs it, and 50 of the step before
  the fold (kernel 2's update entry, kernel 1, four concatenations);

* F64: 400 native-f64 steps at N = 4096 (``elm2_step`` on the card: kernel
  2-f64, kernel 1-f64 writing the new force row), as ``chip_smoke.py``
  phase 5 runs it, and 400 of the eager step before kernel 2-f64
  (``multistep._step_cat``: the eager update, kernel 1-f64, two
  concatenations), where that checkout has it;

* path B fused: 50 steps of ``elm2_step_qf(precise_sums=True)`` at N = 4096
  (kernel 4 then the 3-limb route's pair force, kernel 3-f64, each step),
  as ``chip_smoke.py`` phase 10 runs it, and 50 with kernel 3 as the force
  (the route before kernel 3-f64, or a checkout without it);
* path B unfused: 10 steps of ``elm2_step_q(precise_sums=True)`` with the
  route's force (kernel 13 then kernel 3-f64 on the card; the eager
  expansion chain before kernel 13);
* path A: one 144-step chunk of ``NBodyPropagator(precision="extended3")``
  on full_solar_system, after a first chunk that runs the startup: through
  kernel 13-chunk (one launch a chunk), and, where the checkout has that
  kernel, again with its gate ``ephemeris._use_gen_kernel_q`` patched off
  as ``..._two_launch`` (kernel 13 and kernel 3-f64 a step, the route
  before it);
* AF: the same chunk at ``precision="extendedF"`` (kernel 13-chunk; kernel
  13 and kernel 12 a step on the two-launch route), as ``chip_smoke.py``
  phase 34 runs it;
* path C: 400 force evaluations of each rung of the force-mode ladder at
  N = 4096 (f32: kernel 5; mixed: kernel 6; split, K = 16: kernels 7 and 8,
  the strong set built once), as ``chip_smoke.py`` phase 16 runs them, and
  of the split rung with ``corr="dd"`` (kernels 7 and 9), as phase 19 runs
  it, with the launches an evaluation of each rung;
* path D: one 50-step scan of ``make_fused_ensemble_scan_f`` at E = 16 x
  N = 4096 (kernel 1's ensemble form then kernel 2 each step), as
  ``chip_smoke.py`` phase 20 runs it (``bench.py``'s ensemble16x4096);
* path F: one ``CHUNK_STEPS`` chunk of full_solar_system through kernel 11
  (``elm2_gen_scan``, one launch), as ``chip_smoke.py`` phase 25 runs it;
* path G: 400 evaluations of kernel 10's f64 drop-in at N = 4096, as
  ``chip_smoke.py`` phase 26 runs them;
* path H: one 50-step scan of ``make_fused_ensemble_scan_fp`` at E = 16 x
  N = 4096 (kernel 1's ensemble form then kernel 2'), as phase 27 runs it;
* K: one ``CHUNK_STEPS`` chunk of full_solar_system through kernel 11-f64
  (``elm2_gen_scan_f64``, one launch);
* Y: a year of full_solar_system at ``"f64"`` through ``generate_ephemeris``
  (startup, kernel 11-f64 a chunk, the fit passes), as ``chip_smoke.py``
  phase 7 runs it; its steps are the year's 52,560;
* P: fleet64's propagation, ``propagate_ships`` of ``chip_smoke.py``'s 64
  ships in one batch, as phase 31 runs it, through kernel 14 (the card's
  route, one launch a host read) and through the eager loop
  (``spacecraft.propagate_batch_plain``, the route before kernel 14), where
  that checkout has both; its steps are the fleet loop's iterations (each
  advances every live ship by one attempt);
* M: the Mars Transfer Ship's first ``MISSION_COUNT_DAYS`` on 440 days of
  full_solar_system (``propagate_ship``, B = 1), as phase 30 flies it,
  through kernel 14 and through the eager loop, steps as P's;
* W (not a default): wall seconds of whole flights, each through kernel 14
  and through the eager loop in turns (kernel, eager, kernel; with
  ``--no-eager`` ``W_RUNS`` runs through kernel 14): the Mars Transfer Ship
  to ``MISSION_UNTIL`` on 440 days of full_solar_system, as phase 30 flies
  it (~2-3 min through the eager loop), a full replan of it to
  ``SESSION_UNTIL`` by ``api.Universe`` (respawned, so nothing is reused),
  as phase 32's first replan, and fleet64 as phase 31 flies it (with its
  ship-days/s).  Each run's wall seconds are split into the fleet loop's
  route (``spacecraft._propagate_batch_kernel``, synchronised at its end)
  and the host work around it; not profiled;
* S (not a default): kernels 5, 6 and 7 at N = 4096 on each launch geometry
  of ``GEOMETRIES`` (warps a block x blocks a receiver group), device µs per
  call by CUDA-graph replay, not profiled;
* L (not a default): kernel 14's chain bound.  ``tools/latency_probe.cu``
  (built here with the port's flags) times dependent chains of each
  instruction kind with clock64 on one warp; the longest dependent path
  through one pass of the stage loop (the loop with the lane-sum trees) of
  ``fleet_scan_kernel<tableau::Verner87>`` in ``cuobjdump -sass`` of the
  checkout's built library, each instruction weighted by its kind's latency
  (branches' both arms, so the stage-state tree's longest row; inner loops
  once), times the 13 stages, is the chain bound of an iteration;
  with M in the same call, its share of M's device µs an iteration.  Not
  profiled.

``--loops`` picks the paths (default the fourteen profiled ones);
``--no-eager`` flies P, M and W through the card's route alone.  ``--root``
imports the package (and ``chip_smoke.py``'s constants) from another
checkout, to profile an older commit with this script in the same call;
the FS loop's force then writes ``out`` only where that checkout's step
takes it (``multistep.writes_into``).  For each: wall µs per step (synchronised host timer around the profiled
loop), device µs per step (the sum of the CUDA kernels' self time), the
idle share 1 - device / wall, and the kernels by device time with their
launches per step.  Each loop is also timed without the profiler.  Prints
one JSON line per loop and writes all of them, with the card's
``nvidia-smi`` name and power limit, to ``--out``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOP = 12
# the F64 loop's steps: a window of 50 (~10 ms) recorded 41 of each kernel's
# 50 launches on an H100, a longer one loses less of that start
F64_STEPS = 400


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


def _graph_us(torch, fn, reps: int = 20) -> float:
    """Device µs per call: `reps` calls captured in one CUDA graph, replayed."""
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
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


# (warps a block, blocks a receiver group) of kernels 5-7 swept by --loops S
W_RUNS = 7
GEOMETRIES = ((8, 8), (8, 4), (4, 8), (8, 16), (4, 16), (8, 12), (8, 6))


def geometry_sweep(torch, pos, mu, dev) -> list:
    """Kernels 5, 6 and 7 (K = 16 strong mask, diagonal in it) at N = 4096 on
    every geometry of GEOMETRIES, called through the library with the
    geometry given, each result checked bitwise for two calls: device µs
    per call."""
    from chip_smoke import STRONG_K
    from ephemeris_explorer_tpu_torch import _build
    from ephemeris_explorer_tpu_torch.ops import cuda_nbody, split

    lib = _build.library()
    p64 = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    m64 = torch.as_tensor(mu, dtype=torch.float64, device=dev)
    n = p64.shape[0]
    ph, pl = cuda_nbody.split_f64(p64, transpose=True)
    p32, m32 = p64.float(), m64.float().reshape(1, -1)
    mask = split.strong_pair_mask(split.strong_pair_indices(p64, m64, k=STRONG_K), n)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    part = torch.empty((max(b for _, b in GEOMETRIES), n, 3), dtype=torch.float32, device=dev)
    groups = -(-n // cuda_nbody.F32_PAIR_GROUP)

    def stream():  # the current stream, which a graph capture replaces
        return torch.cuda.current_stream(dev).cuda_stream

    def args():
        s = stream()
        return s, cuda_nbody._pair_counters(dev, s, groups).data_ptr()

    calls = {
        "accel_f32": lambda w, b: lib.eet_accel_f32(
            p32.data_ptr(), m32.data_ptr(), part.data_ptr(), args()[1], out.data_ptr(), n, w, b,
            stream()),
        "accel_mixed": lambda w, b: lib.eet_accel_mixed(
            ph.data_ptr(), pl.data_ptr(), m32.data_ptr(), part.data_ptr(), args()[1],
            out.data_ptr(), n, w, b, stream()),
        "accel_f32_masked": lambda w, b: lib.eet_accel_f32_masked(
            p32.data_ptr(), m32.data_ptr(), p32.data_ptr(), mask.data_ptr(), part.data_ptr(),
            args()[1], out.data_ptr(), n, n, w, b, 1, stream()),
    }
    rows = []
    for name, call in calls.items():
        for w, b in GEOMETRIES:
            _build.check(call(w, b), name)
            first = out.clone()
            _build.check(call(w, b), name)
            torch.cuda.synchronize()
            rows.append({"kernel": name, "n": n, "warps": w, "blocks": b, "splits": w * b,
                         "device_us": _graph_us(torch, lambda: call(w, b)),
                         "two_calls_bitwise": bool(torch.equal(first, out)),
                         "default": (w, b) == cuda_nbody._f32_pair_geometry(n)})
    return rows


# tools/latency_probe.cu's chains, in its order, and the SASS opcodes each
# latency weights in the chain walk (DP: the f64 pipe; other ALU
# instructions take the integer chain's per-instruction latency; barriers,
# branches and calls none)
PROBE_NAMES = ("DADD", "DMUL", "DFMA", "MUFU.RSQ64H", "ddiv", "dsqrt+DADD", "rsqrt_f64",
               "SHFL_double+DADD", "LDS.32", "LDS.64+F2I+LOP", "IMAD+LOP3")
PROBE_REPS = 4096
CHAIN_KERNEL, CHAIN_STAGES = "fleet_scan_kernelIN7tableau8Verner87E", 13
NO_WEIGHT = ("BRA", "BAR", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC", "NOP", "YIELD",
             "MEMBAR", "DEPBAR", "BPT")


def latency_probe(torch) -> dict:
    """Cycles an operation of each chain of ``tools/latency_probe.cu`` on
    one warp, and the SM clock the chains ran at (MHz)."""
    import ctypes
    import hashlib
    import os

    src = ROOT / "tools" / "latency_probe.cu"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false", "-shared",
             "-Xcompiler", "-fPIC"]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = ROOT / "build" / "probe" / digest / "liblatency_probe.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
        subprocess.run([str(nvcc), *flags, "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    out = (ctypes.c_longlong * (len(PROBE_NAMES) + 1))()
    err = lib.eet_latency_probe(out, ctypes.c_int(PROBE_REPS))
    if err:
        raise SystemExit(f"profile_port: the latency probe failed (cudaError_t {err})")
    cycles = {name: out[i] / PROBE_REPS for i, name in enumerate(PROBE_NAMES)}
    cycles["SHFL"] = cycles["SHFL_double+DADD"] - cycles["DADD"]
    cycles["ALU"] = cycles["IMAD+LOP3"] / 2
    return {"cycles": cycles, "sm_mhz": out[len(PROBE_NAMES)] / 1e3}


def _weight(op: str, cycles: dict) -> tuple:
    """(kind, cycles) of one SASS opcode in the chain walk."""
    base = op.split(".")[0]
    if base in NO_WEIGHT or base.startswith("ST"):
        return "none", 0.0
    if base in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"):
        return "DP", cycles["DADD"] if base != "DFMA" else cycles["DFMA"]
    if base == "MUFU":
        return "MUFU", cycles["MUFU.RSQ64H"]
    if base == "SHFL":
        return "SHFL", cycles["SHFL"]
    if base in ("LDS", "LDSM"):
        return "LDS", cycles["LDS.32"]
    if base in ("LDG", "LD", "LDC", "ULDC"):
        return "LD", cycles["LDS.32"]
    return "ALU", cycles["ALU"]


def stage_chain(sass: str, kernel: str, cycles: dict) -> dict:
    """The longest dependent path through one pass of the stage loop of
    ``kernel`` (the smallest loop holding both the lane-sum trees' SHFL.BFLY
    and MUFU.RSQ64H) in
    ``cuobjdump -sass`` text: basic blocks in address order, a register's
    depth at a block's entry the largest over the forward edges into it,
    each instruction adding its kind's latency (``_weight``) to the deepest
    register or predicate it reads, its guard included.  Returns the path's
    cycles and its instructions by kind."""
    body = next((b for b in re.split(r"\n\s*Function : ", sass)[1:]
                 if kernel in b.split("\n", 1)[0]), None)
    if body is None:
        return {"kernel": kernel, "error": "no such function in the SASS"}
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

    def target(text):
        tgt = re.search(r"`\((\.L_x_\d+)\)", text)
        if tgt:
            return labels.get(tgt.group(1))
        hexa = re.search(r"0x([0-9a-f]+)\s*$", text)
        return addr_at.get(int(hexa.group(1), 16)) if hexa else None

    def opcode(text):
        return re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split(" ")[0]

    # the main line ends at the last EXIT: past it lie the out-of-line paths
    # (a division's slow path, a shuffle's divergent path), whose branches
    # back into the main line are not loops
    main_end = max((i for i, (_, t) in enumerate(insts) if opcode(t) == "EXIT"),
                   default=len(insts))
    loops = []
    for i, (_, text) in enumerate(insts[:main_end]):
        if opcode(text).split(".")[0] == "BRA":
            j = target(text)
            if j is not None and j <= i:
                ops = {opcode(t) for _, t in insts[j:i + 1]}
                if any(o.startswith("SHFL.BFLY") for o in ops) and "MUFU.RSQ64H" in ops:
                    loops.append((i - j, j, i))
    if not loops:
        return {"kernel": kernel, "error": "no stage loop found"}
    _, lo, hi = min(loops)
    # basic blocks of [lo, hi] and their forward edges; a block barrier
    # starts a block, and the code between a pair of them (a window of
    # the bodies' evaluation, once an attempt) is left out of the path
    leaders, bars = {lo}, []
    for i in range(lo, hi + 1):
        text = insts[i][1]
        if opcode(text).split(".")[0] in ("BRA", "EXIT", "RET"):
            leaders.add(i + 1)
            j = target(text)
            if j is not None and lo < j <= hi:
                leaders.add(j)
        if opcode(text).split(".")[0] == "BAR":
            leaders |= {i, i + 1}
            bars.append(i)
    windows = list(zip(bars[::2], bars[1::2]))
    leaders = sorted(x for x in leaders if lo <= x <= hi)
    skipped = {x for x in leaders if any(a <= x <= b for a, b in windows)}
    preds = {b: [] for b in leaders}
    blocks = [(b, (leaders[k + 1] if k + 1 < len(leaders) else hi + 1) - 1)
              for k, b in enumerate(leaders)]
    for b, e in blocks:
        if b in skipped:
            continue
        text = insts[e][1]
        op = opcode(text).split(".")[0]
        # BRA.DIV, a guard or a predicate operand make a branch conditional
        always = (not text.startswith("@") and (op in ("EXIT", "RET") or re.fullmatch(
            r"BRA\s+(0x[0-9a-f]+|`\(\.L_x_\d+\))", text) is not None))
        if not always:
            if e + 1 in preds:
                preds[e + 1].append(b)
        if op == "BRA":
            j = target(text)
            if j is not None and j > e and j in preds:
                preds[j].append(b)
    out_state, best = {}, (0.0, {})
    for b, e in blocks:
        if b in skipped or (b > lo and not preds[b]):
            continue  # a window's, or reached only through one
        state = {}
        for p in preds[b]:
            for r, v in out_state.get(p, {}).items():
                if r not in state or v[0] > state[r][0]:
                    state[r] = v
        for _, text in insts[b:e + 1]:
            guard = re.match(r"^@!?(U?P[T0-9]+)\s+", text)
            rest_text = text[guard.end():] if guard else text
            op, _, rest = rest_text.partition(" ")
            kind, lat = _weight(op, cycles)
            args = [a.strip() for a in rest.split(",")] if rest else []
            regs = [re.findall(r"\b(U?R\d+|U?P\d)\b", a) for a in args]
            base = op.split(".")[0]
            writes = (bool(args) and kind != "none" and not args[0].startswith("["))
            n_dst = 1
            while writes and n_dst < len(args) and re.fullmatch(r"U?P[T0-9]", args[n_dst]):
                n_dst += 1
            if (writes and re.fullmatch(r"U?P[T0-9]", args[0]) and n_dst < len(args)
                    and base not in ("ISETP", "FSETP", "DSETP", "PSETP", "PLOP3", "HSETP2")):
                n_dst += 1  # a predicate output, then the register written (SHFL, LOP3)
            dst = [r for a in (regs[:n_dst] if writes else []) for r in a]
            src = [r for a in (regs[n_dst:] if writes else regs) for r in a]
            if guard:
                src.append(guard.group(1))
            if base in ("DADD", "DMUL", "DFMA") or (writes and len(dst) == 1 and dst[0][0] == "R"
                                                    and op.endswith(".64")):
                # a 64-bit result is a register pair: R2 stands for R2:R3
                dst += [f"R{int(r[1:]) + 1}" for r in dst if re.fullmatch(r"R\d+", r)]
            prev = max((state[r] for r in src if r in state), key=lambda v: v[0],
                       default=(0.0, {}))
            now = (prev[0] + lat, {**prev[1], kind: prev[1].get(kind, 0) + 1})
            for r in dst:
                state[r] = now
            if now[0] > best[0]:
                best = now
        out_state[b] = state
    return {"kernel": kernel, "loop_instructions": hi - lo + 1, "blocks": len(blocks),
            "windows_left_out": len(windows),
            "path_cycles": best[0],
            "path_instructions": {k: v for k, v in sorted(best[1].items()) if k != "none"}}


def chain_bound(torch, build) -> dict:
    """Loop L: the probe's latencies and kernel 14's stage chain in the
    checkout's built library (``build``, its ``_build`` module)."""
    import os

    build.library()
    probe = latency_probe(torch)
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    lib_path = build.BUILD_ROOT / build._source_hash()[:16] / build.LIB_NAME
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    chain = stage_chain(sass, CHAIN_KERNEL, probe["cycles"])
    out = {"loop": "L_kernel14_chain", "latency_cycles": probe["cycles"],
           "sm_mhz": probe["sm_mhz"], **chain}
    if "path_cycles" in chain and probe["sm_mhz"] > 0:
        out["stage_chain_us"] = chain["path_cycles"] / probe["sm_mhz"]
        out["chain_us_per_iteration"] = out["stage_chain_us"] * CHAIN_STAGES
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loops", default="A,AF,B,C,D,F,F64,FS,G,H,K,M,P,Y")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_port.json"))
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--no-eager", action="store_true",
                    help="P, M and W through the card's route only, not also the eager loop")
    args = ap.parse_args(argv)
    paths = set(args.loops.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
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

    def kernel3_pair(t, limbs):
        return cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)

    try:  # the 3-limb route (kernel 3-f64 on the card), where the checkout has it
        from ephemeris_explorer_tpu_torch.ops import cuda_limbs64

        def accel_pair(t, limbs):
            return cuda_limbs64.limbs_force_pair(*limbs, mu_dev, mh, ml)
    except ImportError:
        accel_pair = kernel3_pair

    def accel_limbs(t, limbs):
        return cuda_nbody.combine_f64(*accel_pair(t, limbs))

    results = []
    if "B" in paths:
        q0 = ms.elm2_init_q(tab, None, 0.0, torch.as_tensor(pos, dtype=f64, device=dev),
                            torch.as_tensor(vel, dtype=f64, device=dev), H,
                            accel_limbs=accel_limbs)
        qf0 = ms.elm2_qf_from_q(q0)

        def fused(steps, pair=accel_pair):
            def body():
                c = qf0
                for _ in range(steps):
                    c = ms.elm2_step_qf(tab, pair, H, c, precise_sums=True)
            return body

        def unfused(steps):
            def body():
                c = q0
                for _ in range(steps):
                    c = ms.elm2_step_q(tab, None, H, c, accel_limbs=accel_limbs,
                                       with_velocity=False, precise_sums=True)
            return body

        results += [profile_loop(torch, "path_B_fused_step", fused(50), 50, sync),
                    profile_loop(torch, "path_B_fused_step_kernel3", fused(50, kernel3_pair), 50,
                                 sync),
                    profile_loop(torch, "path_B_unfused_step", unfused(10), 10, sync)]
    for loop, precision in (("A", "extended3"), ("AF", "extendedF")):
        if loop not in paths:
            continue
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        gate = getattr(eph, "_use_gen_kernel_q", None)
        for route in ("", "_two_launch") if gate else ("",):
            if route:
                eph._use_gen_kernel_q = lambda *a: False
            try:
                prop = eph.NBodyPropagator(fss.state, fss.settings, precision=precision,
                                           device=dev)
                prop.step_chunk(144)  # the startup chunk; each profiled call is one more chunk
                results.append(profile_loop(torch, f"path_{loop}_{precision}_chunk{route}",
                                            lambda: prop.step_chunk(144), 144, sync))
            finally:
                if gate:
                    eph._use_gen_kernel_q = gate
    if "C" in paths:
        p64 = torch.as_tensor(pos, dtype=f64, device=dev)
        for mode, (loop, start, _) in ladder_loops(p64, mu_dev, dd=True).items():
            results.append(profile_loop(torch, f"path_C_{mode}_eval",
                                        lambda: loop(start, 400), 400, sync))
    if "FS" in paths:
        f0 = ms.elm2_f_from(ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), 0.0,
                                         torch.as_tensor(pos, dtype=f64, device=dev),
                                         torch.as_tensor(vel, dtype=f64, device=dev), H))
        mark = getattr(ms, "writes_into", lambda fn: fn)

        @mark
        def pair(t, y, out=None):
            kw = {} if out is None else {"out": out}
            return TwoFloat(*cuda_nbody.pairwise_accel_df64(
                y.hi.t().contiguous(), y.lo.t().contiguous(), mh, ml, **kw))

        def f_steps(step, steps=50):
            def body():
                c = f0
                for _ in range(steps):
                    c = step(tab, pair, H, c)
            return body

        results.append(profile_loop(torch, "F_step_n4096", f_steps(ms.elm2_step_f), 50, sync))
        if hasattr(ms, "_step_f_cat"):
            results.append(profile_loop(torch, "F_step_n4096_before_fold",
                                        f_steps(ms._step_f_cat), 50, sync))
    if "F64" in paths:
        c64 = ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, mu_dev), 0.0,
                           torch.as_tensor(pos, dtype=f64, device=dev),
                           torch.as_tensor(vel, dtype=f64, device=dev), H)
        mark64 = getattr(ms, "writes_into", lambda fn: fn)

        @mark64
        def accel64(t, y, out=None):
            kw = {} if out is None else {"out": out}
            return nbody.pairwise_accel(y, mu_dev, **kw)

        def f64_steps(step, steps=F64_STEPS):
            def body():
                c = c64
                for _ in range(steps):
                    c = step(c)
            return body

        results.append(profile_loop(
            torch, "f64_step_n4096",
            f64_steps(lambda c: ms.elm2_step(tab, accel64, H, c, with_velocity=False)), F64_STEPS,
            sync))
        if hasattr(ms, "_step_cat"):
            results.append(profile_loop(
                torch, "f64_step_n4096_eager_update",
                f64_steps(lambda c: ms._step_cat(tab, accel64, H, c, False)), F64_STEPS, sync))
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
    if "K" in paths or "Y" in paths:
        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
        fmu = torch.as_tensor(fss.state.mus(), dtype=f64, device=dev)
    if "K" in paths:
        c0 = ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, fmu), 0.0,
                          torch.as_tensor(fss.state.positions(), dtype=f64, device=dev),
                          torch.as_tensor(fss.state.velocities(), dtype=f64, device=dev), H)
        results.append(profile_loop(
            torch, "kernel11_f64_full_solar_system_chunk",
            lambda: cuda_gen.elm2_gen_scan_f64(tab, H, c0, fmu, eph.CHUNK_STEPS),
            eph.CHUNK_STEPS, sync))
    if "Y" in paths:
        from ephemeris_explorer_tpu_torch import Duration

        year = Duration.from_days(365.25)
        results.append(profile_loop(
            torch, "full_solar_system_f64_year",
            lambda: eph.generate_ephemeris(fss.state, fss.settings, year, device=dev),
            int(round(year.as_seconds() / fss.settings.dt.as_seconds())), sync))
    if paths & {"P", "M", "W"}:
        from chip_smoke import (FLEET_DAYS, FLEET_EPH_DAYS, FLEET_KNOTS, FLEET_SHIPS,
                                MISSION_COUNT_DAYS, MISSION_EPH_DAYS, MISSION_KNOTS, _fleet_ships)
        from ephemeris_explorer_tpu_torch import Duration, Epoch
        from ephemeris_explorer_tpu_torch import spacecraft as sc_

        fss = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")

        def routes():
            """(suffix, context) of each fleet-loop route this checkout has:
            its card route, and the eager loop where the card's route is
            kernel 14."""
            out = [("", None)]
            if hasattr(sc_, "_propagate_batch_kernel") and not args.no_eager:
                out.append(("_eager", "eager"))
            return out

        class Eager:
            """The card's fleet loop patched to the eager loop for a block."""

            def __enter__(self):
                self.orig = sc_._propagate_batch_kernel
                sc_._propagate_batch_kernel = (
                    lambda tab, eph_, tl, t0s, p0s, v0s, ends, params, max_knots:
                    sc_.propagate_batch_plain(tab, eph_, tl, t0s, p0s, v0s, ends, params,
                                              max_knots=max_knots))

            def __exit__(self, *exc):
                sc_._propagate_batch_kernel = self.orig

        def profile_flight(name, fly):
            for suffix, how in routes():
                with Eager() if how == "eager" else contextlib.nullcontext():
                    sc_.propagate_batch.iterations = 0
                    fly()
                    results.append(profile_loop(torch, name + suffix, fly,
                                                sc_.propagate_batch.iterations, sync))

    if "P" in paths:
        e_f = eph.generate_ephemeris(fss.state, fss.settings, Duration.from_days(FLEET_EPH_DAYS),
                                     device=dev)
        ships = _fleet_ships(fss, e_f, FLEET_SHIPS, FLEET_DAYS)
        profile_flight("P_fleet64_iteration", lambda: sc_.propagate_ships(
            e_f, ships, max_knots=FLEET_KNOTS, device=dev))
    if "M" in paths:
        e_m = eph.generate_ephemeris(fss.state, fss.settings,
                                     Duration.from_days(MISSION_EPH_DAYS), device=dev)
        ship = next(x for x in fss.ships if x.name == "Mars Transfer Ship")
        until = Epoch.from_offset_seconds(ship.start.as_offset_seconds()
                                          + MISSION_COUNT_DAYS * 86400.0)
        profile_flight("M_mission_first_days_iteration", lambda: sc_.propagate_ship(
            e_m, ship, until=until, max_knots=MISSION_KNOTS, device=dev))
    if "W" in paths:
        from chip_smoke import MISSION_UNTIL, SESSION_UNTIL
        from ephemeris_explorer_tpu_torch import api

        u = api.Universe.load(ROOT / "systems" / "full_solar_system_2433282.5", device=dev)
        u.generate(Duration.from_days(MISSION_EPH_DAYS))
        e_w = eph.generate_ephemeris(fss.state, fss.settings, Duration.from_days(FLEET_EPH_DAYS),
                                     device=dev)
        fleet_w = _fleet_ships(fss, e_w, FLEET_SHIPS, FLEET_DAYS)
        mars = next(x for x in u.scene.ships if x.name == "Mars Transfer Ship")

        def mission():
            return sc_.propagate_ship(u.ephemeris, mars, until=Epoch.parse(MISSION_UNTIL),
                                      max_knots=MISSION_KNOTS, device=dev)

        def replan():
            u.spawn_ship(mars, propagate_now=False)
            u.set_plan_end(mars.name, Epoch.parse(SESSION_UNTIL), replan=False)
            return u.replan(mars.name, max_knots=MISSION_KNOTS)

        def fleet64():
            return sc_.propagate_ships(e_w, fleet_w, max_knots=FLEET_KNOTS, device=dev)

        class Route:
            """Seconds spent in the fleet loop's route (as it stands: the
            kernel's or the eager loop) for a block."""

            def __enter__(self):
                self.orig, self.s = sc_._propagate_batch_kernel, 0.0

                def timed(*a, **kw):
                    t0 = time.perf_counter()
                    out = self.orig(*a, **kw)
                    sync()
                    self.s += time.perf_counter() - t0
                    return out

                sc_._propagate_batch_kernel = timed
                return self

            def __exit__(self, *exc):
                sc_._propagate_batch_kernel = self.orig

        eager = dict(routes()).get("_eager")
        for name, fly in (("mission", mission), ("replan", replan), ("fleet64", fleet64)):
            runs = {}
            for suffix in ("", "_eager", "") if eager else ("",) * W_RUNS:
                with Eager() if suffix else contextlib.nullcontext(), Route() as route:
                    sc_.propagate_batch.iterations = sc_.propagate_batch.syncs = 0
                    t0 = time.perf_counter()
                    traj = fly()
                    sync()
                    wall = time.perf_counter() - t0
                knots = (sum(len(x.ts) for x in traj.values()) if isinstance(traj, dict)
                         else len(traj.ts))
                r = runs.setdefault(suffix, {"wall_s": [], "route_s": [], "host_s": [],
                                             "knots": knots,
                                             "iterations": sc_.propagate_batch.iterations,
                                             "host_reads": sc_.propagate_batch.syncs})
                r["wall_s"].append(wall)
                r["route_s"].append(route.s)
                r["host_s"].append(wall - route.s)
                if name == "fleet64":
                    r.setdefault("ship_days_per_s", []).append(FLEET_SHIPS * FLEET_DAYS / wall)
            for suffix, r in runs.items():
                results.append({"loop": f"W_{name}{suffix}", **r})
    if "L" in paths:
        from ephemeris_explorer_tpu_torch import _build

        chain = chain_bound(torch, _build)
        m_loop = next((r for r in results if r["loop"] == "M_mission_first_days_iteration"),
                      None)
        if m_loop and "chain_us_per_iteration" in chain:
            chain["share_of_M"] = chain["chain_us_per_iteration"] / m_loop["device_us_per_step"]
        results.append(chain)
    if "S" in paths:
        sweep = geometry_sweep(torch, pos, mu, dev)
        for r in sweep:
            print(json.dumps(r | {"card": smi}))
        results.append({"loop": "geometry_sweep_kernels5_7", "rows": sweep})
    for r in results:
        if "rows" not in r:
            print(json.dumps({k: v for k, v in r.items() if k != "top"} | {"card": smi}))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "loops": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
