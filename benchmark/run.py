"""Run one cell of the benchmark of ``ephemeris_explorer_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (the kernels' build or load, the cell's own state, one warm
request) is timed as ``setup_s``; then requests run back to back for
``--seconds``; then the plain reference judges what the window produced.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones read from a ``torch.profiler`` trace
of the window), ``device`` and, last, ``checks`` (each compared number and
its limit, which also end standard error).  Without enough CUDA devices,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules that no run may load: JAX and the JAX package (the
# port's name begins with the latter's, so names are compared whole)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ephemeris_explorer_tpu"})


def forbidden_loaded(modules) -> list[str]:
    """The forbidden top-level names among ``modules`` (dotted names)."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def set_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    and one host thread for torch's and numpy's pools: the cells' host work
    is small, and a pool of threads spinning beside it spread the 256-ship
    cell's rate 8% between runs on the card's host, against 2.7% with one."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = root / "build"
    os.environ["EET_CUDA_BUILD_DIR"] = str(build / "kernels")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _window(entry, seconds: float, trace: bool):
    """Requests back to back until ``seconds`` have passed: (records,
    window seconds, trace summary or None)."""
    import torch

    from harness import trace as tr

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    records = []
    t0 = time.perf_counter()
    i = 0
    while True:
        with record_function("bench.request") if trace else contextlib.nullcontext():
            records.append(entry.request(i))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    summary = None
    if prof is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        summary = tr.summarize(prof)
        del prof
    return records, window_s, summary


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             control: bool = False) -> tuple[dict, list]:
    """One run of cell ``name``: (the result object, the checks).  Tests
    call it with ``device="cpu"`` and small sizes in ``overrides``;
    ``control`` adds the control's readings (``control.py``; never in the
    benchmark's own runs)."""
    import torch

    from harness import cells
    from harness.device import sync

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    bench = cells.load_benchmark()
    cell = cells.find_cell(name, bench, overrides)
    entry = cells.entry(cell["traffic"]["entry"])(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    entry.setup()
    gc.collect()                    # set-up's garbage is not the window's
    sync(dev)
    setup_s = time.perf_counter() - t_start
    records, window_s, summary = _window(entry, seconds, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    entry.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.judge()
    ctx = {"records": records, "window_s": window_s, "setup_s": setup_s,
           "sizes": entry.sizes(), "trace": summary}
    metrics = {}
    for m in cells.metrics_of(bench, name, trace):
        value = cells.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": len(records),
        "failed": sum(1 for r in records if r["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak,
                   "power_limit": _power_limit() if dev.type == "cuda" else None},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = window_s
        result["breakdown"] = summary["breakdown"]
    if control:
        result["control"] = {c.name: c.value for c in entry.judge(control=True)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


def _power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches()
    for path in (str(ROOT), str(BENCH)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import cells

    chips = cells.find_cell(args.workload, cells.load_benchmark())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    bad = forbidden_loaded(sys.modules)
    if bad:
        print(f"run.py: the run loaded {bad}, which the benchmark forbids", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
