"""Read the numbers that decide ``correct`` for the program and its control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 3] [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the program's readings of every compared number; for
the first ``--control-seeds`` seeds also the control's readings, the plain
reference computed in f32 (the precision below the configuration's f64)
and put in the program's place.  The limits in ``limits/<cell>.json`` lie
between the two (see PERF.md).  One JSON line a seed; not part of the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    run.set_caches()
    sys.path.insert(0, str(run.ROOT))
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _ = run.run_cell(args.workload, seed, args.seconds, False,
                                 control=k < args.control_seeds)
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0,
                          "attempted": result["attempted"],
                          "program": {k: v["value"] for k, v in result["checks"].items()},
                          "control": result.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
