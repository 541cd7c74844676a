"""The arithmetic that the metric files (``metrics/<name>.py``) read with.

Each reader takes the run's context and returns a number, or None where the
run has nothing to read (a count the entry does not keep, a traced kernel
that did not run).  Which cells report a metric is ``BENCHMARK.json``'s to
say (its ``workloads``), not the reader's.  The context holds:

* ``records``: one dict a request of the window: ``wall_s``, ``work`` (the
  unit of the cell's rate), ``ops`` (the algorithm's operations by
  :mod:`.roofline`'s counts) and the entry's own counts (``steps``;
  ``iterations``, ``accepted``);
* ``window_s``, ``setup_s``: host-clock seconds;
* ``sizes``: the entry's shapes (its ``sizes()``);
* ``trace``: :func:`harness.trace.summarize` of the traced window, or None.
"""

from __future__ import annotations

from . import roofline, stats
from .trace import kernel_s

ACCEL = "accel_f64"
ELM2 = "elm2_f64_update_shift"
FLEET = "fleet_scan"


def _total(ctx, key: str) -> float | None:
    """The window's sum of ``key``, or None where the entry does not keep it."""
    records = ctx["records"]
    if not records or any(key not in r for r in records):
        return None
    return float(sum(r[key] for r in records))


def setup_s(ctx):
    return ctx["setup_s"]


def work_rate(ctx):
    """All the work of the window over all its time."""
    work = _total(ctx, "work")
    return None if work is None else stats.rate(work, ctx["window_s"])


def wall_p95(ctx):
    """The 95th percentile of every request's wall time in the window."""
    return stats.percentile([r["wall_s"] for r in ctx["records"]], 95.0)


def _ensemble_ops(ctx) -> tuple[tuple, tuple]:
    s = ctx["sizes"]
    force = roofline.accel_ensemble(s["members"], s["bodies"])
    update = roofline.elm2_update(s["c_y"], s["c_dy"], s["members"] * s["bodies"] * 3)
    return force, update


def _kernel_share(ctx, part: str, ops_bytes) -> float | None:
    if ctx["trace"] is None:
        return None
    sec, launches = kernel_s(ctx["trace"], part)
    if launches == 0:
        return None
    ops, nbytes = ops_bytes
    return roofline.share_pct(ops * launches, nbytes * launches, sec)


def accel_ensemble_roofline(ctx):
    """Kernel 1-f64's ensemble form: one launch a step, each a force
    evaluation of every member."""
    if ctx["trace"] is None:
        return None
    return _kernel_share(ctx, ACCEL, _ensemble_ops(ctx)[0])


def elm2_update_roofline(ctx):
    """Kernel 2-f64: one launch a step, each a position update of every
    member (its ring shift is the program's choice, not counted)."""
    if ctx["trace"] is None:
        return None
    return _kernel_share(ctx, ELM2, _ensemble_ops(ctx)[1])


def launches_per_step(ctx):
    """Device operations of the traced window over its steps."""
    steps = _total(ctx, "steps")
    if ctx["trace"] is None or not steps:
        return None
    return ctx["trace"]["device_ops"] / steps


def _ship_bytes(ctx) -> float:
    """The coefficient table in once a request; a knot (t, position,
    velocity) out for each accepted step and each start."""
    s = ctx["sizes"]
    starts = len(ctx["records"]) * s["ships"]
    return (len(ctx["records"]) * s["coeff_bytes"]
            + (_total(ctx, "accepted") + starts) * 7 * roofline.F64)


def fleet_roofline(ctx):
    """Kernel 14 over the accepted steps the window's flights needed."""
    if ctx["trace"] is None or _total(ctx, "accepted") is None:
        return None
    sec, launches = kernel_s(ctx["trace"], FLEET)
    if launches == 0:
        return None
    return roofline.share_pct(_total(ctx, "ops"), _ship_bytes(ctx), sec)


def step_mfu(ctx):
    """The window's algorithm operations over its time, against the f64 peak."""
    ops = _total(ctx, "ops")
    return None if ops is None else 100.0 * ops / (ctx["window_s"] * roofline.PEAK_F64)


def idle_share(ctx):
    """The share of the traced window in which no device operation ran."""
    if ctx["trace"] is None:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])


def us_per_iteration(ctx):
    """Flight wall over the fleet loop's iterations (``propagate_batch.iterations``)."""
    it = _total(ctx, "iterations")
    return 1e6 * _total(ctx, "wall_s") / it if it else None


def host_ms_per_request(ctx):
    """A request's wall less kernel 14's device time in it, a request."""
    if ctx["trace"] is None:
        return None
    sec, launches = kernel_s(ctx["trace"], FLEET)
    if launches == 0:
        return None
    return 1e3 * (_total(ctx, "wall_s") - sec) / len(ctx["records"])


def iterations_per_knot(ctx):
    """Fleet-loop iterations an accepted step: attempts, rejections and
    segment changes over the steps kept."""
    it, acc = _total(ctx, "iterations"), _total(ctx, "accepted")
    return it / acc if it is not None and acc else None
