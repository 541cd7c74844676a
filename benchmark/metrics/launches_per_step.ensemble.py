"""Device operations in the trace over the window's QT12 steps (parallel.sharding's scan)."""

from harness.readers import launches_per_step as read  # noqa: F401
