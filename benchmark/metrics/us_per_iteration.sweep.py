"""Batch wall (host clock, synchronised) over spacecraft.propagate_batch.iterations (the batch's slowest ship)."""

from harness.readers import us_per_iteration as read  # noqa: F401
