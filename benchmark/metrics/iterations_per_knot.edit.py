"""spacecraft.propagate_batch.iterations over the accepted steps (knots): attempts a step."""

from harness.readers import iterations_per_knot as read  # noqa: F401
