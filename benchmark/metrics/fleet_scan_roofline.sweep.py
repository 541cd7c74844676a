"""Kernel 14 (ops.cuda_fleet): its self time in the trace against the benchmark's count of the accepted steps the flights needed."""

from harness.readers import fleet_roofline as read  # noqa: F401
