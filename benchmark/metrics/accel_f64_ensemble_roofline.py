"""Kernel 1-f64's ensemble form (ops.cuda_nbody64): its self time in the trace against the benchmark's count of the force's operations and bytes."""

from harness.readers import accel_ensemble_roofline as read  # noqa: F401
