"""Kernel 2-f64 (ops.cuda_elm2f64): its self time in the trace against the benchmark's count of the update's operations and bytes."""

from harness.readers import elm2_update_roofline as read  # noqa: F401
