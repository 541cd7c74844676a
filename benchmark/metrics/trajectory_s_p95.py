"""The 95th percentile of the window's flights, edit to trajectory on the host (host clock)."""

from harness.readers import wall_p95 as read  # noqa: F401
