"""A request's wall less kernel 14's device time in the trace: the entry's host work."""

from harness.readers import host_ms_per_request as read  # noqa: F401
