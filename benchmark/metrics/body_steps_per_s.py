"""Every body-step of the window over the window's host-clock time."""

from harness.readers import work_rate as read  # noqa: F401
