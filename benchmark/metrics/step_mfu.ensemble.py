"""The window's force and update operations over its time, against the card's f64 peak."""

from harness.readers import step_mfu as read  # noqa: F401
