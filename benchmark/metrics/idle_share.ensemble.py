"""The share of the traced window in which the card ran nothing."""

from harness.readers import idle_share as read  # noqa: F401
