"""Set-up: interpreter and torch, the CUDA context, the kernels' build or load, the cell's own set-up and warm request (host clock)."""

from harness.readers import setup_s as read  # noqa: F401
