"""The one device call that every entry and the command share."""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
