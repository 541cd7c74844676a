"""The device an entry point runs on when its caller names none: the card."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device.

    The port's entry points run on the card unless the caller asks for the
    CPU (``device="cpu"``), so without CUDA the default raises instead of
    running on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points default to the card; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
