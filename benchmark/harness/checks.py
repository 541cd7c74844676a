"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

MEDIAN, Q99 = 0.5, 0.99


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _members(x: torch.Tensor) -> torch.Tensor:
    """(R, E, N, 3) rings or (E, N, 3) states as (E, R * N, 3)."""
    if x.dim() == 4:
        return x.transpose(0, 1).reshape(x.shape[1], -1, 3)
    return x


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.double(), dim=-1)


def disp_dev(port: torch.Tensor, ref: torch.Tensor, base: torch.Tensor,
             q: float = MEDIAN) -> float:
    """The largest over members of: the ``q`` quantile over bodies of
    |port - ref|, over the median over bodies of how far the reference
    moved from ``base`` (shaped as ``ref``, or broadcast to it)."""
    port, ref, base = _members(port), _members(ref), _members(base.expand_as(ref))
    gap = torch.quantile(_norms(port - ref), q, dim=1)
    moved = torch.median(_norms(ref - base), dim=1).values
    return float((gap / moved).max())


def rel_dev(port: torch.Tensor, ref: torch.Tensor, q: float = MEDIAN) -> float:
    """The largest over members of the ``q`` quantile over bodies of
    |port - ref|, over the median over bodies of |ref|."""
    port, ref = _members(port), _members(ref)
    gap = torch.quantile(_norms(port - ref), q, dim=1)
    return float((gap / torch.median(_norms(ref), dim=1).values).max())


def each_dev(port: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest over bodies of |port - ref| / (|ref| + 1e-3 of the
    member's median |ref|): every body held to its own size."""
    port, ref = _members(port), _members(ref)
    size = _norms(ref)
    floor = 1e-3 * torch.median(size, dim=1, keepdim=True).values
    return float((_norms(port - ref) / (size + floor)).max())


def com_dev(port: torch.Tensor, ref: torch.Tensor, base: torch.Tensor, mu) -> float:
    """The largest over members of the gap between the mu-weighted centres
    of ``port`` and ``ref`` (E, N, 3), over the median body's motion from
    ``base``."""
    w = (mu / mu.sum()).double()[None, :, None]
    gap = _norms(((port.double() - ref.double()) * w).sum(1))
    moved = torch.median(_norms(ref - base), dim=1).values
    return float((gap / moved).max())
