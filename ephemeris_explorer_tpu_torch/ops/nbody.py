"""Pairwise Newtonian gravity in native precision: the O(N^2) reference force.

Port of ``ephemeris_explorer_tpu.ops.nbody``.  Reference semantics
(``ephemeris/src/propagators/nbody.rs:16-39``): zero softening,
mu-weighted inverse cube,

    a_i = sum_{j != i}  mu_j * (r_j - r_i) / |r_j - r_i|^3

with state in km, km/s and mu in km^3/s^2.  In f64 this is the plain path
the port's generation runs below the fused-kernel size, on CPU and on CUDA
(the H100 has native IEEE f64).
"""

from __future__ import annotations

import torch


def pairwise_accel(pos: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Accelerations of N massive bodies.

    pos: (N, 3) positions [km]; mu: (N,) gravitational parameters [km^3/s^2].
    Returns (N, 3) accelerations [km/s^2].
    """
    n = pos.shape[0]
    d = pos[None, :, :] - pos[:, None, :]          # d[i, j] = r_j - r_i
    r2 = (d * d).sum(-1)                           # (N, N)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    r2 = torch.where(eye, torch.ones_like(r2), r2)
    inv_r = torch.rsqrt(r2)
    inv_r3 = torch.where(eye, torch.zeros_like(r2), inv_r * inv_r * inv_r)
    w = mu[None, :] * inv_r3                       # (N, N): weight of j on i
    return (d * w[:, :, None]).sum(1)


def accel_at(pos: torch.Tensor, mu: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Acceleration felt by massless probes at `at` (..., 3) from N bodies."""
    d = pos - at[..., None, :]                     # (..., N, 3)
    r2 = (d * d).sum(-1)
    inv_r = torch.rsqrt(r2)
    inv_r3 = inv_r * inv_r * inv_r
    return (d * (mu * inv_r3)[..., None]).sum(-2)


def pairwise_accel_tiled(pos: torch.Tensor, mu: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """Row-tiled variant: `tile` receivers at a time, O(tile * N) peak memory."""
    n = pos.shape[0]
    assert n % tile == 0, "N must be divisible by tile"
    idx = torch.arange(n, device=pos.device)
    blocks = []
    for start in range(0, n, tile):
        p_i = pos[start:start + tile]                              # (tile, 3)
        d = pos[None, :, :] - p_i[:, None, :]                      # (tile, N, 3)
        r2 = (d * d).sum(-1)
        self_mask = idx[None, :] == (start + torch.arange(tile, device=pos.device))[:, None]
        r2 = torch.where(self_mask, torch.ones_like(r2), r2)
        inv_r = torch.rsqrt(r2)
        inv_r3 = torch.where(self_mask, torch.zeros_like(r2), inv_r * inv_r * inv_r)
        w = mu[None, :] * inv_r3
        blocks.append(torch.einsum("ij,ijc->ic", w, d))
    return torch.cat(blocks)


def energy(pos: torch.Tensor, vel: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Specific total energy sum(mu_i v_i^2)/2 - sum_{i<j} mu_i mu_j / r_ij."""
    n = pos.shape[0]
    ke = 0.5 * (mu * (vel * vel).sum(-1)).sum()
    d = pos[None, :, :] - pos[:, None, :]
    r = torch.sqrt((d * d).sum(-1))
    iu = torch.triu_indices(n, n, offset=1, device=pos.device)
    pe = -((mu[:, None] * mu[None, :])[iu[0], iu[1]] / r[iu[0], iu[1]]).sum()
    return ke + pe
