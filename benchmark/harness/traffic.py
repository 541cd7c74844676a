"""The one generator that every traffic mix's data file drives.

A mix (``traffic/<mix>.json``) names the entry of the program it drives
(``"entry"``) and gives that entry's parameters; this module turns them and
``--seed`` into inputs.  The same seed gives the same inputs, and every
seed gives the same set of sizes: what the seed changes is the data and the
order of the requests, never how much work they are.
"""

from __future__ import annotations

import numpy as np
import torch


def cluster(config: dict, members: int, seed: int, device) -> tuple:
    """``members`` clusters of ``config["bodies"]`` bodies, made on
    ``device`` from ``seed`` in three calls: positions N(0, pos_sigma_km),
    velocities N(0, vel_sigma_km_s), one mu vector U(mu_range) that every
    member shares (the pattern of the project's own cluster generator).
    Returns (pos (E, N, 3), vel (E, N, 3), mu (N,)) in f64."""
    n = int(config["bodies"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    kw = {"dtype": torch.float64, "device": device, "generator": g}
    pos = torch.randn((members, n, 3), **kw) * float(config["pos_sigma_km"])
    vel = torch.randn((members, n, 3), **kw) * float(config["vel_sigma_km_s"])
    lo, hi = config["mu_range"]
    mu = torch.rand((n,), **kw) * (float(hi) - float(lo)) + float(lo)
    return pos, vel, mu


def burn_factors(traffic: dict, seed: int, request: int) -> np.ndarray:
    """The factors of request ``request``: (ships, len(scaled_burns)).

    Each scaled burn takes its factors from a grid of ``factor_grid`` values
    evenly spread over ``factor_range`` (the midpoints of its cells).  With
    one ship a request, request r takes grid value perm_c[r mod grid] of
    cycle c = r // grid, each cycle a new permutation from the seed; with
    many, each request holds every grid value once per burn (ships a
    multiple of the grid), in an order drawn from the seed."""
    lo, hi = traffic["factor_range"]
    grid_n = int(traffic["factor_grid"])
    grid = lo + (hi - lo) * (np.arange(grid_n) + 0.5) / grid_n
    ships = int(traffic["ships_per_request"])
    burns = len(traffic["scaled_burns"])
    if ships == 1:
        cycle, pos = divmod(request, grid_n)
        rng = np.random.default_rng([int(seed), cycle])
        return np.stack([grid[rng.permutation(grid_n)[pos]] for _ in range(burns)])[None]
    if ships % grid_n:
        raise ValueError(f"ships_per_request {ships} is not a multiple of factor_grid {grid_n}")
    rng = np.random.default_rng([int(seed), request, 1])
    cols = [np.tile(grid, ships // grid_n)[rng.permutation(ships)] for _ in range(burns)]
    return np.stack(cols, 1)


def sample(seed: int, salt: int, n: int, lo: int, hi: int) -> list[int]:
    """``n`` distinct integers of [lo, hi) drawn from the seed, sorted: which
    requests, members or ships the check judges."""
    rng = np.random.default_rng([int(seed), 7919, salt])
    return sorted(int(x) for x in rng.choice(np.arange(lo, hi), size=min(n, hi - lo),
                                             replace=False))
