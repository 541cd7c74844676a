"""The seeded generators: the same seed gives the same inputs, and every
seed the same set of sizes."""

import numpy as np
import torch

from harness import traffic

CFG = {"bodies": 16, "pos_sigma_km": 1e6, "vel_sigma_km_s": 1.0, "mu_range": [1e3, 1e5]}
SEED = 2**31 + 12345


def test_cluster_same_seed_same_inputs():
    a = traffic.cluster(CFG, 2, SEED, "cpu")
    b = traffic.cluster(CFG, 2, SEED, "cpu")
    c = traffic.cluster(CFG, 2, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    pos, vel, mu = a
    assert pos.shape == (2, 16, 3) and vel.shape == (2, 16, 3) and mu.shape == (16,)
    assert pos.dtype == torch.float64
    assert float(mu.min()) >= 1e3 and float(mu.max()) <= 1e5


EDIT = {"ships_per_request": 1, "scaled_burns": [3], "factor_range": [0.99, 1.01],
        "factor_grid": 8}
SWEEP = {"ships_per_request": 16, "scaled_burns": [2, 3], "factor_range": [0.99, 1.01],
         "factor_grid": 8}


def test_edit_factors_same_seed_same_set():
    a = [traffic.burn_factors(EDIT, SEED, r) for r in range(16)]
    b = [traffic.burn_factors(EDIT, SEED, r) for r in range(16)]
    c = [traffic.burn_factors(EDIT, SEED + 1, r) for r in range(16)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    flat_a = np.sort(np.concatenate(a).ravel())
    flat_c = np.sort(np.concatenate(c).ravel())
    assert np.array_equal(flat_a, flat_c)             # the same set, in another order
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert flat_a.min() > 0.99 and flat_a.max() < 1.01


def test_sweep_factors_every_grid_value_each_request():
    a = traffic.burn_factors(SWEEP, SEED, 3)
    assert a.shape == (16, 2)
    grid = np.sort(a[:, 0])
    assert np.array_equal(grid, np.sort(traffic.burn_factors(SWEEP, SEED + 9, 3)[:, 0]))
    assert np.array_equal(a, traffic.burn_factors(SWEEP, SEED, 3))


def test_sample_is_seeded_and_distinct():
    s = traffic.sample(SEED, 1, 4, 0, 10)
    assert s == traffic.sample(SEED, 1, 4, 0, 10) and len(set(s)) == 4
    assert traffic.sample(SEED, 1, 4, 0, 2) == [0, 1]
