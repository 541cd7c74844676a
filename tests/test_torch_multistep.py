"""The port's native-f64 integrators against the JAX package's.

Both sides run IEEE f64 from the same numpy inputs; they differ only in
summation order and in whether a compiler fused a multiply into an add, so
each comparison is held to a small multiple of f64 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import fixed as jfixed
from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import fixed, get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import nbody


def _system(n, seed):
    """A bound cloud: central mass plus light bodies on rough circular orbits."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 1e8
    pos[0] = 0.0
    mu = rng.uniform(1e3, 1e7, size=n)
    mu[0] = 1.3e11
    r = np.linalg.norm(pos, axis=1, keepdims=True)
    r[0] = 1.0
    vel = np.cross(pos, [0.0, 0.0, 1.0]) / r * np.sqrt(mu[0] / r)
    vel[0] = 0.0
    return pos, vel, mu


def _accels(mu):
    mu_j, mu_t = jnp.asarray(mu), torch.tensor(mu)
    return (lambda t, y: jnbody.pairwise_accel(y, mu_j),
            lambda t, y: nbody.pairwise_accel(y, mu_t))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("method", ["QuinlanTremaine12", "Stormer13"])
def test_elm2_init_steps_velocity_match_jax(method):
    """elm2_init + 50 elm2_step + elm2_velocity in f64: <= 1e-13 relative."""
    pos, vel, mu = _system(16, 0)
    ja, ta = _accels(mu)
    h = 21600.0
    jtab, tab = jget(method), get(method)
    jc = jms.elm2_init(jtab, ja, 0.0, jnp.asarray(pos), jnp.asarray(vel), h)
    tc = ms.elm2_init(tab, ta, 0.0, torch.tensor(pos), torch.tensor(vel), h)
    assert tc.t == float(jc.t)
    assert _rel(tc.ys, jc.ys) <= 1e-13 and _rel(tc.ddys, jc.ddys) <= 1e-13
    for i in range(50):
        # half the steps defer the velocity, as generation does
        jc = jms.elm2_step(jtab, ja, h, jc, with_velocity=i % 2 == 0)
        tc = ms.elm2_step(tab, ta, h, tc, with_velocity=i % 2 == 0)
    assert tc.t == float(jc.t)
    assert _rel(tc.ys, jc.ys) <= 1e-13
    assert _rel(tc.ddys, jc.ddys) <= 1e-13
    assert _rel(ms.elm2_velocity(tab, tc, h), jms.elm2_velocity(jtab, jc, h)) <= 1e-13


def test_elm2_step_from_same_carry():
    """One step from the same carry (interop) agrees to a few f64 ulps."""
    pos, vel, mu = _system(12, 1)
    ja, ta = _accels(mu)
    h = 600.0
    jtab, tab = jget("QuinlanTremaine12"), get("QuinlanTremaine12")
    jc = jms.elm2_init(jtab, ja, 0.0, jnp.asarray(pos), jnp.asarray(vel), h)
    jn = jms.elm2_step(jtab, ja, h, jc)
    tn = ms.elm2_step(tab, ta, h, interop.carry_from(jc))
    assert _rel(tn.ys[0], jn.ys[0]) <= 1e-15
    assert _rel(tn.dy, jn.dy) <= 1e-12  # (y_n - y_{n-1})/h cancels ~3 digits


@pytest.mark.parametrize("starter", ["BlanesMoan6B", "McLachlanO4"])
def test_srkn_step_matches_jax(starter):
    """One symplectic starter step: <= 1e-15 relative."""
    pos, vel, mu = _system(10, 2)
    ja, ta = _accels(mu)
    jtab, tab = jget(starter), get(starter)
    jt, jy, jdy, _ = jfixed.srkn_step(jtab, ja, 0.0, jnp.asarray(pos), jnp.asarray(vel), 5400.0)
    tt, ty, tdy, _ = fixed.srkn_step(tab, ta, 0.0, torch.tensor(pos), torch.tensor(vel), 5400.0)
    assert tt == float(jt)
    assert _rel(ty, jy) <= 1e-15 and _rel(tdy, jdy) <= 1e-15


def test_erk_step_matches_jax():
    """One RK4 step on a (pos, vel) first-order state: <= 1e-15 relative."""
    pos, vel, mu = _system(6, 3)
    ja, ta = _accels(mu)
    jtab, tab = jget("RK4"), get("RK4")

    def jf(t, s):
        return (s[1], ja(t, s[0]))

    def tf(t, s):
        return (s[1], ta(t, s[0]))

    _, (jp, jv), _ = jfixed.erk_step(jtab, jf, 0.0, (jnp.asarray(pos), jnp.asarray(vel)), 3600.0)
    _, (tp, tv), _ = fixed.erk_step(tab, tf, 0.0, (torch.tensor(pos), torch.tensor(vel)), 3600.0)
    assert _rel(tp, jp) <= 1e-15 and _rel(tv, jv) <= 1e-15
