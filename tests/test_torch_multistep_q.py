"""The port's expansion-state engine against the JAX package's.

``elm2_init_q`` (from the exact host limb split), ``elm2_step_q`` and
``elm2_velocity_q`` run on both sides from the same numpy inputs, with the
f64 force and with the 3-limb force (kernel 3: the port's plain version
against the Pallas kernel in interpret mode), precise sums on and off.  The
JAX steps run eagerly, so its precise sums take the error-free cascade, as
the port's do; its startup runs under ``lax.scan``, compiled.

Expansions are compared by the sum of their limb differences (an f64
``to_f64`` would hide everything below 2^-53), relative to max |y|.  Where
the two sides differ: the f64 forces by summation order (~1e-16 of the
force), the kernel-3 versions by their sum order (~1e-14), and XLA:CPU's
compiled startup in the deep limbs; each bar below sits over the measured
value with margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import expansion as jex
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops.pallas_nbody import combine_f64 as jcombine
from ephemeris_explorer_tpu.ops.pallas_nbody import pairwise_accel_limbs_pair as jpair
from ephemeris_explorer_tpu.ops.pallas_nbody import split_f64 as jsplit
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_limbs, cuda_nbody, nbody
from ephemeris_explorer_tpu_torch.ops import expansion as ex

QT12 = "QuinlanTremaine12"
H = 600.0


def _system(n=8, seed=0):
    """A bound cloud: a central mass and light bodies on rough circles."""
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


def _forces(mu, limbs: bool):
    """(jax accel, jax accel_limbs, port accel, port accel_limbs)."""
    mj, mt = jnp.asarray(mu), torch.tensor(mu)
    jmh, jml = jsplit(mj.reshape(1, -1))
    tmh, tml = cuda_nbody.split_f64(mt.reshape(1, -1))

    def jal(t, l):
        return jcombine(*jpair(*l, jmh, jml, interpret=True, tile_rows=8, tile_cols=8))

    def tal(t, l):
        return cuda_limbs.pairwise_accel_limbs(*l, tmh, tml)

    return (lambda t, y: jnbody.pairwise_accel(y, mj), jal if limbs else None,
            lambda t, y: nbody.pairwise_accel(y, mt), tal if limbs else None)


def _exp_err(t_limbs, j_limbs):
    """max |port - jax| of two expansions, over max |value|."""
    d = sum(a.numpy().astype(np.float64) - np.asarray(b, np.float64)
            for a, b in zip(t_limbs, j_limbs))
    return float(np.abs(d).max() / np.abs(np.asarray(jex.to_f64(tuple(j_limbs)))).max())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# bars (max |diff| / max |value|) per force: positions, accelerations,
# velocities.  Measured on the positions: 7e-22 .. 1e-20 with the f64 force,
# 1.3e-20 .. 4.9e-20 with kernel 3, whose pair differs from the Pallas
# kernel's by ~1e-14 of the force.
_BARS = {False: (1e-19, 1e-15, 1e-15), True: (1e-18, 1e-13, 1e-13)}


@pytest.mark.parametrize("limbs", [False, True], ids=["f64-force", "kernel3"])
def test_elm2_init_q_matches_jax(limbs):
    """The startup from the exact host limb split: positions, the force
    ring, the velocity and the time."""
    pos, vel, mu = _system()
    ja, jal, ta, tal = _forces(mu, limbs)
    jc = jms.elm2_init_q(jget(QT12), ja, 0.0, None, jnp.asarray(vel), H, accel_limbs=jal,
                         y0_limbs=jex.from_f64_host(pos))
    tc = ms.elm2_init_q(get(QT12), ta, 0.0, None, torch.tensor(vel), H, accel_limbs=tal,
                        y0_limbs=ex.from_f64_host(pos))
    y_bar, a_bar, v_bar = _BARS[limbs]
    assert tc.t == float(jc.t)
    assert len(tc.ys) == 4 and all(l.shape == (12, 8, 3) for l in tc.ys)
    assert _exp_err(tc.ys, jc.ys) <= y_bar
    assert _rel(tc.ddys, jc.ddys) <= a_bar
    assert _rel(tc.dy, jc.dy) <= v_bar


@pytest.mark.parametrize("precise", [False, True], ids=["f64-dot", "precise"])
@pytest.mark.parametrize("limbs", [False, True], ids=["f64-force", "kernel3"])
def test_elm2_step_q_matches_jax(limbs, precise):
    """30 elm2_step_q steps from the same carry (interop), half of them
    deferring the velocity as generation does, then elm2_velocity_q."""
    pos, vel, mu = _system()
    ja, jal, ta, tal = _forces(mu, limbs)
    jtab, tab = jget(QT12), get(QT12)
    jc = jms.elm2_init_q(jtab, ja, 0.0, jnp.asarray(pos), jnp.asarray(vel), H, accel_limbs=jal)
    tc = interop.carry_q_from(jc)
    for i in range(30):
        jc = jms.elm2_step_q(jtab, ja, H, jc, accel_limbs=jal, with_velocity=i % 2 == 0,
                             precise_sums=precise)
        tc = ms.elm2_step_q(tab, ta, H, tc, accel_limbs=tal, with_velocity=i % 2 == 0,
                            precise_sums=precise)
    y_bar, a_bar, v_bar = _BARS[limbs]
    assert tc.t == float(jc.t)
    assert _exp_err([l[0] for l in tc.ys], [l[0] for l in jc.ys]) <= y_bar
    assert _rel(tc.ddys, jc.ddys) <= a_bar
    assert _rel(tc.dy, jc.dy) <= v_bar
    v_t = ms.elm2_velocity_q(tab, tc, H, precise_sums=precise)
    assert _rel(v_t, jms.elm2_velocity_q(jtab, jc, H, precise_sums=precise)) <= v_bar


def test_precise_sums_consistent_with_f64_dot():
    """precise_sums=True agrees with the f64-dot path to the dot's own
    accuracy over 5 steps (test_elm2_step_q_precise_sums_consistent: mm
    level in km, 1e-9 km/s)."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1.5e8, 1.5e8, (8, 3))
    vel = rng.uniform(-20, 20, (8, 3))
    mu = torch.tensor(rng.uniform(1e4, 1e8, 8))
    tab = get(QT12)

    def accel(t, y):
        return nbody.pairwise_accel(y, mu)

    ca = cb = ms.elm2_init_q(tab, accel, 0.0, torch.tensor(pos), torch.tensor(vel), H)
    for _ in range(5):
        ca = ms.elm2_step_q(tab, accel, H, ca)
        cb = ms.elm2_step_q(tab, accel, H, cb, precise_sums=True)
    ya, yb = ex.to_f64(tuple(l[0] for l in ca.ys)), ex.to_f64(tuple(l[0] for l in cb.ys))
    assert (ya - yb).abs().max() <= 1e-6
    assert (ca.dy - cb.dy).abs().max() <= 1e-9
