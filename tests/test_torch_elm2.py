"""Kernel 2 (the two-float ELM2 update) and the two-float carry against JAX.

The JAX side runs its Pallas update kernel and pair-force kernel in
interpret mode with small tiles, as its own tests do; the port runs the
kernels' plain versions (CPU tensors).  Inputs come from numpy with a seed
and cross over through ``interop``.

The kernel-against-plain cases on the card are in ``test_torch_cuda.py``,
which imports no JAX so that it runs on a GPU machine without it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops import pallas_elm2 as jelm2
from ephemeris_explorer_tpu.ops.eft import TwoFloat as JTwoFloat
from ephemeris_explorer_tpu.ops.pallas_nbody import pairwise_accel_df64 as jaccel_df64
from ephemeris_explorer_tpu.ops.pallas_nbody import split_f64 as jsplit
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_nbody
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat

QT12 = "QuinlanTremaine12"


def _rings(n, seed, order=12):
    """Random QT12-shaped rings: positions ~1e8 km, accelerations ~1e-6."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(order, n, 3)) * 1e8
    a = rng.normal(size=(order, n, 3)) * 1e-6

    def pair(x):
        hi = x.astype(np.float32)
        return hi, (x - hi.astype(np.float64)).astype(np.float32)

    return pair(y), pair(a)


def test_update_coeffs_equal():
    for h in (600.0, -600.0, 21600.0):
        np.testing.assert_array_equal(
            cuda_elm2.elm2_update_coeffs(get(QT12), h), jelm2.elm2_update_coeffs(jget(QT12), h)
        )


@pytest.mark.parametrize("n, seed", [(64, 0), (33, 1)])
def test_kernel2_plain_matches_pallas(n, seed):
    """Kernel 2's plain version against elm2f_update(interpret=True):
    <= 2^-48 max|y| (same ops in the same order; reported if bitwise)."""
    (yh, yl), (ah, al) = _rings(n, seed)
    ref = jelm2.elm2f_update(jget(QT12), 600.0, JTwoFloat(jnp.asarray(yh), jnp.asarray(yl)),
                             JTwoFloat(jnp.asarray(ah), jnp.asarray(al)), interpret=True)
    before = cuda_elm2.elm2f_update.launches
    out = cuda_elm2.elm2f_update(get(QT12), 600.0, interop.pair_from((yh, yl)),
                                 interop.pair_from((ah, al)))
    assert cuda_elm2.elm2f_update.launches == before  # CPU: plain version
    ref64 = np.asarray(ref.hi, np.float64) + np.asarray(ref.lo, np.float64)
    out64 = out.hi.double().numpy() + out.lo.double().numpy()
    err = np.abs(out64 - ref64).max()
    bitwise = np.array_equal(out.hi.numpy(), np.asarray(ref.hi)) and np.array_equal(
        out.lo.numpy(), np.asarray(ref.lo))
    print(f"kernel 2 plain vs Pallas interpret: bitwise={bitwise} max|d|={err:.3g}")
    assert err <= 2.0**-48 * np.abs(ref64).max()


def _fused_setup(n=8):
    """test_fused_twofloat_state_matches_plain's system on both sides."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    vel = rng.normal(size=(n, 3)) * 1.0
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    return pos, vel, mu


def test_fused_steps_match_jax():
    """30 elm2_step_f steps at n=8, port (plain kernel versions) against JAX
    (Pallas kernels, interpret): <= 2^-42 max|y| (the bar of
    test_fused_twofloat_state_matches_plain), and the deferred velocity
    within 1e-8 of max|v|."""
    pos, vel, mu = _fused_setup()
    h = 600.0
    jtab, tab = jget(QT12), get(QT12)
    mu_j = jnp.asarray(mu)
    mh, ml = jsplit(mu_j.reshape(1, -1))

    def jaccel_pair(t, y):
        return JTwoFloat(*jaccel_df64(y.hi.T, y.lo.T, mh, ml, interpret=True,
                                      tile_rows=8, tile_cols=8))

    jc = jms.elm2_f_from(jms.elm2_init(jtab, lambda t, y: jnbody.pairwise_accel(y, mu_j),
                                       0.0, jnp.asarray(pos), jnp.asarray(vel), h))
    tmh, tml = interop.mu_pair_from(mh, ml)

    def accel_pair(t, y):
        return TwoFloat(*cuda_nbody.pairwise_accel_df64(
            y.hi.t().contiguous(), y.lo.t().contiguous(), tmh, tml))

    tc = interop.carry_f_from(jc)  # both sides start from the same bits
    for _ in range(30):
        jc = jms.elm2_step_f(jtab, jaccel_pair, h, jc, interpret=True)
        tc = ms.elm2_step_f(tab, accel_pair, h, tc)
    assert tc.t == float(jc.t)
    y_j = np.asarray(jc.ys.hi[0], np.float64) + np.asarray(jc.ys.lo[0], np.float64)
    back = interop.to_numpy(tc)  # the carry back as numpy arrays
    y_t = back.ys.hi[0].astype(np.float64) + back.ys.lo[0].astype(np.float64)
    assert np.abs(y_t - y_j).max() <= 2.0**-42 * np.abs(y_j).max()
    v_j = np.asarray(jms.elm2_velocity_f(jtab, jc, h))
    v_t = ms.elm2_velocity_f(tab, tc, h).numpy()
    np.testing.assert_allclose(v_t, v_j, atol=np.abs(v_j).max() * 1e-8, rtol=0)


def test_carry_conversion_exact():
    """elm2_f_from splits exactly as the JAX package does; elm2_f_to inverts."""
    pos, vel, mu = _fused_setup(5)
    mu_j = jnp.asarray(mu)
    jc = jms.elm2_init(jget(QT12), lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0,
                       jnp.asarray(pos), jnp.asarray(vel), 600.0)
    jf = jms.elm2_f_from(jc)
    tf = ms.elm2_f_from(interop.carry_from(jc))
    for a, b in ((tf.ys.hi, jf.ys.hi), (tf.ys.lo, jf.ys.lo), (tf.dd.hi, jf.dd.hi),
                 (tf.dd.lo, jf.dd.lo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ms.elm2_f_to(tf).ys.numpy(), np.asarray(jms.elm2_f_to(jf).ys))
