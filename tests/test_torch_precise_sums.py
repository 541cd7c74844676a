"""The port's pair-precision beta sums against the JAX package's.

``multistep._wsum_precise`` forms each term with exact f32 two_prods against
weights split on the host into three f32 limbs (``_precise_weights``), and
accumulates through a cascaded error-free reduction.  The JAX package runs that cascade eagerly
(and on its TPU) but sends XLA:CPU traces to a native-f64 dot, because that
compiler folds the cascade; the port runs the cascade as written on every
device.  These tests are also the proof that it survives eager torch on the
CPU: the result is held to the design grade (< 1e-17 relative) against an
extended-precision oracle.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms


def _ring(n=64, seed=0, period=136.0):
    """A smooth acceleration ring (12, n), split into f32 pairs
    (test_precise_sums._ring)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 2.0, (1, n)) * 1e-3
    f64 = base * np.cos(2 * np.pi * np.arange(12)[:, None] / period + rng.uniform(0, 6.28, (1, n)))
    hi = f64.astype(np.float32)
    lo = (f64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _oracle(w, hi, lo):
    vals = hi.astype(np.longdouble) + lo.astype(np.longdouble)
    w128 = np.array([np.longdouble(x) for x in w])[:, None]
    return np.sum(w128 * vals, axis=0)


def _weights(h=600.0):
    """QT12's pre-scaled beta weights: (f64 values, their 3-limb splits)."""
    tab = get("QuinlanTremaine12")
    args = (tab.c_dy, h * h, float(tab.beta_d))
    return ms._prescale_f128(*args), ms._precise_weights(*args)


def test_host_helpers_equal_jax():
    """_split3_host, _prescale_f128 and _dekker_split_f32_host return the JAX
    package's values, and the 3-limb split is exact."""
    rng = np.random.default_rng(1)
    for w in rng.uniform(-1e9, 1e9, 50):
        assert ms._split3_host(float(w)) == jms._split3_host(float(w))
        c0, c1, c2 = ms._split3_host(float(w))
        assert float(np.longdouble(c0) + np.longdouble(c1) + np.longdouble(c2)) == float(w)
        assert ms._dekker_split_f32_host(float(w)) == jms._dekker_split_f32_host(float(w))
    tab, jtab = get("QuinlanTremaine12"), jget("QuinlanTremaine12")
    for h in (600.0, -600.0, 21600.0):
        assert ms._prescale_f128(tab.c_dy, h * h, float(tab.beta_d)) == jms._prescale_f128(
            jtab.c_dy, h * h, float(jtab.beta_d))
        assert ms._prescale_f128(tab.cowell_beta_n, h, float(tab.cowell_beta_d)) == (
            jms._prescale_f128(jtab.cowell_beta_n, h, float(jtab.cowell_beta_d)))
        w, limbs = _weights(h)
        assert limbs == tuple(jms._split3_host(x) for x in w)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 12, 47, 58])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_sum_reduce_error_free(m, dtype):
    """root + sum(errs) == sum(vals) exactly (both sides correctly rounded by
    math.fsum agree bitwise), with m - 1 error terms."""
    rng = np.random.default_rng(7 + m)
    vals = torch.tensor(rng.uniform(-1.0, 1.0, (m, 4)) * np.logspace(-6, 6, m)[:, None],
                        dtype=dtype)
    root, errs = ms._two_sum_reduce(vals)
    assert sum(int(e.shape[0]) for e in errs) == m - 1
    for col in range(vals.shape[1]):
        lhs = math.fsum([float(root[col])] + [float(e[i, col]) for e in errs
                                               for i in range(e.shape[0])])
        assert lhs == math.fsum(float(v) for v in vals[:, col])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wsum_precise_design_grade(seed):
    """The cascade on torch CPU: < 1e-17 relative of the extended-precision
    sum (test_wsum_precise_eager_design_grade's bar), and < 1e-17 relative of
    the JAX package's eager cascade (the last level's plain f32 sum may run
    in another order)."""
    w, limbs = _weights()
    hi, lo = _ring(seed=seed)
    out = ms._wsum_precise(limbs, torch.from_numpy(hi), torch.from_numpy(lo))
    assert len(out) == 4 and all(l.dtype == torch.float32 for l in out)
    got = sum(l.numpy().astype(np.longdouble) for l in out)
    oracle = _oracle(w, hi, lo)
    assert float(np.max(np.abs((got - oracle) / oracle))) < 1e-17
    jout = jms._wsum_precise(w, jnp.asarray(hi), jnp.asarray(lo))  # eager: the cascade
    jgot = sum(np.asarray(l).astype(np.longdouble) for l in jout)
    assert float(np.max(np.abs((got - jgot) / jgot))) < 1e-17
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))


def test_wsum_precise_skips_zero_weights():
    """Zero weights (QT12's last c_dy) drop their rows: the result equals the
    sum over the nonzero rows alone."""
    w, limbs = _weights()
    assert w[-1] == 0.0 and limbs[-1] == (0.0, 0.0, 0.0)
    hi, lo = _ring(n=16, seed=4)
    full = ms._wsum_precise(limbs, torch.from_numpy(hi), torch.from_numpy(lo))
    cut = ms._wsum_precise(limbs[:-1], torch.from_numpy(hi[:-1]), torch.from_numpy(lo[:-1]))
    for a, b in zip(full, cut):
        assert torch.equal(a, b)
