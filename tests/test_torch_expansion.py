"""The port's f32 expansions (``ops/expansion.py``) against the JAX package's.

Each op runs eagerly on both sides, one rounding per op, so the port is held
to bitwise equality.  The JAX package's own properties (exact host split,
~2^-80 adds, ~2^-85 QT12 alpha sum) are checked on the port against exact
rational arithmetic.  Inputs are normal f32 magnitudes: XLA:CPU flushes f32
subnormals and eager torch does not.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.ops import expansion as jex
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.ops import expansion as ex


def _limbs(seed, n=97, scale=1e8):
    """4-limb expansions of random values with full mantissas."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * scale * 10.0 ** rng.uniform(-2, 2, size=n)
    limbs = [np.asarray(l) for l in jex.from_f64_host(v)]
    limbs[3] = (limbs[2].astype(np.float64) * 2.0**-25 * rng.uniform(-1, 1, n)).astype(np.float32)
    return limbs


def _same(out_t, out_j):
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _exact(limbs):
    return sum(Fraction(float(x)) for x in limbs)


_OPS = ["renorm5", "renorm8", "renorm3", "add", "from_two", "from_f64", "to_f64",
        "hi_lo", "scale_pow2i", "neg", "zeros"]


@pytest.mark.parametrize("op", _OPS)
def test_expansion_op_matches_jax_bitwise(op):
    a, b = _limbs(_OPS.index(op)), _limbs(100 + _OPS.index(op), scale=1e3)
    J = lambda ls: tuple(jnp.asarray(x) for x in ls)  # noqa: E731
    T = lambda ls: tuple(torch.from_numpy(np.array(x)) for x in ls)  # noqa: E731
    if op.startswith("renorm"):
        k = int(op[-1])
        args = (a + b)[:k]
        _same(ex.renorm(*T(args)), jex.renorm(*J(args)))
    elif op == "add":
        _same(ex.add(T(a), T(b)), jex.add(J(a), J(b)))
    elif op == "from_two":
        _same(ex.from_two(*T(a[:2])), jex.from_two(*J(a[:2])))
    elif op == "from_f64":
        v = np.random.default_rng(5).normal(size=64) * 1e9
        _same(ex.from_f64(torch.from_numpy(v)), jex.from_f64(jnp.asarray(v)))
    elif op == "to_f64":
        _same(ex.to_f64(T(a)), jex.to_f64(J(a)))
    elif op == "hi_lo":
        _same(ex.hi_lo(T(a)), jex.hi_lo(J(a)))
    elif op == "scale_pow2i":
        for c in (1.0, -1.0, 2.0, -2.0):
            _same(ex.scale_pow2i(T(a), c), jex.scale_pow2i(J(a), c))
    elif op == "neg":
        _same(ex.neg(T(a)), jex.neg(J(a)))
    else:
        _same(ex.zeros((3, 5)), jex.zeros((3, 5)))


def test_from_f64_host_exact_and_equal():
    """Three f32 limbs hold any binary64 exactly; the fourth is zero; the
    split is the JAX package's, on the requested device."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(64, 3)) * 10.0 ** rng.integers(3, 10, (64, 3))
    limbs = ex.from_f64_host(v, device="cpu")
    assert all(l.dtype == torch.float32 and l.shape == (64, 3) for l in limbs)
    recon = np.zeros_like(v)
    for l in limbs[::-1]:
        recon = recon + l.numpy().astype(np.float64)
    np.testing.assert_array_equal(recon, v)
    assert not limbs[-1].any()
    for a, b in zip(limbs, jex.from_f64_host(v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_from_to_f64_round_trip_exact():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=100) * 10.0 ** rng.integers(-8, 8, 100))
    assert torch.equal(ex.to_f64(ex.from_f64(v)), v)


def test_add_precision():
    """Expansion adds keep < 2^-80 relative accuracy across mixed magnitudes
    (the JAX package's bar, test_expansion.test_add_precision)."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(200):
        vals = [float(rng.normal() * 10.0 ** rng.integers(-6, 9)) for _ in range(6)]
        acc = ex.from_f64(torch.tensor(vals[0], dtype=torch.float64))
        exact = Fraction(vals[0])
        for v in vals[1:]:
            acc = ex.add(acc, ex.from_f64(torch.tensor(v, dtype=torch.float64)))
            exact += Fraction(v)
        got = _exact([float(l) for l in acc])
        rel = abs(got - exact) / max(abs(exact), Fraction(1, 10**30))
        worst = max(worst, float(rel))
    assert worst < 2.0**-80, worst


def test_elm2_alpha_sum_accuracy():
    """The QT12 position combination (heavy cancellation) in expansions:
    < 2^-85 of the position (test_expansion.test_elm2_alpha_sum_accuracy)."""
    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(3)
    ys = 1.5e8 + np.cumsum(rng.normal(size=12) * 2.0)
    exact = sum(Fraction(c) * Fraction(y) for c, y in zip(tab.c_y, ys))
    acc = None
    for c, y in zip(tab.c_y, ys):
        if c == 0.0:
            continue
        term = ex.scale_pow2i(ex.from_f64(torch.tensor(y, dtype=torch.float64)), c)
        acc = term if acc is None else ex.add(acc, term)
    rel = abs(_exact([float(l) for l in acc]) - exact) / Fraction(ys[0])
    assert float(rel) < 2.0**-85, float(rel)
