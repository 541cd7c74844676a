"""Kernel 4 (the 4-limb expansion ELM2 update) and the fused expansion carry.

The port runs the kernel's plain version (CPU tensors); the JAX side runs
``elm2q_update`` in interpret mode and its pair-force kernel likewise, as its
own tests do.  Inputs come from numpy with a seed and cross over through
``interop``.  The kernel-against-plain cases on the card are in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import expansion as jex
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops import pallas_elm2 as jelm2
from ephemeris_explorer_tpu.ops.eft import TwoFloat as JTwoFloat
from ephemeris_explorer_tpu.ops.pallas_nbody import pairwise_accel_limbs_pair, split_f64
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_elm2q, cuda_limbs, cuda_nbody, nbody
from ephemeris_explorer_tpu_torch.ops import expansion as ex

QT12 = "QuinlanTremaine12"
H = 600.0


def _rings(n, seed, order=12):
    """QT12-shaped rings: 4-limb positions ~1e8 km with deep limbs, and
    (hi, lo) accelerations ~1e-6 km/s^2."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(order, n, 3)) * 1e8
    limbs = [np.asarray(l) for l in jex.from_f64_host(y)]
    limbs[3] = (limbs[2].astype(np.float64) * 2.0**-25
                * rng.uniform(-1, 1, y.shape)).astype(np.float32)
    a = rng.normal(size=(order, n, 3)) * 1e-6
    hi = a.astype(np.float32)
    return limbs, (hi, (a - hi.astype(np.float64)).astype(np.float32))


def test_update_coeffs_equal():
    for h in (600.0, -600.0, 21600.0):
        np.testing.assert_array_equal(cuda_elm2q.elm2_update_coeffs_precise(get(QT12), h),
                                      jelm2.elm2_update_coeffs_precise(jget(QT12), h))


def _jax_eager_update(limbs, ah, al, precise):
    """The Pallas kernel body's op sequence (pallas_elm2._update_kernel) as
    eager jnp ops, one rounding each."""
    from ephemeris_explorer_tpu.ops import eft as jeft

    tab = jget(QT12)
    nz = [j for j, c in enumerate(tab.c_dy) if float(c) != 0.0]
    ys = [jnp.asarray(l) for l in limbs]
    hi, lo = jnp.asarray(ah), jnp.asarray(al)
    if precise:
        cf = jelm2.elm2_update_coeffs_precise(tab, H)
        full = lambda v: jnp.full(hi.shape[1:], v)  # noqa: E731
        inc = None
        for j in nz:
            b0, b1, b2 = full(cf[j, 0]), full(cf[j, 1]), full(cf[j, 2])
            p, pe = jeft.two_prod(hi[j], b0)
            q, qe = jeft.two_prod(lo[j], b0)
            r, re = jeft.two_prod(hi[j], b1)
            term = jex.renorm(p, pe, q, r, qe + re + lo[j] * b1 + hi[j] * b2)
            inc = term if inc is None else jex.add(inc, term)
    else:
        cf = jelm2.elm2_update_coeffs(tab, H)
        pair = lambda j: JTwoFloat(jnp.full(hi.shape[1:], cf[j, 0]),  # noqa: E731
                                   jnp.full(hi.shape[1:], cf[j, 1]))
        acc = None
        for j in nz:
            term = jeft.mul(JTwoFloat(hi[j], lo[j]), pair(j))
            acc = term if acc is None else jeft.add(acc, term)
        inc = jex.from_two(*jeft.mul(acc, pair(len(tab.c_y))))
    total = None
    for j, c in enumerate(tab.c_y):
        if float(c) != 0.0:
            term = tuple(l[j] * jnp.float32(c) for l in ys)
            total = term if total is None else jex.add(total, term)
    return jex.add(total, inc)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n, seed", [(8, 0), (33, 1)])
def test_kernel4_plain_matches_pallas(n, seed, precise):
    """Kernel 4's plain version in both modes: bitwise against the Pallas
    kernel's op sequence run as eager jnp ops, and against
    elm2q_update(interpret=True) bitwise in the two leading limbs and within
    2^-64 of max|y| in value (the JAX tests' own bar is 2^-50).  The
    interpret-mode kernel (under jit or disable_jit alike) runs its body as
    one XLA:CPU program, which rounds the deep limbs of the fused renorm
    cascades differently (the re-rounding the JAX package documents in
    ops/pallas_elm2.py): measured, limb 2 differs by up to an ulp, ~2^-72
    of max|y|, in plain mode; limb 3 only in precise mode."""
    limbs, (ah, al) = _rings(n, seed)
    ref = jelm2.elm2q_update(jget(QT12), H, tuple(jnp.asarray(l) for l in limbs),
                             JTwoFloat(jnp.asarray(ah), jnp.asarray(al)),
                             interpret=True, precise=precise)
    before = cuda_elm2q.elm2q_update.launches
    out = cuda_elm2q.elm2q_update(get(QT12), H, interop.limbs_from(limbs),
                                  interop.pair_from((ah, al)), precise=precise)
    assert cuda_elm2q.elm2q_update.launches == before  # CPU: plain version
    assert len(out) == 4 and all(a.shape == (n, 3) for a in out)
    for a, b in zip(out, _jax_eager_update(limbs, ah, al, precise)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    deep = sum(a.numpy().astype(np.float64) - np.asarray(b, np.float64)
               for a, b in zip(out[2:], ref[2:]))
    assert np.abs(deep).max() <= 2.0**-64 * np.abs(np.asarray(ref[0])).max()


def _system(n=8, seed=9):
    """test_fused_precise_sums_kernel's cluster."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.0e6, rng.normal(size=(n, 3)), rng.uniform(1e3, 1e5, n)


def _port_forces(mu):
    mu_t = torch.tensor(mu)
    mh, ml = cuda_nbody.split_f64(mu_t.reshape(1, -1))

    def accel(t, y):
        return nbody.pairwise_accel(y, mu_t)

    def accel_limbs(t, limbs):
        return cuda_limbs.pairwise_accel_limbs(*limbs, mh, ml)

    def accel_pair(t, limbs):
        return cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)

    return accel, accel_limbs, accel_pair


def _head(ys):
    return ex.to_f64(tuple(l[0] for l in ys)).numpy()


@pytest.mark.parametrize("precise", [False, True])
def test_step_qf_matches_step_q(precise):
    """One port elm2_step_qf (kernel 4 + kernel 3) against one port
    elm2_step_q (unfused chain + kernel 3) from the same carry: <= 2^-50
    max|y| (test_fused_elm2_update_matches_unfused /
    test_fused_precise_sums_kernel's bar), and both carries advance alike."""
    pos, vel, mu = _system()
    tab = get(QT12)
    accel, accel_limbs, accel_pair = _port_forces(mu)
    q = ms.elm2_init_q(tab, accel, 0.0, torch.tensor(pos), torch.tensor(vel), H)
    qf = ms.elm2_qf_from_q(q)
    q1 = ms.elm2_step_q(tab, accel, H, q, accel_limbs=accel_limbs, with_velocity=False,
                        precise_sums=precise)
    qf1 = ms.elm2_step_qf(tab, accel_pair, H, qf, precise_sums=precise)
    y1q, y1f = _head(q1.ys), _head(qf1.ys)
    assert np.abs(y1f - y1q).max() <= np.abs(y1q).max() * 2.0**-50
    assert qf1.t == q1.t == q.t + H
    assert all(l.shape == (12, 8, 3) for l in qf1.ys) and qf1.dd.hi.shape == (12, 8, 3)
    for a, b in zip(qf1.ys, q1.ys):  # the older ring rows are shifted unchanged
        assert torch.equal(a[1:], b[1:])


def test_step_qf_matches_jax():
    """30 port elm2_step_qf steps (plain kernel versions) against 30 JAX steps
    (Pallas kernels, interpret) from the same carry, precise sums on:
    <= 2^-44 max|y|.  The update matches bitwise; the two kernel-3 versions
    sum in other orders (1e-14 of the force), which this dense cluster
    amplifies over 30 steps."""
    pos, vel, mu = _system()
    jtab, tab = jget(QT12), get(QT12)
    mu_j = jnp.asarray(mu)
    jmh, jml = split_f64(mu_j.reshape(1, -1))

    def jaccel_pair(t, limbs):
        return pairwise_accel_limbs_pair(*limbs, jmh, jml, interpret=True, tile_rows=8,
                                         tile_cols=8)

    jq = jms.elm2_init_q(jtab, lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0,
                         jnp.asarray(pos), jnp.asarray(vel), H)
    jc = jms.elm2_qf_from_q(jq)
    tc = interop.carry_qf_from(jc)
    _, _, accel_pair = _port_forces(mu)
    for _ in range(30):
        jc = jms.elm2_step_qf(jtab, jaccel_pair, H, jc, interpret=True, precise_sums=True)
        tc = ms.elm2_step_qf(tab, accel_pair, H, tc, precise_sums=True)
    assert tc.t == float(jc.t)
    y_j = np.asarray(jex.to_f64(tuple(l[0] for l in jc.ys)))
    assert np.abs(_head(tc.ys) - y_j).max() <= 2.0**-44 * np.abs(y_j).max()
    v_j = np.asarray(jms.elm2_velocity_qf(jtab, jc, H, precise_sums=True))
    v_t = ms.elm2_velocity_qf(tab, tc, H, precise_sums=True).numpy()
    assert np.abs(v_t - v_j).max() <= 1e-8 * np.abs(v_j).max()


def test_qf_q_round_trip_exact():
    """elm2_qf_from_q splits the ring as the JAX package does; elm2_qf_to_q
    converts back exactly, and q -> qf -> q -> qf keeps the ring values."""
    pos, vel, mu = _system(5, 2)
    mu_j = jnp.asarray(mu)
    jq = jms.elm2_init_q(jget(QT12), lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0,
                         jnp.asarray(pos), jnp.asarray(vel), H)
    tq = interop.carry_q_from(jq)
    tf, jf = ms.elm2_qf_from_q(tq), jms.elm2_qf_from_q(jq)
    for a, b in ((tf.dd.hi, jf.dd.hi), (tf.dd.lo, jf.dd.lo), *zip(tf.ys, jf.ys)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = ms.elm2_qf_to_q(tf)
    np.testing.assert_array_equal(back.ddys.numpy(), np.asarray(jms.elm2_qf_to_q(jf).ddys))
    again = ms.elm2_qf_from_q(back)
    assert torch.equal(again.dd.hi, tf.dd.hi) and torch.equal(again.dd.lo, tf.dd.lo)
    assert all(a is b for a, b in zip(again.ys, tf.ys)) and torch.equal(again.dy, tf.dy)
    # elm2_init_qf is the startup followed by the split
    mu_t = torch.tensor(mu)
    args = (get(QT12), lambda t, y: nbody.pairwise_accel(y, mu_t), 0.0, torch.tensor(pos),
            torch.tensor(vel), H)
    qf, q = ms.elm2_init_qf(*args), ms.elm2_qf_from_q(ms.elm2_init_q(*args))
    assert all(torch.equal(a, b) for a, b in zip((*qf.ys, *qf.dd, qf.dy), (*q.ys, *q.dd, q.dy)))
