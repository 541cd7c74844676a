"""Kernel 1's ensemble form and the ensemble scans against the JAX package's.

Kernel 1's ensemble form runs as its plain version here (CPU tensors); the
JAX side runs its Pallas ensemble grid in interpret mode, as
``tests/test_pallas_nbody.py`` and ``tests/test_sharding.py`` do.  Inputs
come from numpy with a seed.  The kernel-against-plain cases on the card
are in ``test_torch_cuda.py``.

Tolerances.  Kernel 1 against the Pallas kernel: 1e-13 of max |a|, the bar
of ``test_torch_nbody.py`` (same pair chain, sums in another order).  The
pair-native ensemble scan against the JAX package's after 20 steps: 2^-40
of max |y|, the bar ``test_fused_ensemble_scan_f_matches_plain`` holds the
JAX scan to against its f64 scan.  The f64 ensemble scan against the JAX
package's: 1e-13 of max |y| (both native f64; the starts and the forces
round differently at 1e-16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.ops import pallas_nbody as jp
from ephemeris_explorer_tpu.parallel import sharding as jsh
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_nbody
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
from ephemeris_explorer_tpu_torch.parallel import sharding as sh

QT12 = "QuinlanTremaine12"
H = 600.0
KERNEL1_VS_PALLAS = 1e-13
SCAN_F_VS_JAX = 2.0**-40
SCAN_F64_VS_JAX = 1e-13


def _ensemble(e, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, n, 3)) * 1.0e6, rng.normal(size=(e, n, 3)) * 1.0,
            rng.uniform(1.0e3, 1.0e5, size=n))


def _split_members(pos):
    """(E, N, 3) f64 -> (E, 3, N) f32 hi/lo, and the (1, N) mu split."""
    return cuda_nbody.split_f64(torch.tensor(pos).transpose(1, 2))


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _y(ys):
    """The ring head as f64 numpy, from an f64 or a pair ring of either
    package."""
    if isinstance(ys, torch.Tensor):
        return ys[0].numpy()
    return np.asarray(ys.hi[0], np.float64) + np.asarray(ys.lo[0], np.float64)


# -- kernel 1's ensemble form --------------------------------------------------

@pytest.mark.parametrize("e, n", [(3, 20), (1, 7), (2, 1)])
def test_ensemble_plain_is_the_member_loop(e, n):
    """The ensemble form's plain version equals the square form's plain
    version on each member, bitwise, and launches nothing on CPU tensors."""
    pos, _, mu = _ensemble(e, n, 1)
    ph, pl = _split_members(pos)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    before = cuda_nbody.pairwise_accel_df64_ensemble.launches
    ah, al = cuda_nbody.pairwise_accel_df64_ensemble(ph, pl, mh, ml)
    assert cuda_nbody.pairwise_accel_df64_ensemble.launches == before
    assert ah.shape == (e, n, 3) and ah.dtype == torch.float32
    for m in range(e):
        sh_, sl = cuda_nbody.pairwise_accel_df64_plain(ph[m], pl[m], mh, ml)
        assert torch.equal(ah[m], sh_) and torch.equal(al[m], sl)


def test_ensemble_plain_matches_pallas():
    """The drop-in f64 ensemble force against the JAX package's
    ``pairwise_accel_ensemble`` (interpret mode, 32 x 64 tiles) at e=3,
    n=64: <= 1e-13 of max |a| per member."""
    pos, _, mu = _ensemble(3, 64, 2)
    jmh, jml = jp.split_f64(jnp.asarray(mu).reshape(1, -1))
    ref = np.asarray(jp.pairwise_accel_ensemble(jnp.asarray(pos), jmh, jml, interpret=True,
                                                tile_rows=32, tile_cols=64))
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    got = cuda_nbody.pairwise_accel_ensemble(torch.tensor(pos), mh, ml)
    assert got.dtype == torch.float64 and got.shape == (3, 64, 3)
    for m in range(3):
        assert _rel(got[m], ref[m]) <= KERNEL1_VS_PALLAS


def test_ensemble_wrapper_rejects_unsupported_device():
    pos, _, mu = _ensemble(2, 8, 3)
    ph, pl = (x.to("meta") for x in _split_members(pos))
    mh, ml = (x.to("meta") for x in cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1)))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nbody.pairwise_accel_df64_ensemble(ph, pl, mh, ml)


# -- the ensemble scans ----------------------------------------------------------

@pytest.fixture(scope="module")
def scans():
    """The port's and the JAX package's ensemble scans at e=2, n=16, 20
    steps (tests/test_sharding.py's fused-ensemble fixture)."""
    e, n, steps = 2, 16, 20
    pos, vel, mu = _ensemble(e, n, 9)
    carry0 = sh.init_fused_ensemble_carry(get(QT12), mu, 0.0, pos, vel, H, device="cpu")
    run_f, to_f = sh.make_fused_ensemble_scan_f(get(QT12), mu, H, steps, device="cpu")
    run64 = sh.make_fused_ensemble_scan(get(QT12), mu, H, steps, device="cpu")
    jtab = jget(QT12)
    jcarry0 = jsh.init_fused_ensemble_carry(jtab, mu, 0.0, pos, vel, H)
    jrun_f, jto_f = jsh.make_fused_ensemble_scan_f(jtab, mu, H, steps, interpret=True,
                                                   tile_rows=8, tile_cols=8)
    return {"carry0": carry0, "f": run_f(to_f(carry0)), "f64": run64(carry0),
            "jcarry0": jcarry0, "jf": jrun_f(jto_f(jcarry0)),
            "jf64": jsh.make_fused_ensemble_scan(jtab, mu, H, steps)(jcarry0), "mu": mu}


def test_init_fused_ensemble_carry_matches_jax(scans):
    """The startup carries: (ORDER, E, N, 3) rings, within 1e-14 of the JAX
    package's (both native f64)."""
    c, j = scans["carry0"], scans["jcarry0"]
    assert tuple(c.ys.shape) == (12, 2, 16, 3) and c.t == pytest.approx(float(j.t))
    assert _rel(c.ys.numpy(), j.ys) <= 1e-14
    assert _rel(c.ddys.numpy(), j.ddys) <= 1e-14


def test_fused_ensemble_scan_f_matches_jax(scans):
    """The pair-native ensemble scan against the JAX package's after 20
    steps: 2^-40 of max |y|; the velocities 1e-8 of max |v| (the bar of
    test_fused_ensemble_scan_f_matches_plain)."""
    y, yj = _y(scans["f"].ys), _y(scans["jf"].ys)
    assert np.abs(y - yj).max() <= SCAN_F_VS_JAX * np.abs(yj).max()
    dy, dyj = scans["f"].dy.numpy(), np.asarray(scans["jf"].dy)
    assert np.abs(dy - dyj).max() <= 1e-8 * np.abs(dyj).max()


def test_fused_ensemble_scan_matches_jax(scans):
    """The f64 ensemble scan against the JAX package's after 20 steps:
    1e-13 of max |y|; and the pair-native scan tracks it at 2^-40."""
    y, yj = _y(scans["f64"].ys), np.asarray(scans["jf64"].ys[0])
    assert np.abs(y - yj).max() <= SCAN_F64_VS_JAX * np.abs(yj).max()
    assert np.abs(_y(scans["f"].ys) - y).max() <= SCAN_F_VS_JAX * np.abs(y).max()


def test_fused_ensemble_member_is_the_single_system_scan(scans):
    """Each member of the pair-native ensemble scan equals the
    single-system fused scan (elm2_step_f with kernel 1's square form) on
    that member, bitwise."""
    tab, mu = get(QT12), scans["mu"]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))

    def accel_pair(t, y):
        return TwoFloat(*cuda_nbody.pairwise_accel_df64(y.hi.t().contiguous(),
                                                        y.lo.t().contiguous(), mh, ml))

    c0, out = scans["carry0"], scans["f"]
    for m in range(2):
        c = ms.elm2_f_from(ms.ELM2Carry(t=c0.t, ys=c0.ys[:, m], ddys=c0.ddys[:, m], dy=c0.dy[m]))
        for _ in range(20):
            c = ms.elm2_step_f(tab, accel_pair, H, c)
        for ring, ref in ((out.ys, c.ys), (out.dd, c.dd)):
            assert torch.equal(ring.hi[:, m], ref.hi) and torch.equal(ring.lo[:, m], ref.lo)
