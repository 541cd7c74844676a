"""Kernel 10 (the symmetric third-law two-float pair force) against the JAX
package's ``pairwise_accel_sym`` and against kernel 1.

The port runs the kernel's plain version (CPU tensors); the JAX side runs
its Pallas kernel in interpret mode, as ``tests/test_pallas_nbody.py``
does.  Inputs come from numpy with a seed.  The kernel-against-plain cases
on the card are in ``test_torch_cuda.py``.

Bars: 2^-44 of max |a|, ``test_symmetric_kernel_matches_row_sweep``'s bar,
against the JAX kernel (whatever its tile) and against kernel 1's plain
version.  At equal tiles the plain version runs the JAX kernel's ops in its
order: it equals an eager replay of that kernel's grid loop bitwise, but
not the interpret-mode kernel, which XLA:CPU compiles as one program
(measured up to 3.1e-14 of max |a| at n = 64, ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.ops import pallas_nbody as jp
from ephemeris_explorer_tpu_torch.ops import cuda_nbody, cuda_sym, eft
from ephemeris_explorer_tpu_torch.ops.cuda_nbody import _dd_tree_sum, _rsqrt_df, _sqr_presplit
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat

SYM_BAR = 2.0**-44


def _cloud(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.0e6, rng.uniform(1.0e3, 1.0e5, size=n)


def _split(pos, mu):
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    return ph, pl, mh, ml


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n, tile", [(32, 8), (64, 8), (64, 16), (64, 32), (32, None)])
def test_sym_plain_matches_pallas(n, tile):
    """The plain version at tile ``tile`` (None: the kernel's 32) against
    the JAX package's symmetric kernel at tile 8: <= 2^-44 of max |a|."""
    pos, mu = _cloud(n)
    jmh, jml = jp.split_f64(jnp.asarray(mu).reshape(1, n))
    ref = np.asarray(jp.pairwise_accel_sym(jnp.asarray(pos), jmh, jml, interpret=True, tile=8))
    kw = {} if tile is None else {"tile": tile}
    got = cuda_nbody.combine_f64(*cuda_sym.pairwise_accel_df64_sym_plain(*_split(pos, mu), **kw))
    assert got.shape == (n, 3)
    assert _rel(got.numpy(), ref) <= SYM_BAR


@pytest.mark.parametrize("n", [32, 64, 96])
def test_sym_matches_kernel1(n):
    """Kernel 10 through its wrapper (the plain version on CPU tensors)
    against kernel 1's plain version: <= 2^-44 of max |a|; no launch."""
    args = _split(*_cloud(n, seed=n))
    before = cuda_sym.pairwise_accel_df64_sym.launches
    ah, al = cuda_sym.pairwise_accel_df64_sym(*args)
    assert cuda_sym.pairwise_accel_df64_sym.launches == before
    assert ah.dtype == torch.float32 and ah.shape == (n, 3)
    ref = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64_plain(*args))
    assert _rel(cuda_nbody.combine_f64(ah, al).numpy(), ref.numpy()) <= SYM_BAR


def test_sym_drop_in_matches_kernel1_drop_in():
    pos, mu = _cloud(64, seed=5)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    got = cuda_sym.pairwise_accel_sym(torch.tensor(pos), mh, ml)
    ref = cuda_nbody.pairwise_accel(torch.tensor(pos), mh, ml)
    assert got.dtype == torch.float64 and _rel(got.numpy(), ref.numpy()) <= SYM_BAR


def test_sym_rejects_non_multiple_n():
    """N must be a multiple of the tile, as in the reference."""
    args = _split(*_cloud(48))
    with pytest.raises(ValueError, match="multiple of its tile 32"):
        cuda_sym.pairwise_accel_df64_sym(*args)
    with pytest.raises(ValueError, match="multiple of its tile 16"):
        cuda_sym.pairwise_accel_df64_sym_plain(*_split(*_cloud(24)), tile=16)


def test_sym_rejects_unsupported_device():
    args = [x.to("meta") for x in _split(*_cloud(32))]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sym.pairwise_accel_df64_sym(*args)


def _grid_loop(pos_hi, pos_lo, mu_hi, mu_lo, t):
    """``_accel_kernel_sym``'s grid (pallas_nbody.py:593-748) replayed op for
    op in eager torch: tile rows in order, the row accumulator over column
    tiles j >= i, the resident column accumulator read-modify-written with
    the diagonal tile masked, then row + column."""
    n = pos_hi.shape[1]
    z = torch.zeros
    col = TwoFloat(z(3, n), z(3, n))
    row = TwoFloat(z(n, 3), z(n, 3))
    for i in range(n // t):
        i0 = i * t
        ri = slice(i0, i0 + t)
        mu_r = TwoFloat(mu_hi[0, ri][:, None], mu_lo[0, ri][:, None])
        acc = [TwoFloat(z(t, 1), z(t, 1)) for _ in range(3)]
        for j in range(i, n // t):
            cj = slice(j * t, j * t + t)
            sm = (torch.arange(t)[:, None] + i0) == (torch.arange(t)[None, :] + j * t)
            d = [eft.sub(TwoFloat(pos_hi[c, cj][None, :], pos_lo[c, cj][None, :]),
                         TwoFloat(pos_hi[c, ri][:, None], pos_lo[c, ri][:, None])) for c in range(3)]
            ds = [eft.split(x.hi) for x in d]
            r2 = eft.add(eft.add(_sqr_presplit(d[0], ds[0]), _sqr_presplit(d[1], ds[1])),
                         _sqr_presplit(d[2], ds[2]))
            r2 = eft.where(sm, TwoFloat(torch.ones_like(r2.hi), torch.zeros_like(r2.hi)), r2)
            u = _rsqrt_df(r2)
            u2 = eft.sqr(u)
            u2 = eft.where(sm, TwoFloat(torch.zeros_like(u2.hi), torch.zeros_like(u2.hi)), u2)
            u2s = eft.split(u2.hi)
            mu_c = TwoFloat(mu_hi[0, cj][None, :], mu_lo[0, cj][None, :])
            wr = eft.mul(eft.mul_presplit(u2, u2s, mu_c, eft.split(mu_c.hi)), u)
            wc = eft.mul(eft.mul_presplit(u2, u2s, mu_r, eft.split(mu_r.hi)), u)
            wrs, wcs = eft.split(wr.hi), eft.split(wc.hi)
            acc = [eft.add_sloppy(acc[c], _dd_tree_sum(eft.mul_presplit(wr, wrs, d[c], ds[c]), 1))
                   for c in range(3)]
            cmask = torch.tensor(float(j > i))
            for c in range(3):
                s = _dd_tree_sum(eft.mul_presplit(wc, wcs, d[c], ds[c]), 0)
                cur = TwoFloat(col.hi[c, cj][None, :], col.lo[c, cj][None, :])
                new = eft.add_sloppy(cur, TwoFloat(-s.hi * cmask, -s.lo * cmask))
                col.hi[c, cj], col.lo[c, cj] = new.hi[0], new.lo[0]
        for c in range(3):
            row.hi[ri, c], row.lo[ri, c] = acc[c].hi[:, 0], acc[c].lo[:, 0]
    out = eft.add_sloppy(row, TwoFloat(col.hi.t(), col.lo.t()))
    return out.hi, out.lo


@pytest.mark.parametrize("n, tile", [(64, 8), (96, 32)])
def test_sym_plain_is_the_reference_grid_loop(n, tile):
    """The plain version's slots and fold sum in the reference kernel's
    grid order: bitwise to an eager replay of that grid loop."""
    args = _split(*_cloud(n, seed=7))
    got = cuda_sym.pairwise_accel_df64_sym_plain(*args, tile=tile)
    ref = _grid_loop(*args, tile)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
