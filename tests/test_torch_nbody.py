"""The port's pair forces against the JAX package's.

Native f64 (``ops.nbody``) and kernel 1's plain version
(``ops.cuda_nbody.pairwise_accel_df64_plain``) against the reference f64
force and its Pallas two-float kernel, run in interpret mode as the JAX
package's own tests run it.  Inputs come from numpy with a seed.

The kernel-against-plain cases on the card are in ``test_torch_cuda.py``,
which imports no JAX so that it runs on a GPU machine without it.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops import pallas_nbody as jpallas
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.ops import cuda_nbody, nbody

REPO = Path(__file__).resolve().parent.parent


def _cloud(n, seed, scale=1e8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * scale, rng.uniform(1e3, 1e11, size=n)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _fss():
    st = scene.load_scene(REPO / "systems" / "full_solar_system_2433282.5").state
    return st.positions(), st.mus()


def _df64_port_and_jax(pos, mu, tile_rows, tile_cols):
    mh, ml = jpallas.split_f64(jnp.asarray(mu).reshape(1, -1))
    ref_k = np.asarray(jpallas.pairwise_accel(
        jnp.asarray(pos), mh, ml, interpret=True, tile_rows=tile_rows, tile_cols=tile_cols))
    tmh, tml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    np.testing.assert_array_equal(tmh.numpy(), np.asarray(mh))
    np.testing.assert_array_equal(tml.numpy(), np.asarray(ml))
    before = cuda_nbody.pairwise_accel_df64.launches
    port = cuda_nbody.pairwise_accel(torch.tensor(pos), tmh, tml).numpy()
    assert cuda_nbody.pairwise_accel_df64.launches == before  # CPU: plain version
    return port, ref_k, np.asarray(jnbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))


@pytest.mark.parametrize("n, seed", [(64, 0), (100, 1)])
def test_f64_pairwise_accel_matches_jax(n, seed):
    """Native f64 force: <= 1e-15 of max |a| (both sides IEEE f64; only the
    summation order may differ)."""
    pos, mu = _cloud(n, seed)
    ref = jnbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu))
    out = nbody.pairwise_accel(torch.tensor(pos), torch.tensor(mu))
    assert _rel(out, ref) <= 1e-15


def test_f64_helpers_match_jax():
    """accel_at, the row-tiled force and the energy, each <= 1e-15 relative."""
    pos, mu = _cloud(32, 2)
    at = np.random.default_rng(3).normal(size=(5, 3)) * 1e8
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    assert _rel(nbody.accel_at(tp, tm, torch.tensor(at)),
                jnbody.accel_at(jnp.asarray(pos), jnp.asarray(mu), jnp.asarray(at))) <= 1e-15
    assert _rel(nbody.pairwise_accel_tiled(tp, tm, tile=8),
                jnbody.pairwise_accel_tiled(jnp.asarray(pos), jnp.asarray(mu), tile=8)) <= 1e-15
    vel = np.random.default_rng(4).normal(size=(32, 3))
    e_t = float(nbody.energy(tp, torch.tensor(vel), tm))
    e_j = float(jnbody.energy(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mu)))
    assert abs(e_t - e_j) <= 1e-15 * abs(e_j)


def test_kernel1_plain_matches_pallas_cloud():
    """Kernel 1's plain version against the Pallas two-float kernel at n=256:
    <= 1e-13 of max |a| (same pair chain; the sums run in other orders and
    the f32 rsqrt seeds may differ by an ulp before the Newton step), and
    <= 1e-12 against native f64 (test_pallas_accel_matches_f64's bar)."""
    pos, mu = _cloud(256, 3)
    port, ref_k, ref64 = _df64_port_and_jax(pos, mu, tile_rows=64, tile_cols=128)
    assert _rel(port, ref_k) <= 1e-13
    assert _rel(port, ref64) <= 1e-12


def test_kernel1_plain_matches_pallas_solar_system():
    """The same on the full_solar_system geometry (close moons, distant Pluto):
    <= 1e-13 of max |a| against the Pallas kernel.  Against native f64 the
    bar is 1e-11: the two-float positions round at 2^-48 of the heliocentric
    radius, ~1e-10 of the Phobos-Mars separation, and the Pallas kernel
    itself is 5.2e-12 off f64 here."""
    pos, mu = _fss()
    port, ref_k, ref64 = _df64_port_and_jax(pos, mu, tile_rows=32, tile_cols=32)
    assert _rel(port, ref_k) <= 1e-13
    assert _rel(port, ref64) <= 1e-11
    assert _rel(ref_k, ref64) > 1e-12  # the limit is the format's, not the port's


def test_kernel1_plain_ragged_and_split_exact():
    """Any N (no power-of-two tiles): n=37 within 1e-12 of f64; split_f64 is
    exact and combine_f64 inverts it."""
    pos, mu = _cloud(37, 5)
    x = torch.tensor(pos)
    hi, lo = cuda_nbody.split_f64(x, transpose=True)
    assert hi.shape == (3, 37) and hi.dtype == torch.float32
    assert torch.equal(hi, x.t().to(torch.float32))
    back = cuda_nbody.combine_f64(hi, lo, transpose=True)
    assert ((back - x).abs() <= 2.0**-48 * x.abs()).all()
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    out = cuda_nbody.pairwise_accel(x, mh, ml)
    assert _rel(out, nbody.pairwise_accel(x, torch.tensor(mu))) <= 1e-12


def test_kernel1_wrapper_rejects_bad_input():
    """On CUDA tensors the wrapper validates before any launch; on CPU it
    takes the plain version, and an unsupported device raises."""
    pos, mu = _cloud(8, 6)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    with pytest.raises(ValueError):
        cuda_nbody.pairwise_accel_df64(ph.to("meta"), pl.to("meta"), mh.to("meta"), ml.to("meta"))


# -- the error-free transforms under both kernels' plain versions -------------

def _f32_pairs(seed, n=257):
    rng = np.random.default_rng(seed)
    # magnitudes whose products stay f32-normal: XLA:CPU flushes subnormals
    x = rng.normal(size=n) * 10.0 ** rng.uniform(-8, 8, size=n)
    y = rng.normal(size=n) * 10.0 ** rng.uniform(-8, 8, size=n)
    pair = lambda v: (v.astype(np.float32), (v - v.astype(np.float32)).astype(np.float32))  # noqa: E731
    return pair(x), pair(y)


_EFT_OPS = ["two_sum", "quick_two_sum", "split", "two_prod", "two_sqr", "add", "add_sloppy",
            "add_float", "sub", "mul", "mul_float", "sqr", "mul_presplit", "where"]


@pytest.mark.parametrize("op", _EFT_OPS)
def test_eft_op_matches_jax_bitwise(op):
    """Each f32 error-free transform / two-float op equals the JAX package's
    (run eagerly, one rounding per op): bitwise."""
    from ephemeris_explorer_tpu.ops import eft as jeft
    from ephemeris_explorer_tpu_torch.ops import eft as teft

    (xh, xl), (yh, yl) = _f32_pairs(_EFT_OPS.index(op))
    if op in ("quick_two_sum",):  # precondition |a| >= |b|
        big = np.abs(xh) >= np.abs(yh)
        xh, yh = np.where(big, xh, yh), np.where(big, yh, xh)
    J = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    T = lambda *a: [torch.from_numpy(v) for v in a]  # noqa: E731
    cond = xh > yh
    if op in ("two_sum", "quick_two_sum", "two_prod"):
        args = (xh, yh)
        out_j, out_t = getattr(jeft, op)(*J(*args)), getattr(teft, op)(*T(*args))
    elif op in ("split", "two_sqr"):
        out_j, out_t = getattr(jeft, op)(*J(xh)), getattr(teft, op)(*T(xh))
    elif op in ("add_float", "mul_float"):
        out_j = getattr(jeft, op)(jeft.TwoFloat(*J(xh, xl)), *J(yh))
        out_t = getattr(teft, op)(teft.TwoFloat(*T(xh, xl)), *T(yh))
    elif op == "sqr":
        out_j, out_t = jeft.sqr(jeft.TwoFloat(*J(xh, xl))), teft.sqr(teft.TwoFloat(*T(xh, xl)))
    elif op == "mul_presplit":
        xj, yj = jeft.TwoFloat(*J(xh, xl)), jeft.TwoFloat(*J(yh, yl))
        xt, yt = teft.TwoFloat(*T(xh, xl)), teft.TwoFloat(*T(yh, yl))
        out_j = jeft.mul_presplit(xj, jeft.split(xj.hi), yj, jeft.split(yj.hi))
        out_t = teft.mul_presplit(xt, teft.split(xt.hi), yt, teft.split(yt.hi))
    elif op == "where":
        out_j = jeft.where(jnp.asarray(cond), jeft.TwoFloat(*J(xh, xl)), jeft.TwoFloat(*J(yh, yl)))
        out_t = teft.where(torch.from_numpy(cond), teft.TwoFloat(*T(xh, xl)),
                           teft.TwoFloat(*T(yh, yl)))
    else:
        out_j = getattr(jeft, op)(jeft.TwoFloat(*J(xh, xl)), jeft.TwoFloat(*J(yh, yl)))
        out_t = getattr(teft, op)(teft.TwoFloat(*T(xh, xl)), teft.TwoFloat(*T(yh, yl)))
    for a, b in zip(out_t, out_j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
