"""Kernel 3 (the 3-limb pair force) against the JAX package's.

The port runs the kernel's plain version (CPU tensors); the JAX side runs
``pairwise_accel_limbs_pair`` in interpret mode, as its own tests do.
Positions start from the exact host limb split (``from_f64_host``), as
generation does.  The kernel-against-plain cases on the card are in
``test_torch_cuda.py``.
"""

from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.ops import expansion as jex
from ephemeris_explorer_tpu.ops import pallas_nbody as jpallas
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.ops import cuda_limbs, cuda_nbody, nbody
from ephemeris_explorer_tpu_torch.ops import expansion as ex

REPO = Path(__file__).resolve().parent.parent


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _fss():
    st = scene.load_scene(REPO / "systems" / "full_solar_system_2433282.5").state
    return st.positions(), st.mus()


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1e6, rng.uniform(1e3, 1e5, size=n)


def _port_and_jax(pos, mu, tile):
    """(port plain version, Pallas interpret, native f64) accelerations."""
    limbs = ex.from_f64_host(pos)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    before = cuda_limbs.pairwise_accel_limbs_pair.launches
    port = cuda_limbs.pairwise_accel_limbs(*limbs[:3], mh, ml).numpy()
    assert cuda_limbs.pairwise_accel_limbs_pair.launches == before  # CPU: plain version
    jmh, jml = jpallas.split_f64(jnp.asarray(mu).reshape(1, -1))
    ref = np.asarray(jpallas.pairwise_accel_limbs(
        *jex.from_f64_host(pos)[:3], jmh, jml, interpret=True, tile_rows=tile, tile_cols=tile))
    f64 = nbody.pairwise_accel(torch.tensor(pos), torch.tensor(mu)).numpy()
    return port, ref, f64


@pytest.mark.parametrize("case", ["cluster64", "full_solar_system"])
def test_kernel3_plain_matches_pallas(case):
    """<= 1e-13 of max |a| against the Pallas kernel (kernel 1's bar: same
    pair chain, sums in other orders, f32 rsqrt seeds that may differ by an
    ulp), and <= 1e-12 against native f64 (test_pallas_accel_matches_f64's
    bar, which kernel 1 misses on full_solar_system at 5.2e-12)."""
    pos, mu = _cloud(64, 3) if case == "cluster64" else _fss()
    port, ref, f64 = _port_and_jax(pos, mu, tile=len(pos))
    assert _rel(port, ref) <= 1e-13
    assert _rel(port, f64) <= 1e-12


def test_kernel3_plain_beats_kernel1_on_solar_system():
    """On full_solar_system the 3-limb difference removes kernel 1's
    position-rounding floor: kernel 3 is within 1e-12 of f64 where kernel 1
    is above it."""
    pos, mu = _fss()
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    f64 = nbody.pairwise_accel(torch.tensor(pos), torch.tensor(mu))
    k3 = cuda_limbs.pairwise_accel_limbs(*ex.from_f64_host(pos)[:3], mh, ml)
    k1 = cuda_nbody.pairwise_accel(torch.tensor(pos), mh, ml)
    assert _rel(k3, f64) <= 1e-12 < _rel(k1, f64)


def test_kernel3_plain_ragged_and_pair_form():
    """Any N (no power-of-two tiles, which the Pallas kernel needs): n=37
    within 1e-12 of f64; the pair form combines to the f64 form."""
    pos, mu = _cloud(37, 5)
    limbs = ex.from_f64_host(pos)[:3]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    hi, lo = cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)
    assert hi.shape == lo.shape == (37, 3) and hi.dtype == torch.float32
    out = cuda_limbs.pairwise_accel_limbs(*limbs, mh, ml)
    assert torch.equal(out, cuda_nbody.combine_f64(hi, lo))
    assert _rel(out, nbody.pairwise_accel(torch.tensor(pos), torch.tensor(mu))) <= 1e-12


def test_three_limb_close_pair_accuracy():
    """A Mars+Phobos-like close pair far from the origin, with a ~3 um
    offset that only the third limb holds: < 1e-11 of the exact rational
    force (test_three_limb_close_pair_accuracy's bar), and better than
    kernel 1's plain version, which cannot see the third limb."""
    n = 8
    pos = np.zeros((n, 3))
    pos[:, 0] = np.linspace(1e8, 4e8, n)
    pos[1] = pos[0] + np.array([9377.0, 1234.5678901, 0.0])
    mu = np.full(n, 1e3)
    mu[0] = 4.28e4
    limbs = list(ex.from_f64(torch.tensor(pos)))
    delta = np.zeros((n, 3))
    delta[1, 1] = 3.1415e-9
    limbs[2] = torch.tensor(limbs[2].numpy().astype(np.float64) + delta, dtype=torch.float32)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    out3 = cuda_limbs.pairwise_accel_limbs(*limbs[:3], mh, ml).numpy()

    def limb_pos(i):
        return [sum(Fraction(float(l[i, k])) for l in limbs[:3]) for k in range(3)]

    def exact_accel(i):
        acc = [Fraction(0)] * 3
        pi = limb_pos(i)
        for j in range(n):
            if j == i:
                continue
            d = [a - b for a, b in zip(limb_pos(j), pi)]
            inv_r3 = Fraction(float(float(sum(x * x for x in d)) ** -1.5))
            for k in range(3):
                acc[k] += Fraction(float(mu[j])) * d[k] * inv_r3
        return np.array([float(a) for a in acc])

    truth = exact_accel(1)
    rel3 = np.abs(out3[1] - truth).max() / np.abs(truth).max()
    assert rel3 < 1e-11, rel3
    out2 = cuda_nbody.pairwise_accel(torch.tensor(pos), mh, ml).numpy()
    rel2 = np.abs(out2[1] - truth).max() / np.abs(truth).max()
    assert rel3 < rel2


def test_kernel3_wrapper_rejects_unsupported_device():
    pos, mu = _cloud(8, 6)
    limbs = [l.to("meta") for l in ex.from_f64_host(pos)[:3]]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    with pytest.raises(ValueError):
        cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh.to("meta"), ml.to("meta"))
