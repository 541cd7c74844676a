"""Kernels 1-4 against their plain PyTorch versions on an NVIDIA GPU.

Every test here needs the card: it is marked ``cuda`` and skips (inside a
fixture) when ``torch.cuda.is_available()`` is false.  The file imports no
JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu_torch import ephemeris as eph
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_elm2q, cuda_limbs, cuda_nbody
from ephemeris_explorer_tpu_torch.ops import expansion as ex
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat

pytestmark = pytest.mark.cuda
QT12 = "QuinlanTremaine12"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1e6, rng.uniform(1e3, 1e5, size=n)


@pytest.mark.parametrize("n", [1, 32, 1000, 4096])
def test_kernel1_matches_plain_on_card(cuda_device, n):
    """Kernel 1 against its plain version: <= 1e-13 of max |a| (the sums run
    in other orders); one launch per call; n=1 has no pair and gives 0."""
    pos, mu = _cloud(n, 7)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_nbody.pairwise_accel_df64.launches
    k = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)).cpu()
    assert cuda_nbody.pairwise_accel_df64.launches == before + 1
    r = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64_plain(ph, pl, mh, ml)).cpu()
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= 1e-13 * r.abs().max()


def test_kernel1_wrapper_checks_inputs(cuda_device):
    """Wrong dtype, shape or layout raises before any launch."""
    pos, mu = _cloud(16, 8)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_nbody.pairwise_accel_df64.launches
    with pytest.raises(TypeError):
        cuda_nbody.pairwise_accel_df64(ph.double(), pl, mh, ml)
    with pytest.raises(ValueError):
        cuda_nbody.pairwise_accel_df64(ph, pl, mh[:, :8], ml)
    with pytest.raises(ValueError):
        cuda_nbody.pairwise_accel_df64(ph.t().contiguous().t(), pl, mh, ml)
    assert cuda_nbody.pairwise_accel_df64.launches == before


@pytest.mark.parametrize("n", [8, 4096])
def test_kernel2_matches_plain_on_card(cuda_device, n):
    """Kernel 2 against its plain version: bitwise (same ops, same order)."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(12, n, 3)) * 1e8
    a = rng.normal(size=(12, n, 3)) * 1e-6
    ys = TwoFloat(*cuda_nbody.split_f64(torch.tensor(y, device=cuda_device)))
    dd = TwoFloat(*cuda_nbody.split_f64(torch.tensor(a, device=cuda_device)))
    before = cuda_elm2.elm2f_update.launches
    k = cuda_elm2.elm2f_update(get(QT12), 600.0, ys, dd)
    assert cuda_elm2.elm2f_update.launches == before + 1
    coef, c_y = cuda_elm2._tables(get(QT12), 600.0)
    p = cuda_elm2.elm2f_update_plain(coef, c_y, ys, dd)
    assert torch.equal(k.hi, p.hi) and torch.equal(k.lo, p.lo)


def test_fused_generation_on_card(cuda_device, monkeypatch):
    """The fused branch (gate forced open, N=32) launches both kernels once
    per step after the startup and stays within 1e-10 of the plain f64
    branch in sample space over 2 days of full_solar_system."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps
    plain = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    monkeypatch.setattr(eph, "_use_fused_f", lambda n, device: True)
    k1, k2 = cuda_nbody.pairwise_accel_df64.launches, cuda_elm2.elm2f_update.launches
    fused = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    assert cuda_nbody.pairwise_accel_df64.launches - k1 == 288 - 12
    assert cuda_elm2.elm2f_update.launches - k2 == 288 - 12
    for n in plain.names:
        a, b = plain[n].coeffs, fused[n].coeffs
        assert a.shape == b.shape
        if a.size:
            norm = np.abs(fit_matrix(sc.settings.settings[n].degree)).sum(1)
            rows = norm > 0
            d = np.abs(a - b).max(axis=(0, 2))[rows] / norm[rows]
            assert d.max() <= 1e-10 * np.abs(a[:, 0]).max(), n


@pytest.mark.parametrize("n", [1, 32, 1000, 4096])
def test_kernel3_matches_plain_on_card(cuda_device, n):
    """Kernel 3 against its plain version: <= 1e-13 of max |a| (the sums run
    in other orders), and <= 1e-12 of native f64 from exact host limbs; one
    launch per call; n=1 has no pair and gives 0."""
    from ephemeris_explorer_tpu_torch.ops import nbody

    pos, mu = _cloud(n, 9)
    limbs = ex.from_f64_host(pos, cuda_device)[:3]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_limbs.pairwise_accel_limbs_pair.launches
    k = cuda_limbs.pairwise_accel_limbs(*limbs, mh, ml).cpu()
    assert cuda_limbs.pairwise_accel_limbs_pair.launches == before + 1
    r = cuda_nbody.combine_f64(*cuda_limbs.pairwise_accel_limbs_pair_plain(*limbs, mh, ml)).cpu()
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= 1e-13 * r.abs().max()
        f64 = nbody.pairwise_accel(torch.tensor(pos), torch.tensor(mu))
        assert (k - f64).abs().max() <= 1e-12 * f64.abs().max()


def test_kernel3_wrapper_checks_inputs(cuda_device):
    """Wrong dtype, shape or layout raises before any launch."""
    pos, mu = _cloud(16, 8)
    l0, l1, l2 = ex.from_f64_host(pos, cuda_device)[:3]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_limbs.pairwise_accel_limbs_pair.launches
    with pytest.raises(TypeError):
        cuda_limbs.pairwise_accel_limbs_pair(l0.double(), l1, l2, mh, ml)
    with pytest.raises(ValueError):
        cuda_limbs.pairwise_accel_limbs_pair(l0, l1, l2[:8], mh, ml)
    with pytest.raises(ValueError):
        cuda_limbs.pairwise_accel_limbs_pair(l0.t().contiguous().t(), l1, l2, mh, ml)
    assert cuda_limbs.pairwise_accel_limbs_pair.launches == before


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n", [8, 4096])
def test_kernel4_matches_plain_on_card(cuda_device, n, precise):
    """Kernel 4 against its plain version in both modes: bitwise (same ops,
    same order); one launch per call."""
    rng = np.random.default_rng(4)
    y = rng.normal(size=(12, n, 3)) * 1e8
    ys = ex.from_f64_host(y, cuda_device)
    ys = ys[:3] + ((ys[2].double() * 2.0**-25).float(),)  # a nonzero fourth limb
    dd = TwoFloat(*cuda_nbody.split_f64(torch.tensor(rng.normal(size=(12, n, 3)) * 1e-6,
                                                     device=cuda_device)))
    tab = get(QT12)
    before = cuda_elm2q.elm2q_update.launches
    k = cuda_elm2q.elm2q_update(tab, 600.0, ys, dd, precise=precise)
    assert cuda_elm2q.elm2q_update.launches == before + 1
    p = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(tab, 600.0, precise), ys, dd, precise)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_extended3_generation_on_card(cuda_device):
    """precision="extended3" on the card: kernel 3 for every force
    evaluation and never kernel 4 (generation runs elm2_step_q); within
    1e-10 in sample space of the same run on the CPU over 2 days of
    full_solar_system, and its integrated positions below 1e-4 km of the
    "extended" run's (same state engine, f64 force; 2.0e-6 km on CPU)."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps
    k3, k4 = cuda_limbs.pairwise_accel_limbs_pair.launches, cuda_elm2q.elm2q_update.launches
    gpu = eph.generate_ephemeris(sc.state, sc.settings, span, precision="extended3",
                                 device=cuda_device)
    assert cuda_limbs.pairwise_accel_limbs_pair.launches - k3 > 288 - 12
    assert cuda_elm2q.elm2q_update.launches == k4
    cpu = eph.generate_ephemeris(sc.state, sc.settings, span, precision="extended3")
    for n in cpu.names:
        a, b = cpu[n].coeffs, gpu[n].coeffs
        assert a.shape == b.shape
        if a.size:
            norm = np.abs(fit_matrix(sc.settings.settings[n].degree)).sum(1)
            rows = norm > 0
            d = np.abs(a - b).max(axis=(0, 2))[rows] / norm[rows]
            assert d.max() <= 1e-10 * np.abs(a[:, 0]).max(), n
    heads = []
    for precision in ("extended3", "extended"):
        prop = eph.NBodyPropagator(sc.state, sc.settings, precision=precision,
                                   device=cuda_device)
        prop.step_chunk(288)
        ys = prop._carry.ms.ys
        heads.append(ex.to_f64(tuple(l[0] for l in ys)))
    assert (heads[0] - heads[1]).abs().max() < 1e-4
