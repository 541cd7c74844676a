"""Kernels 1-11 against their plain PyTorch versions on an NVIDIA GPU.

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
from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_elm2q, cuda_f32, cuda_gen, cuda_limbs
from ephemeris_explorer_tpu_torch.ops import cuda_mixed, cuda_nbody, cuda_split, cuda_sym, split
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
    cpu = eph.generate_ephemeris(sc.state, sc.settings, span, precision="extended3",
                                 device="cpu")
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


# -- the force-mode ladder (kernels 5-8) --------------------------------------

F32_VS_PLAIN = 1e-6       # kernels 5-7, of max |a|: f32 sums in another order
STRONG_VS_PLAIN = 1e-14   # kernel 8, of max |c|: same tree, rsqrt seeds may differ


def _hierarchy(n=16, seed=7):
    """tests/test_pallas_nbody.py:_hierarchy (a sun, planets with close moon
    pairs, light far bodies)."""
    rng = np.random.default_rng(seed)
    au = 1.5e11
    pos, mu = [np.zeros(3)], [1.33e20]
    for i in range(3):
        pp = rng.normal(size=3)
        pp = pp / np.linalg.norm(pp) * au * (0.7 + i)
        pos.append(pp)
        mu.append(3e14 * (i + 1))
        for m in range(2):
            off = rng.normal(size=3)
            off = off / np.linalg.norm(off) * 4e8 * (1 + 0.002 * m)
            pos.append(pp + off)
            mu.append(5e12)
    while len(pos) < n:
        pos.append(rng.normal(size=3) * au * 2)
        mu.append(1e10)
    return np.array(pos), np.array(mu)


def _f32_inputs(pos, mu, dev):
    return (torch.tensor(pos, device=dev).float(),
            torch.tensor(mu, device=dev).float().reshape(1, -1))


def _rel_rows(a, ref):
    return ((a - ref).norm(dim=1) / ref.norm(dim=1)).max().item()


@pytest.mark.parametrize("n", [1, 32, 1000, 4096])
def test_kernel5_matches_plain_on_card(cuda_device, n):
    """Kernel 5 against its plain version: <= 1e-6 of max |a|; one launch."""
    p32, m32 = _f32_inputs(*_cloud(n, 11), cuda_device)
    before = cuda_f32.pairwise_accel_f32.launches
    k = cuda_f32.pairwise_accel_f32(p32, m32)
    assert cuda_f32.pairwise_accel_f32.launches == before + 1
    r = cuda_f32.pairwise_accel_f32_plain(p32, m32)
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()


@pytest.mark.parametrize("n", [1, 32, 1000, 4096])
def test_kernel6_matches_plain_on_card(cuda_device, n):
    """Kernel 6 against its plain version: <= 1e-6 of max |a|; one launch."""
    pos, mu = _cloud(n, 12)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    m32 = torch.tensor(mu, device=cuda_device).float().reshape(1, -1)
    before = cuda_mixed.pairwise_accel_mixed.launches
    k = cuda_mixed.pairwise_accel_mixed(ph, pl, m32)
    assert cuda_mixed.pairwise_accel_mixed.launches == before + 1
    r = cuda_mixed.pairwise_accel_mixed_plain(ph, pl, m32)
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()


@pytest.mark.parametrize("n", [32, 1000, 4096])
def test_kernel7_matches_plain_on_card(cuda_device, n):
    """Kernel 7 in both modes against its plain version (<= 1e-6 of max |a|),
    and its rows form bitwise against the square form's row slices (ragged
    row blocks included)."""
    pos, mu = _cloud(n, 13)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=16)
    mask = split.strong_pair_mask(idx, n)
    p32, m32 = _f32_inputs(pos, mu, cuda_device)
    no_diag = mask.clone()
    no_diag.fill_diagonal_(0)
    for m, diag in ((no_diag, False), (mask, True)):
        before = cuda_f32.pairwise_accel_f32_masked.launches
        k = cuda_f32.pairwise_accel_f32_masked(p32, m32, m, diag_in_mask=diag)
        assert cuda_f32.pairwise_accel_f32_masked.launches == before + 1
        r = cuda_f32.pairwise_accel_f32_masked_plain(p32, m32, m, diag_in_mask=diag)
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()
    for r0, nl in ((0, n // 2), (n // 4, 100), (n - 7, 7)):
        rows = cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask[r0:r0 + nl].contiguous(),
                                                       p32[r0:r0 + nl].contiguous())
        assert torch.equal(rows, k[r0:r0 + nl])


@pytest.mark.parametrize("n, k", [(16, 6), (32, 16), (1000, 16), (4096, 16), (64, 40)])
def test_kernel8_matches_plain_on_card(cuda_device, n, k):
    """Kernel 8 against its plain version: <= 1e-14 of max |c| (K = 6 pads
    to KP = 8 in front; K = 40 runs the instance with the stack in local
    memory); the rows form bitwise against the square form's row slices."""
    pos, mu = _hierarchy() if n == 16 else _cloud(n, 14)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=k)
    ph, pl = cuda_nbody.split_f64(tp)
    mh, ml = cuda_nbody.split_f64(tm)
    before = cuda_split.strong_correction_pair.launches
    kh, kl = cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, idx)
    assert cuda_split.strong_correction_pair.launches == before + 1
    rh, rl = cuda_split.strong_correction_pair_plain(ph, pl, ph, pl, mh, ml, idx)
    kc, rc = cuda_nbody.combine_f64(kh, kl), cuda_nbody.combine_f64(rh, rl)
    assert (kc - rc).abs().max() <= STRONG_VS_PLAIN * rc.abs().max()
    sq = cuda_split._strong_correction_fast(tp, tm, idx)
    for r0 in (0, n // 3):
        nl = n - r0
        rows = cuda_split._strong_correction_fast(tp, tm, idx[r0:].contiguous(), rows=tp[r0:])
        assert rows.shape == (nl, 3) and torch.equal(rows, sq[r0:])


def test_kernel8_out_of_range_index_gives_nan(cuda_device):
    """An index outside [0, N) is not read: its receiver's correction is NaN,
    every other receiver's is the in-range result bitwise."""
    pos, mu = _cloud(64, 15)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=8)
    ph, pl = cuda_nbody.split_f64(tp)
    mh, ml = cuda_nbody.split_f64(tm)
    good = cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, idx)
    bad_idx = idx.clone()
    bad_idx[3, 5] = 64
    bad_idx[40, 0] = -1
    bad = cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, bad_idx)
    for g, b in zip(good, bad):
        assert b[[3, 40]].isnan().all()
        keep = torch.ones(64, dtype=torch.bool, device=cuda_device)
        keep[[3, 40]] = False
        assert torch.equal(b[keep], g[keep])


def test_forcemode_reference_bars_on_card(cuda_device):
    """The reference's bars for the modes, through the kernels: mixed < 3e-6
    per body on the close pair; split < 2e-9 on the hierarchy (K = 6) and
    < 4e-7 on the 64-body cloud (K = 8); all-strong K = N - 1 < 1e-14 (f64
    correction) and < 1e-12 (two-float); two-float correction < 5e-12 of the
    f64 one on the hierarchy."""
    from ephemeris_explorer_tpu_torch.ops import nbody

    dev = cuda_device
    rng = np.random.default_rng(29)
    pos = rng.normal(size=(16, 3)) * 1.0e6
    pos[1] = pos[0] + np.array([40.1234567, 19.7654321, -9.87654321])
    mu = rng.uniform(1.0e3, 1.0e5, size=16)
    mu[0] = 1.0e7
    tp, tm = torch.tensor(pos, device=dev), torch.tensor(mu, device=dev)
    mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
    ref = cuda_nbody.pairwise_accel(tp, mh, ml)
    ph, pl = cuda_nbody.split_f64(tp, transpose=True)
    mixed = cuda_mixed.pairwise_accel_mixed(ph, pl, tm.float().reshape(1, -1)).double()
    assert _rel_rows(mixed, ref) < 3e-6

    def split_err(pos, mu, k, **kw):
        tp, tm = torch.tensor(pos, device=dev), torch.tensor(mu, device=dev)
        idx = split.strong_pair_indices(tp, tm, k=k)
        a = cuda_split.pairwise_accel_split(tp, tm, idx, split.strong_pair_mask(idx, len(pos)),
                                            **kw)
        return _rel_rows(a, nbody.pairwise_accel(tp, tm))

    rng = np.random.default_rng(11)
    cloud = rng.normal(size=(64, 3)) * 1e6, rng.uniform(1e3, 1e5, size=64)
    rng = np.random.default_rng(3)
    small = rng.normal(size=(16, 3)) * 1e6, rng.uniform(1e3, 1e5, size=16)
    assert split_err(*_hierarchy(), 6) < 2e-9
    assert split_err(*cloud, 8) < 4e-7
    assert split_err(*small, 15, corr="f64") < 1e-14
    assert split_err(*small, 15) < 1e-12
    tp, tm = (torch.tensor(x, device=dev) for x in _hierarchy())
    idx = split.strong_pair_indices(tp, tm, k=6)
    fast = cuda_split._strong_correction_fast(tp, tm, idx)
    assert _rel_rows(fast, split._strong_correction(tp, tm, idx)) < 5e-12


def test_forcemode_wrappers_check_inputs(cuda_device):
    """Wrong dtype, shape or layout raises before any launch."""
    p32, m32 = _f32_inputs(*_cloud(16, 8), cuda_device)
    mask = torch.zeros((16, 16), dtype=torch.int8, device=cuda_device)
    idx = torch.zeros((16, 2), dtype=torch.int32, device=cuda_device)
    mh = m32.reshape(-1).contiguous()
    counters = (cuda_f32.pairwise_accel_f32, cuda_f32.pairwise_accel_f32_masked,
                cuda_mixed.pairwise_accel_mixed, cuda_split.strong_correction_pair)
    before = [f.launches for f in counters]
    with pytest.raises(TypeError):
        cuda_f32.pairwise_accel_f32(p32.double(), m32)
    with pytest.raises(ValueError):
        cuda_f32.pairwise_accel_f32(p32.t().contiguous().t(), m32)
    with pytest.raises(TypeError):
        cuda_f32.pairwise_accel_f32_masked(p32, m32, mask.bool())
    with pytest.raises(ValueError):
        cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask[:8], p32[:4].contiguous())
    with pytest.raises(ValueError):
        cuda_mixed.pairwise_accel_mixed(p32, p32, m32)
    with pytest.raises(TypeError):
        cuda_split.strong_correction_pair(p32, p32, p32, p32, mh, mh, idx.long())
    with pytest.raises(ValueError):
        cuda_split.strong_correction_pair(p32, p32, p32[:8], p32, mh, mh, idx)
    assert [f.launches for f in counters] == before


# -- kernel 1's ensemble and rows forms, kernel 3's rows form, kernel 9 --------


@pytest.mark.parametrize("e, n", [(2, 32), (3, 1000), (16, 4096)])
def test_kernel1_ensemble_on_card(cuda_device, e, n):
    """Kernel 1's ensemble form: each member equals the square kernel on
    that member bitwise (one launch for all members), and is within 1e-13
    of max |a| of the plain version."""
    rng = np.random.default_rng(21)
    pos = torch.tensor(rng.normal(size=(e, n, 3)) * 1e6, device=cuda_device)
    mu = torch.tensor(rng.uniform(1e3, 1e5, size=n), device=cuda_device)
    ph, pl = cuda_nbody.split_f64(pos.transpose(1, 2))
    mh, ml = cuda_nbody.split_f64(mu.reshape(1, -1))
    before = cuda_nbody.pairwise_accel_df64_ensemble.launches
    kh, kl = cuda_nbody.pairwise_accel_df64_ensemble(ph, pl, mh, ml)
    assert cuda_nbody.pairwise_accel_df64_ensemble.launches == before + 1
    for m in range(e):
        sh_, sl = cuda_nbody.pairwise_accel_df64(ph[m].contiguous(), pl[m].contiguous(), mh, ml)
        assert torch.equal(kh[m], sh_) and torch.equal(kl[m], sl)
    for m in (0, e - 1):
        r = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64_plain(ph[m], pl[m], mh, ml))
        k = cuda_nbody.combine_f64(kh[m], kl[m])
        assert (k - r).abs().max() <= 1e-13 * r.abs().max()


@pytest.mark.parametrize("n", [32, 1000, 4096])
def test_kernel1_and_kernel3_rows_on_card(cuda_device, n):
    """The rows forms of kernels 1 and 3 at row0 = 0, N/4 and a ragged
    offset equal the square forms' row slices bitwise."""
    pos, mu = _cloud(n, 22)
    tp = torch.tensor(pos, device=cuda_device)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    ph, pl = cuda_nbody.split_f64(tp, transpose=True)
    sq1 = cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)
    limbs = ex.from_f64_host(pos, cuda_device)[:3]
    sq3 = cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)
    src3 = [l.t().contiguous() for l in limbs]
    for r0, nl in ((0, n // 2), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1)):
        rh, rl = cuda_nbody.split_f64(tp[r0:r0 + nl])
        b1 = cuda_nbody.pairwise_accel_df64_rows.launches
        got1 = cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml, rh, rl, r0)
        assert cuda_nbody.pairwise_accel_df64_rows.launches == b1 + 1
        b3 = cuda_limbs.pairwise_accel_limbs_pair_rows.launches
        got3 = cuda_limbs.pairwise_accel_limbs_pair_rows(
            *src3, mh, ml, *(l[r0:r0 + nl].contiguous() for l in limbs), r0)
        assert cuda_limbs.pairwise_accel_limbs_pair_rows.launches == b3 + 1
        for g, s in list(zip(got1, sq1)) + list(zip(got3, sq3)):
            assert torch.equal(g, s[r0:r0 + nl])


@pytest.mark.parametrize("n, k", [(16, 6), (32, 16), (1000, 16), (4096, 16), (64, 40)])
def test_kernel9_matches_plain_on_card(cuda_device, n, k):
    """Kernel 9 against its plain version: bitwise, as kernel 8 (same feed
    arithmetic, same chain and tree); within 3e-13 per body of the f64
    correction on the hierarchy."""
    pos, mu = _hierarchy() if n == 16 else _cloud(n, 14)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=k)
    before = cuda_split.strong_correction_dd.launches
    kh, kl = cuda_split.strong_correction_dd(tp, tm, idx)
    assert cuda_split.strong_correction_dd.launches == before + 1
    rh, rl = cuda_split.strong_correction_dd_plain(tp, tm, idx)
    kc, rc = cuda_nbody.combine_f64(kh, kl), cuda_nbody.combine_f64(rh, rl)
    assert (kc - rc).abs().max() <= STRONG_VS_PLAIN * rc.abs().max()
    if n == 16:
        assert _rel_rows(kc, split._strong_correction(tp, tm, idx)) < 3e-13


def test_kernel9_out_of_range_index_gives_nan(cuda_device):
    """Kernel 8's rule: an index outside [0, N) gives NaN for its receiver
    and leaves every other receiver bitwise."""
    pos, mu = _cloud(64, 15)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=8)
    good = cuda_split.strong_correction_dd(tp, tm, idx)
    bad_idx = idx.clone()
    bad_idx[3, 5] = 64
    bad_idx[40, 0] = -1
    bad = cuda_split.strong_correction_dd(tp, tm, bad_idx)
    keep = torch.ones(64, dtype=torch.bool, device=cuda_device)
    keep[[3, 40]] = False
    for g, b in zip(good, bad):
        assert b[[3, 40]].isnan().all() and torch.equal(b[keep], g[keep])


def test_one_rank_nccl_mesh_on_card(cuda_device, tmp_path):
    """A one-rank NCCL group: make_mesh() defaults to the card, and the
    row-sharded fused scan equals the unsharded one bitwise."""
    import torch.distributed as dist

    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = sh.make_mesh(1, 1)
        assert mesh.device_type == "cuda"
        pos, mu = _cloud(256, 23)
        tm = torch.tensor(mu, device=cuda_device)
        tab = get(QT12)
        c0 = ms.elm2_f_from(ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, tm), 0.0,
                                         torch.tensor(pos, device=cuda_device),
                                         torch.zeros((256, 3), dtype=torch.float64,
                                                     device=cuda_device), 600.0))
        run, _ = sh.make_rowsharded_scan_f(mesh, tab, mu, 600.0, 5)
        out = run(c0)
        mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
        ref = c0
        for _ in range(5):
            ref = ms.elm2_step_f(tab, lambda t, y: TwoFloat(*cuda_nbody.pairwise_accel_df64(
                y.hi.t().contiguous(), y.lo.t().contiguous(), mh, ml)), 600.0, ref)
        assert torch.equal(out.ys.hi, ref.ys.hi) and torch.equal(out.ys.lo, ref.ys.lo)
    finally:
        dist.destroy_process_group()


# -- kernels 2' and 4' (packed entry points), 10 (symmetric) and 11 (generation) --


@pytest.mark.parametrize("n", [32, 4096])
def test_packed_updates_on_card(cuda_device, n):
    """Kernels 2' and 4' (both modes) on packed (12, 8, 3N/8) rings: bitwise
    to their plain versions and to the unpacked entry points; each counts
    its own launch."""
    rng = np.random.default_rng(24)
    y = torch.tensor(rng.normal(size=(12, 8, 3 * n // 8)) * 1e8, device=cuda_device)
    a = torch.tensor(rng.normal(size=(12, 8, 3 * n // 8)) * 1e-6, device=cuda_device)
    ys, dd = TwoFloat(*cuda_nbody.split_f64(y)), TwoFloat(*cuda_nbody.split_f64(a))
    tab = get(QT12)
    b2, b2u = cuda_elm2.elm2f_update_packed.launches, cuda_elm2.elm2f_update.launches
    k = cuda_elm2.elm2f_update_packed(tab, 600.0, ys, dd)
    assert cuda_elm2.elm2f_update_packed.launches == b2 + 1
    assert cuda_elm2.elm2f_update.launches == b2u
    p = cuda_elm2.elm2f_update_plain(*cuda_elm2._tables(tab, 600.0), ys, dd)
    u = cuda_elm2.elm2f_update(tab, 600.0, TwoFloat(*(x.reshape(12, -1) for x in ys)),
                               TwoFloat(*(x.reshape(12, -1) for x in dd)))
    assert torch.equal(k.hi, p.hi) and torch.equal(k.lo, p.lo)
    assert torch.equal(k.hi, u.hi.reshape(8, -1)) and torch.equal(k.lo, u.lo.reshape(8, -1))
    limbs = tuple(l.reshape(12, 8, -1) for l in ex.from_f64_host(y.cpu().numpy(), cuda_device))
    for precise in (False, True):
        b4 = cuda_elm2q.elm2q_update_packed.launches
        k4 = cuda_elm2q.elm2q_update_packed(tab, 600.0, limbs, dd, precise=precise)
        assert cuda_elm2q.elm2q_update_packed.launches == b4 + 1
        p4 = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(tab, 600.0, precise), limbs, dd,
                                           precise)
        assert all(torch.equal(x, z) for x, z in zip(k4, p4))


@pytest.mark.parametrize("n", [32, 96, 1024, 4096])
def test_kernel10_matches_plain_on_card(cuda_device, n):
    """Kernel 10 against its plain version bitwise (same ops, same order), and
    against kernel 1 within 2^-44 of max |a| (the reference's bar)."""
    pos, mu = _cloud(n, 25)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_sym.pairwise_accel_df64_sym.launches
    kh, kl = cuda_sym.pairwise_accel_df64_sym(ph, pl, mh, ml)
    assert cuda_sym.pairwise_accel_df64_sym.launches == before + 1
    rh, rl = cuda_sym.pairwise_accel_df64_sym_plain(ph, pl, mh, ml)
    assert torch.equal(kh, rh) and torch.equal(kl, rl)
    k1 = cuda_nbody.combine_f64(*cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml))
    assert (cuda_nbody.combine_f64(kh, kl) - k1).abs().max() <= 2.0**-44 * k1.abs().max()


def test_kernel10_rejects_non_multiple_n(cuda_device):
    pos, mu = _cloud(48, 26)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu, device=cuda_device).reshape(1, -1))
    before = cuda_sym.pairwise_accel_df64_sym.launches
    with pytest.raises(ValueError, match="multiple of its tile"):
        cuda_sym.pairwise_accel_df64_sym(ph, pl, mh, ml)
    assert cuda_sym.pairwise_accel_df64_sym.launches == before


@pytest.mark.parametrize("n", [3, 10, 32, 64, 200])
def test_kernel11_matches_plain_on_card(cuda_device, n):
    """Kernel 11 over 16 steps against its plain version: bitwise
    (emissions and rings), one launch; n = 3, 10, 200 exercise the ghost
    padding, 64 and 200 the in-lane levels of the tree."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    pos, mu = _cloud(n, 27)
    tm = torch.tensor(mu, device=cuda_device)
    c0 = ms.elm2_init(get(QT12), lambda t, y: nbody.pairwise_accel(y, tm), 0.0,
                      torch.tensor(pos, device=cuda_device),
                      torch.zeros((n, 3), dtype=torch.float64, device=cuda_device), 600.0)
    mu_pair = TwoFloat(*cuda_nbody.split_f64(tm.reshape(1, -1)))
    before = cuda_gen.elm2_gen_scan.launches
    ys, c = cuda_gen.elm2_gen_scan(get(QT12), 600.0, c0, mu_pair, 16)
    assert cuda_gen.elm2_gen_scan.launches == before + 1
    ysp, cp = cuda_gen.elm2_gen_scan_plain(get(QT12), 600.0, c0, mu_pair, 16)
    assert torch.equal(ys, ysp) and torch.equal(c.ys, cp.ys) and torch.equal(c.ddys, cp.ddys)
    assert torch.equal(ys[-1], c.ys[0])
