"""Kernels 1-14, 1-f64, 2-f64, 3-f64 and 13-chunk against their plain PyTorch versions on an NVIDIA GPU.

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
from ephemeris_explorer_tpu_torch.ops import cuda_elm2f64, cuda_limbs64, cuda_mixed, cuda_nbody
from ephemeris_explorer_tpu_torch.ops import cuda_elm2qs, cuda_fleet, cuda_genq, cuda_nbody64
from ephemeris_explorer_tpu_torch.ops import cuda_split
from ephemeris_explorer_tpu_torch.ops import cuda_sym, split
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


def _tableau(order: int, seed: int):
    """A synthetic ELM2 tableau of any order the kernel is built for: c_y in
    {0, +-1, +-2} (c_y[0] = 2), integer c_dy with about a quarter zero."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    c_y = rng.choice([0.0, 1.0, -1.0, 2.0, -2.0], size=order)
    c_y[0] = 2.0
    c_dy = rng.integers(-50, 51, size=order).astype(np.float64)
    c_dy[rng.random(order) < 0.25] = 0.0
    c_dy[0] = 7.0
    return SimpleNamespace(name=f"synthetic{order}", c_y=c_y, c_dy=c_dy, beta_d=12.0)


def _shift_same(a, b) -> bool:
    """(y, ys_new, dd_new) of the shift form bitwise, but for dd_new[0]."""
    pairs = [(a[0].hi, b[0].hi), (a[0].lo, b[0].lo), (a[1].hi, b[1].hi), (a[1].lo, b[1].lo),
             (a[2].hi[1:], b[2].hi[1:]), (a[2].lo[1:], b[2].lo[1:])]
    return all(torch.equal(x, z) for x, z in pairs)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [3, 96, 12288, 196608])
def test_kernel2_every_order_on_card(cuda_device, m, packed):
    """Kernel 2's update and shift entries at every order it is built for
    (1..16, synthetic tableaux with zero coefficients), unpacked (ORDER, M)
    and packed (ORDER, 8, M/8): bitwise to their plain versions, the shift
    entry's y to the update entry's, one launch a call on each counter."""
    rng = np.random.default_rng(m)
    for order in range(1, cuda_elm2.MAX_ORDER + 1):
        tab = _tableau(order, order)
        sub = 8 if m % 8 == 0 else 1
        shape = (order, sub, m // sub) if packed else (order, m)
        y = torch.tensor(rng.normal(size=shape) * 1e8, device=cuda_device)
        a = torch.tensor(rng.normal(size=shape) * 1e-6, device=cuda_device)
        ys, dd = TwoFloat(*cuda_nbody.split_f64(y)), TwoFloat(*cuda_nbody.split_f64(a))
        coef, c_y = cuda_elm2._tables(tab, 600.0)
        update = cuda_elm2.elm2f_update_packed if packed else cuda_elm2.elm2f_update
        shift = cuda_elm2.elm2f_update_shift_packed if packed else cuda_elm2.elm2f_update_shift
        b_u, b_s = update.launches, shift.launches
        k = update(tab, 600.0, ys, dd)
        ks = shift(tab, 600.0, ys, dd)
        assert (update.launches, shift.launches) == (b_u + 1, b_s + 1)
        p = cuda_elm2.elm2f_update_plain(coef, c_y, ys, dd)
        assert torch.equal(k.hi, p.hi) and torch.equal(k.lo, p.lo), order
        assert _shift_same(ks, cuda_elm2.elm2f_update_shift_plain(coef, c_y, ys, dd)), order
        assert torch.equal(ks[0].hi, k.hi) and torch.equal(ks[0].lo, k.lo), order


def _step_ops(step, c) -> dict:
    """The aten ops one step dispatches, by name, under a dispatch mode (the
    ctypes kernels do not show; their counters do).  No torch.profiler: a
    window opened here has been seen to leave the later tests' windows
    without the library's kernels."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class AtenOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with AtenOps() as aten:
        step(c)
    torch.cuda.synchronize()
    return aten.ops


def test_f_step_folds_the_ring_shift_on_card(cuda_device):
    """The F step on the card at N = 1024: kernel 2's shift entry and kernel 1
    once a step; no concatenation and, with a force that writes ``out``, no
    copy (kernel 1 writes the new force row), two copies with one that does
    not; ten steps bitwise to the step before the fold (the update entry
    and four concatenations).  The two aten ops that launch a kernel are the
    transposes to kernel 1's (3, N) layout."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    pos, mu = _cloud(1024, 33)
    tm = torch.tensor(mu, device=cuda_device)
    mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
    tab = get(QT12)
    c0 = ms.elm2_f_from(ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, tm), 0.0,
                                     torch.tensor(pos, device=cuda_device),
                                     torch.zeros((1024, 3), dtype=torch.float64,
                                                 device=cuda_device), 600.0))

    def pair(t, y, out=None):
        return TwoFloat(*cuda_nbody.pairwise_accel_df64(
            y.hi.t().contiguous(), y.lo.t().contiguous(), mh, ml, out=out))

    marked = ms.writes_into(lambda t, y, out=None: pair(t, y, out))
    counts = (cuda_nbody.pairwise_accel_df64.launches, cuda_elm2.elm2f_update.launches,
              cuda_elm2.elm2f_update_shift.launches)
    folded = cat = c0
    for _ in range(10):
        folded = ms.elm2_step_f(tab, marked, 600.0, folded)
    after = (cuda_nbody.pairwise_accel_df64.launches, cuda_elm2.elm2f_update.launches,
             cuda_elm2.elm2f_update_shift.launches)
    assert [a - b for a, b in zip(after, counts)] == [10, 0, 10]
    for _ in range(10):
        cat = ms._step_f_cat(tab, pair, 600.0, cat)
    assert folded.t == cat.t
    assert all(torch.equal(a, b) for a, b in zip((*folded.ys, *folded.dd), (*cat.ys, *cat.dd)))
    aten = _step_ops(lambda c: ms.elm2_step_f(tab, marked, 600.0, c), c0)
    assert "aten.cat" not in aten and "aten.copy_" not in aten and aten["aten.clone"] == 2, aten
    aten = _step_ops(lambda c: ms.elm2_step_f(tab, pair, 600.0, c), c0)
    assert "aten.cat" not in aten and aten["aten.copy_"] == 2, aten
    aten = _step_ops(lambda c: ms._step_f_cat(tab, pair, 600.0, c), c0)
    assert aten["aten.cat"] == 4, aten


def test_fp_step_folds_the_ring_shift_on_card(cuda_device):
    """The packed ensemble scan on the card (E = 2, N = 256) through kernel
    2's packed shift entry: no concatenation, and five steps bitwise to the
    packed step before the fold and to the unpacked scan."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh

    e, n, steps = 2, 256, 5
    rng = np.random.default_rng(34)
    pos, vel = rng.normal(size=(e, n, 3)) * 1e6, rng.normal(size=(e, n, 3))
    mu = rng.uniform(1e3, 1e5, n)
    shape, tab = (e, n, 3), get(QT12)
    carry0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, 600.0, device=cuda_device)
    run_fp, to_fp = sh.make_fused_ensemble_scan_fp(tab, mu, 600.0, steps, shape,
                                                   device=cuda_device)
    run_f, to_f = sh.make_fused_ensemble_scan_f(tab, mu, 600.0, steps, device=cuda_device)
    b = (cuda_elm2.elm2f_update_shift_packed.launches, cuda_elm2.elm2f_update_packed.launches)
    out = run_fp(to_fp(carry0))
    assert (cuda_elm2.elm2f_update_shift_packed.launches - b[0],
            cuda_elm2.elm2f_update_packed.launches - b[1]) == (steps, 0)
    ref = run_f(to_f(carry0))
    back = ms.elm2_fp_to(out, shape)
    assert all(torch.equal(x, z) for x, z in zip((*back.ys, *back.dd), (*ref.ys, *ref.dd)))
    pair = sh._ensemble_accel_pair(mu, cuda_device)
    cat = to_fp(carry0)
    for _ in range(steps):
        cat = ms._step_fp_cat(tab, pair, 600.0, cat, shape)
    assert all(torch.equal(x, z) for x, z in zip((*out.ys, *out.dd), (*cat.ys, *cat.dd)))
    aten = _step_ops(lambda c: ms.elm2_step_fp(tab, pair, 600.0, c, shape), to_fp(carry0))
    assert "aten.cat" not in aten and "aten.copy_" not in aten, aten


def test_fused_generation_on_card(cuda_device, monkeypatch):

    """The fused branch (gate forced open, N=32) launches kernel 2's shift
    entry once per step after the startup and no kernel 1 (its force is the
    native-f64 one on hi + lo, F3), and stays within 1e-10 of the eager f64
    branch (kernel 11-f64's gate patched off) in sample space over 2 days
    of full_solar_system."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps
    monkeypatch.setattr(eph, "_use_gen_kernel_f64", lambda n, device: False)
    plain = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    monkeypatch.setattr(eph, "_use_fused_f", lambda n, device: True)
    k1, k2 = cuda_nbody.pairwise_accel_df64.launches, cuda_elm2.elm2f_update_shift.launches
    k2u = cuda_elm2.elm2f_update.launches
    fused = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    assert cuda_nbody.pairwise_accel_df64.launches - k1 == 0
    assert cuda_elm2.elm2f_update_shift.launches - k2 == 288 - 12
    assert cuda_elm2.elm2f_update.launches == k2u
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


def _kernel4_rings(order, n, dev, seed=4):
    rng = np.random.default_rng(seed)
    ys = ex.from_f64_host(rng.normal(size=(order, n, 3)) * 1e8, dev)
    ys = ys[:3] + ((ys[2].double() * 2.0**-25).float(),)  # a nonzero fourth limb
    dd = TwoFloat(*cuda_nbody.split_f64(torch.tensor(rng.normal(size=(order, n, 3)) * 1e-6,
                                                     device=dev)))
    return ys, dd


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n", [1, 8, 33, 1365, 4096])
def test_kernel4_matches_plain_on_card(cuda_device, n, precise):
    """Kernel 4 against its plain version in both modes: bitwise (same ops,
    same order); one launch per call.  M = 3, 99 and 4095 fill no whole
    block of 32-element tiles."""
    ys, dd = _kernel4_rings(12, n, cuda_device)
    tab = get(QT12)
    before = cuda_elm2q.elm2q_update.launches
    k = cuda_elm2q.elm2q_update(tab, 600.0, ys, dd, precise=precise)
    assert cuda_elm2q.elm2q_update.launches == before + 1
    p = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(tab, 600.0, precise), ys, dd, precise)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n", [33, 4096])
def test_kernel4_stormer13_on_card(cuda_device, n, precise):
    """Kernel 4 on Stormer13 (order 13; two nonzero c_y rows and thirteen
    c_dy rows, another pattern than QT12's) against its plain version,
    bitwise, in both modes; and its packed entry point on a (13, 8, 3N/8)
    ring bitwise to the flat one."""
    ys, dd = _kernel4_rings(13, n, cuda_device, seed=5)
    tab = get("Stormer13")
    k = cuda_elm2q.elm2q_update(tab, 600.0, ys, dd, precise=precise)
    p = cuda_elm2q.elm2q_update_plain(*cuda_elm2q._tables(tab, 600.0, precise), ys, dd, precise)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if n % 8 == 0:
        packed = cuda_elm2q.elm2q_update_packed(
            tab, 600.0, tuple(l.reshape(13, 8, -1) for l in ys),
            TwoFloat(dd.hi.reshape(13, 8, -1), dd.lo.reshape(13, 8, -1)), precise=precise)
        for a, b in zip(packed, k):
            assert torch.equal(a, b.reshape(8, -1))


def test_extended3_generation_on_card(cuda_device):
    """precision="extended3" on the card: kernel 3-f64 (the route's f64
    form) for every startup force evaluation, kernel 13-chunk once for the
    scan, never kernel 3, kernel 4 or kernel 13; within
    1e-10 in sample space of the same run on the CPU over 2 days of
    full_solar_system, and its integrated positions below 1e-4 km of the
    "extended" run's (same state engine, f64 force; 2.0e-6 km on CPU)."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps
    tab = get(QT12)
    startup = 1 + tab.order * tab.substeps * (get(tab.starter).stages - 1)
    before = _every_launch()
    gpu = eph.generate_ephemeris(sc.state, sc.settings, span, precision="extended3",
                                 device=cuda_device)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"accel_limbs3_f64": startup, "gen_scan_q": 1}
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


F32_PAIR_SIZES = [1, 2, 31, 127, 128, 129, 1000, 4096]


@pytest.mark.parametrize("n", F32_PAIR_SIZES)
def test_kernel5_matches_plain_on_card(cuda_device, n):
    """Kernel 5 against its plain version: <= 1e-6 of max |a|; one launch;
    n=1 has no pair and gives 0; a second call is bitwise the first."""
    p32, m32 = _f32_inputs(*_cloud(n, 11), cuda_device)
    before = cuda_f32.pairwise_accel_f32.launches
    k = cuda_f32.pairwise_accel_f32(p32, m32)
    assert cuda_f32.pairwise_accel_f32.launches == before + 1
    r = cuda_f32.pairwise_accel_f32_plain(p32, m32)
    assert torch.isfinite(k).all()
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()
    assert torch.equal(cuda_f32.pairwise_accel_f32(p32, m32), k)


def test_f32_pair_shape_on_card(cuda_device):
    """The tile and receiver group compiled into kernels 5-7 are the ones
    `_f32_pair_geometry` partitions."""
    from ephemeris_explorer_tpu_torch import _build

    lib = _build.library()
    assert lib.eet_f32_pair_tile() == cuda_nbody.F32_PAIR_TILE
    assert lib.eet_f32_pair_group() == cuda_nbody.F32_PAIR_GROUP


@pytest.mark.parametrize("n", F32_PAIR_SIZES)
def test_kernel6_matches_plain_on_card(cuda_device, n):
    """Kernel 6 against its plain version: <= 1e-6 of max |a|; one launch;
    n=1 has no pair and gives 0; a second call is bitwise the first."""
    pos, mu = _cloud(n, 12)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos, device=cuda_device), transpose=True)
    m32 = torch.tensor(mu, device=cuda_device).float().reshape(1, -1)
    before = cuda_mixed.pairwise_accel_mixed.launches
    k = cuda_mixed.pairwise_accel_mixed(ph, pl, m32)
    assert cuda_mixed.pairwise_accel_mixed.launches == before + 1
    r = cuda_mixed.pairwise_accel_mixed_plain(ph, pl, m32)
    assert torch.isfinite(k).all()
    if n == 1:
        assert not k.any() and not r.any()
    else:
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()
    assert torch.equal(cuda_mixed.pairwise_accel_mixed(ph, pl, m32), k)


def _kernel7_inputs(n, dev):
    """The cloud, its f32 inputs and its strong-set mask (K = min(16, n - 1),
    diagonal included; n = 1: the diagonal alone)."""
    pos, mu = _cloud(n, 13)
    tp, tm = torch.tensor(pos, device=dev), torch.tensor(mu, device=dev)
    if n == 1:
        mask = torch.ones((1, 1), dtype=torch.int8, device=dev)
    else:
        mask = split.strong_pair_mask(split.strong_pair_indices(tp, tm, k=min(16, n - 1)), n)
    return (*_f32_inputs(pos, mu, dev), mask)


@pytest.mark.parametrize("n", F32_PAIR_SIZES)
def test_kernel7_matches_plain_on_card(cuda_device, n):
    """Kernel 7 in both modes against its plain version (<= 1e-6 of max |a|),
    a second call bitwise the first, and its rows form bitwise against the
    square form's row slices, at offsets that cut a lane's 32-receiver block,
    a 128-receiver group and a 32-source tile."""
    p32, m32, mask = _kernel7_inputs(n, cuda_device)
    no_diag = mask.clone()
    no_diag.fill_diagonal_(0)
    for m, diag in ((no_diag, False), (mask, True)):
        before = cuda_f32.pairwise_accel_f32_masked.launches
        k = cuda_f32.pairwise_accel_f32_masked(p32, m32, m, diag_in_mask=diag)
        assert cuda_f32.pairwise_accel_f32_masked.launches == before + 1
        r = cuda_f32.pairwise_accel_f32_masked_plain(p32, m32, m, diag_in_mask=diag)
        assert torch.isfinite(k).all()
        assert (k - r).abs().max() <= F32_VS_PLAIN * r.abs().max()
        assert torch.equal(cuda_f32.pairwise_accel_f32_masked(p32, m32, m, diag_in_mask=diag), k)
    cuts = ((0, n // 2), (n // 4, 100), (n - 7, 7), (33, 95), (127, 2), (31, 34), (0, n))
    for r0, nl in cuts:
        r0, nl = min(r0, n - 1), max(1, min(nl, n - min(r0, n - 1)))
        rows = cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask[r0:r0 + nl].contiguous(),
                                                       p32[r0:r0 + nl].contiguous())
        assert torch.equal(rows, k[r0:r0 + nl]), (r0, nl)


@pytest.mark.parametrize("n", [2, 129, 4096])
def test_kernel7_all_masked_row_is_zero_on_card(cuda_device, n):
    """A receiver row masked in full gives exactly zero, in both modes and in
    the rows form; the other rows are unchanged."""
    p32, m32, mask = _kernel7_inputs(n, cuda_device)
    full = mask.clone()
    full[n // 2] = 1
    for diag in (False, True):
        base = cuda_f32.pairwise_accel_f32_masked(p32, m32, mask, diag_in_mask=diag)
        k = cuda_f32.pairwise_accel_f32_masked(p32, m32, full, diag_in_mask=diag)
        assert not k[n // 2].any()
        keep = torch.arange(n, device=cuda_device) != n // 2
        assert torch.equal(k[keep], base[keep])
    rows = cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, full[n // 2:].contiguous(),
                                                   p32[n // 2:].contiguous())
    assert not rows[0].any()


KERNEL8_CASES = [(16, 6), (32, 16), (1000, 16), (4096, 16), (64, 40), (200, 128)]


def _kernel8_inputs(n, k, dev):
    pos, mu = _hierarchy() if n == 16 else _cloud(n, 14)
    tp, tm = torch.tensor(pos, device=dev), torch.tensor(mu, device=dev)
    return tp, tm, split.strong_pair_indices(tp, tm, k=k)


@pytest.mark.parametrize("n, k", KERNEL8_CASES)
def test_kernel8_matches_plain_on_card(cuda_device, n, k):
    """Kernel 8 against its plain version bitwise (K = 6 pads to KP = 8 in
    front; K = 40 and 128 add in-lane before the shuffles); the rows form
    bitwise against the square form's row slices."""
    tp, tm, idx = _kernel8_inputs(n, k, cuda_device)
    ph, pl = cuda_nbody.split_f64(tp)
    mh, ml = cuda_nbody.split_f64(tm)
    before = cuda_split.strong_correction_pair.launches
    kh, kl = cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, idx)
    assert cuda_split.strong_correction_pair.launches == before + 1
    rh, rl = cuda_split.strong_correction_pair_plain(ph, pl, ph, pl, mh, ml, idx)
    assert torch.isfinite(kh).all()
    assert torch.equal(kh, rh) and torch.equal(kl, rl)
    sq = cuda_split._strong_correction_fast(tp, tm, idx)
    for r0 in (0, n // 3):
        nl = n - r0
        rows = cuda_split._strong_correction_fast(tp, tm, idx[r0:].contiguous(), rows=tp[r0:])
        assert rows.shape == (nl, 3) and torch.equal(rows, sq[r0:])


@pytest.mark.parametrize("n, k", KERNEL8_CASES)
def test_kernel8_fused_is_the_composed_route_on_card(cuda_device, n, k):
    """Kernel 8's production form (f64 in, split in the kernel, the f64 sum
    with kernel 7's a32 added) equals the route it replaces bitwise:
    combine_f64 of the limb-fed kernel on split_f64's limbs, plus a32 in
    f64; square and rows forms, with and without a32; one launch each."""
    tp, tm, idx = _kernel8_inputs(n, k, cuda_device)
    mask = split.strong_pair_mask(idx, n)
    a32 = cuda_f32.pairwise_accel_f32_masked(tp.float(), tm.float().reshape(1, -1), mask,
                                             diag_in_mask=True)
    mh, ml = cuda_nbody.split_f64(tm)
    for r0 in (0, n // 3):
        rows = None if r0 == 0 else tp[r0:]
        idx_r, a_r = idx[r0:].contiguous(), a32[r0:].contiguous()
        ph, pl = cuda_nbody.split_f64(tp)
        rh, rl = cuda_nbody.split_f64(tp[r0:])
        combined = cuda_nbody.combine_f64(
            *cuda_split.strong_correction_pair(ph, pl, rh, rl, mh, ml, idx_r))
        before = cuda_split.strong_correction_pair.launches
        got = cuda_split.strong_correction_fused(tp, tm, idx_r, rows, a_r)
        assert cuda_split.strong_correction_pair.launches == before + 1
        assert got.dtype == torch.float64 and torch.equal(got, combined + a_r.double())
        assert torch.equal(cuda_split.strong_correction_fused(tp, tm, idx_r, rows), combined)
        assert torch.equal(cuda_split.strong_correction_fused_plain(tp, tm, idx_r, rows, a_r), got)


@pytest.mark.parametrize("n", [129, 1000, 4096])
def test_split_rows_match_square_on_card(cuda_device, n):
    """pairwise_accel_split_rows equals pairwise_accel_split's row slices
    bitwise (kernels 7 and 8 in their rows forms), four launches for the
    square form: two casts, kernel 7 and kernel 8."""
    pos, mu = _cloud(n, 16)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=16)
    mask = split.strong_pair_mask(idx, n)
    sq = cuda_split.pairwise_accel_split(tp, tm, idx, mask)
    assert torch.isfinite(sq).all() and sq.dtype == torch.float64
    for r0, nl in ((0, n), (n // 3, 100), (n - 7, 7), (33, 95)):
        rows = cuda_split.pairwise_accel_split_rows(tp, tp[r0:r0 + nl], tm,
                                                    idx[r0:r0 + nl].contiguous(),
                                                    mask[r0:r0 + nl].contiguous())
        assert torch.equal(rows, sq[r0:r0 + nl]), (r0, nl)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        cuda_split.pairwise_accel_split(tp, tm, idx, mask)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert launches == 4, launches


def test_kernel8_out_of_range_index_gives_nan(cuda_device):
    """An index outside [0, N) is not read: its receiver's correction is NaN,
    every other receiver's is the in-range result bitwise; in both entries
    of kernel 8."""
    pos, mu = _cloud(64, 15)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=8)
    ph, pl = cuda_nbody.split_f64(tp)
    mh, ml = cuda_nbody.split_f64(tm)
    bad_idx = idx.clone()
    bad_idx[3, 5] = 64
    bad_idx[40, 0] = -1
    a32 = torch.ones((64, 3), dtype=torch.float32, device=cuda_device)
    pairs = (
        (cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, idx),
         cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, bad_idx)),
        ((cuda_split.strong_correction_fused(tp, tm, idx, a32=a32),),
         (cuda_split.strong_correction_fused(tp, tm, bad_idx, a32=a32),)),
    )
    keep = torch.ones(64, dtype=torch.bool, device=cuda_device)
    keep[[3, 40]] = False
    for good_out, bad_out in pairs:
        for g, b in zip(good_out, bad_out):
            assert b[[3, 40]].isnan().all()
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
                cuda_mixed.pairwise_accel_mixed, cuda_split.strong_correction_pair,
                cuda_split.strong_correction_dd)
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
    with pytest.raises(TypeError):
        cuda_split.strong_correction_fused(p32, mh.double(), idx)
    with pytest.raises(ValueError):
        cuda_split.strong_correction_fused(p32.double(), mh.double(), idx[:8].contiguous())
    with pytest.raises(TypeError):
        cuda_split.strong_correction_fused(p32.double(), mh.double(), idx, a32=p32.double())
    with pytest.raises(TypeError):
        cuda_split.strong_correction_dd_fused(p32, mh.double(), idx)
    with pytest.raises(TypeError):
        cuda_split.strong_correction_dd_fused(p32.double(), mh.double(), idx, p32.double())
    with pytest.raises(ValueError):
        cuda_split.strong_correction_dd_fused(p32.double(), mh.double(), idx[:8].contiguous())
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


KERNEL9_CASES = [(16, 6), (32, 16), (1000, 16), (4096, 16), (64, 40), (200, 128), (256, 200)]


@pytest.mark.parametrize("n", [1, 3, 32, 255, 256, 257, 1365, 4096])
def test_kernel1_f64_matches_plain_on_card(cuda_device, n):
    """Kernel 1-f64's square form against its plain version: bitwise (the
    plain version repeats its ops in its order); one launch a call, into
    ``out`` when given; one body feels no force."""
    pos, mu = _cloud(n, 43)
    tp = torch.tensor(pos, device=cuda_device)
    tm = torch.tensor(mu, device=cuda_device)
    before = cuda_nbody64.pairwise_accel_f64.launches
    k = cuda_nbody64.pairwise_accel_f64(tp, tm)
    assert cuda_nbody64.pairwise_accel_f64.launches == before + 1
    assert torch.equal(k, cuda_nbody64.pairwise_accel_f64_plain(tp, tm))
    out = torch.full_like(k, float("nan"))
    assert cuda_nbody64.pairwise_accel_f64(tp, tm, out=out) is out and torch.equal(out, k)
    if n == 1:
        assert torch.equal(k, torch.zeros_like(k))


@pytest.mark.parametrize("n", [32, 257, 4096])
def test_kernel1_f64_rows_and_ensemble_on_card(cuda_device, n):
    """Kernel 1-f64's rows and ensemble forms: each bitwise to its plain
    version, row slices and members bitwise to the square form; one launch
    a call."""
    pos, mu = _cloud(n, 44)
    tp = torch.tensor(pos, device=cuda_device)
    tm = torch.tensor(mu, device=cuda_device)
    sq = cuda_nbody64.pairwise_accel_f64(tp, tm)
    for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1), (n - 1, 1)):
        before = cuda_nbody64.pairwise_accel_f64_rows.launches
        got = cuda_nbody64.pairwise_accel_f64_rows(tp, tp[r0:r0 + nl], r0, tm)
        assert cuda_nbody64.pairwise_accel_f64_rows.launches == before + 1
        assert torch.equal(got, sq[r0:r0 + nl])
        assert torch.equal(got, cuda_nbody64.pairwise_accel_f64_rows_plain(
            tp, tp[r0:r0 + nl], r0, tm))
    ens = torch.stack([tp, tp * 0.5, tp.flip(0)])
    before = cuda_nbody64.pairwise_accel_f64_ensemble.launches
    got = cuda_nbody64.pairwise_accel_f64_ensemble(ens, tm)
    assert cuda_nbody64.pairwise_accel_f64_ensemble.launches == before + 1
    assert torch.equal(got, cuda_nbody64.pairwise_accel_f64_ensemble_plain(ens, tm))
    assert torch.equal(got[0], sq)
    for m in range(3):
        assert torch.equal(got[m], cuda_nbody64.pairwise_accel_f64(ens[m].contiguous(), tm))


def test_kernel1_f64_off_the_fast_path_on_card(cuda_device):
    """Pairs whose r^2 is not a positive normal number (two bodies at one
    place: r^2 = 0; two 1e-161 km apart: a subnormal r^2) send their tile
    through CUDA's rsqrt() itself: every form equals its plain version, the
    infinities and NaNs in the same places, the other values bitwise."""
    pos, mu = _cloud(300, 46)
    pos[50] = pos[7]
    pos[8], pos[260] = 0.0, np.array([1e-161, 0.0, 0.0])
    tp = torch.tensor(pos, device=cuda_device)
    tm = torch.tensor(mu, device=cuda_device)
    k = cuda_nbody64.pairwise_accel_f64(tp, tm)
    pl = cuda_nbody64.pairwise_accel_f64_plain(tp, tm)
    assert not torch.isfinite(k[[7, 8, 50, 260]]).all() and torch.isfinite(k[100:250]).all()
    torch.testing.assert_close(k, pl, rtol=0, atol=0, equal_nan=True)
    rows = cuda_nbody64.pairwise_accel_f64_rows(tp, tp[40:290], 40, tm)
    torch.testing.assert_close(rows, pl[40:290], rtol=0, atol=0, equal_nan=True)
    ens = cuda_nbody64.pairwise_accel_f64_ensemble(torch.stack([tp, tp]), tm)
    torch.testing.assert_close(ens[1], pl, rtol=0, atol=0, equal_nan=True)


def test_kernel1_f64_wrappers_check_inputs_on_card(cuda_device):
    """The wrappers raise on inputs the kernel does not take (another dtype,
    a strided tensor, a tensor on another device) and launch nothing."""
    pos, mu = _cloud(64, 45)
    tp = torch.tensor(pos, device=cuda_device)
    tm = torch.tensor(mu, device=cuda_device)
    before = [f.launches for f in (cuda_nbody64.pairwise_accel_f64,
                                   cuda_nbody64.pairwise_accel_f64_rows,
                                   cuda_nbody64.pairwise_accel_f64_ensemble)]
    with pytest.raises(TypeError):
        cuda_nbody64.pairwise_accel_f64(tp.float(), tm)
    with pytest.raises(ValueError):
        cuda_nbody64.pairwise_accel_f64(tp.t().contiguous().t(), tm)
    with pytest.raises(ValueError):
        cuda_nbody64.pairwise_accel_f64(tp, tm.cpu())
    with pytest.raises(ValueError):
        cuda_nbody64.pairwise_accel_f64_rows(tp, tp[10:20], 60, tm)
    with pytest.raises(TypeError):
        cuda_nbody64.pairwise_accel_f64_ensemble(tp[None].float(), tm)
    assert [f.launches for f in (cuda_nbody64.pairwise_accel_f64,
                                 cuda_nbody64.pairwise_accel_f64_rows,
                                 cuda_nbody64.pairwise_accel_f64_ensemble)] == before


@pytest.mark.parametrize("n, k", KERNEL9_CASES)
def test_kernel9_matches_plain_on_card(cuda_device, n, k):
    """Kernel 9 against its plain version: bitwise, as kernel 8 (same feed
    arithmetic, same chain and tree; K = 128 is the largest unrolled
    instance, K = 200 the runtime-depth one); within 3e-13 per body of the
    f64 correction on the hierarchy."""
    tp, tm, idx = _kernel8_inputs(n, k, cuda_device)
    before = cuda_split.strong_correction_dd.launches
    kh, kl = cuda_split.strong_correction_dd(tp, tm, idx)
    assert cuda_split.strong_correction_dd.launches == before + 1
    rh, rl = cuda_split.strong_correction_dd_plain(tp, tm, idx)
    assert torch.isfinite(kh).all()
    assert torch.equal(kh, rh) and torch.equal(kl, rl)
    if n == 16:
        kc = cuda_nbody.combine_f64(kh, kl)
        assert _rel_rows(kc, split._strong_correction(tp, tm, idx)) < 3e-13


@pytest.mark.parametrize("n, k", KERNEL9_CASES)
def test_kernel9_fused_is_the_old_dd_route_on_card(cuda_device, n, k):
    """Kernel 9's f64 entry (kernel 8's f64 epilogue: the f64 sum with kernel
    7's a32 added) equals its plain version and the corr="dd" route it
    replaces bitwise, combine_f64 of the raw pair plus a32 in f64, with and
    without a32; one launch each; pairwise_accel_split(corr="dd") is four
    launches (two casts, kernel 7 and kernel 9)."""
    tp, tm, idx = _kernel8_inputs(n, k, cuda_device)
    mask = split.strong_pair_mask(idx, n)
    a32 = cuda_f32.pairwise_accel_f32_masked(tp.float(), tm.float().reshape(1, -1), mask,
                                             diag_in_mask=True)
    combined = cuda_nbody.combine_f64(*cuda_split.strong_correction_dd(tp, tm, idx))
    for tail in (a32, None):
        before = cuda_split.strong_correction_dd.launches
        got = cuda_split.strong_correction_dd_fused(tp, tm, idx, tail)
        assert cuda_split.strong_correction_dd.launches == before + 1
        want = combined if tail is None else combined + tail.double()
        assert got.dtype == torch.float64 and torch.equal(got, want)
        assert torch.equal(cuda_split.strong_correction_dd_fused_plain(tp, tm, idx, tail), got)
    assert torch.equal(cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="dd"),
                       combined + a32.double())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="dd")
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert launches == 4, launches


def test_kernel9_out_of_range_index_gives_nan(cuda_device):
    """Kernel 8's rule: an index outside [0, N) gives NaN for its receiver
    and leaves every other receiver bitwise; in both entries of kernel 9."""
    pos, mu = _cloud(64, 15)
    tp, tm = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    idx = split.strong_pair_indices(tp, tm, k=8)
    bad_idx = idx.clone()
    bad_idx[3, 5] = 64
    bad_idx[40, 0] = -1
    a32 = torch.ones((64, 3), dtype=torch.float32, device=cuda_device)
    pairs = (
        (cuda_split.strong_correction_dd(tp, tm, idx),
         cuda_split.strong_correction_dd(tp, tm, bad_idx)),
        ((cuda_split.strong_correction_dd_fused(tp, tm, idx, a32),),
         (cuda_split.strong_correction_dd_fused(tp, tm, bad_idx, a32),)),
    )
    keep = torch.ones(64, dtype=torch.bool, device=cuda_device)
    keep[[3, 40]] = False
    for good, bad in pairs:
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


SCENES = ("full_solar_system_2433282.5", "simple_solar_system_2433282.5",
          "sun_earth_moon_2433282.5")


def _f64_start(case, device, direction=1):
    """(native-f64 startup carry, mu, h) on ``device``: a bundled scene, or
    the cloud of N bodies; ``direction=-1`` steps backward (h < 0)."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    if isinstance(case, str):
        sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems" / case)
        pos, vel, mu = sc.state.positions(), sc.state.velocities(), sc.state.mus()
        h = sc.settings.dt.as_seconds()
    else:
        pos, mu = _cloud(case, 29)
        vel, h = np.zeros_like(pos), 600.0
    h *= direction
    tm = torch.tensor(mu, device=device)
    c0 = ms.elm2_init(get(QT12), lambda t, y: nbody.pairwise_accel(y, tm), 0.0,
                      torch.tensor(pos, device=device), torch.tensor(vel, device=device), h)
    return c0, tm, h


@pytest.mark.parametrize("case", [*SCENES, 33, 256])
def test_kernel11_f64_matches_plain_on_card(cuda_device, case):
    """Kernel 11-f64 over 64 steps against its plain version: bitwise
    (emissions and both rings; same ops in the same order, CUDA's f64 rsqrt
    on both sides), one launch; 33 puts two sources in a lane, 256 is the
    cap."""
    _kernel11_f64_vs_plain(cuda_device, case, 1)


@pytest.mark.parametrize("case", [*SCENES, 33, 256])
def test_kernel11_f64_backward_matches_plain_on_card(cuda_device, case):
    """Kernel 11-f64 stepping backward (h < 0, the route of backward
    generation): bitwise to its plain version, one launch."""
    _kernel11_f64_vs_plain(cuda_device, case, -1)


def _kernel11_f64_vs_plain(cuda_device, case, direction):
    c0, tm, h = _f64_start(case, cuda_device, direction)
    before = cuda_gen.elm2_gen_scan_f64.launches
    ys, c = cuda_gen.elm2_gen_scan_f64(get(QT12), h, c0, tm, 64)
    assert cuda_gen.elm2_gen_scan_f64.launches == before + 1
    ysp, cp = cuda_gen.elm2_gen_scan_f64_plain(get(QT12), h, c0, tm, 64)
    assert torch.equal(ys, ysp) and torch.equal(c.ys, cp.ys) and torch.equal(c.ddys, cp.ddys)
    assert torch.equal(ys[-1], c.ys[0]) and c.t == cp.t


def _launches():
    return (cuda_nbody.pairwise_accel_df64.launches, cuda_elm2.elm2f_update.launches,
            cuda_elm2.elm2f_update_shift.launches, cuda_gen.elm2_gen_scan.launches,
            cuda_gen.elm2_gen_scan_f64.launches)


def _count_calls(monkeypatch, module, name: str) -> dict:
    """Count the calls of ``module.name`` (patched for the test): the force
    evaluations that reach it."""
    calls = {"n": 0}
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls["n"] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_f64_generation_takes_kernel11_f64_on_card(cuda_device):
    """"f64" generation of full_solar_system (32 bodies) on the card runs its
    one chunk through kernel 11-f64 alone, and its coefficients stay within
    1e-10 of the eager route's in sample space."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps, one chunk
    before = _launches()
    gen = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    assert [a - b for a, b in zip(_launches(), before)] == [0, 0, 0, 0, 1]
    gate = eph._use_gen_kernel_f64
    try:
        eph._use_gen_kernel_f64 = lambda n, device: False
        plain = eph.generate_ephemeris(sc.state, sc.settings, span, device=cuda_device)
    finally:
        eph._use_gen_kernel_f64 = gate
    for n in plain.names:
        a, b = plain[n].coeffs, gen[n].coeffs
        assert a.shape == b.shape
        if a.size:
            norm = np.abs(fit_matrix(sc.settings.settings[n].degree)).sum(1)
            rows = norm > 0
            d = np.abs(a - b).max(axis=(0, 2))[rows] / norm[rows]
            assert d.max() <= 1e-10 * np.abs(a[:, 0]).max(), n


def test_backward_f64_generation_takes_kernel11_f64_on_card(cuda_device):
    """Backward "f64" generation of full_solar_system (30 days) on the card
    runs through kernel 11-f64 alone, one launch a chunk, and its
    coefficients stay within 1e-10 of the CPU's eager loop in sample space
    (backward fit matrices), the bar chip_smoke.py's phase 7 holds the
    forward year to."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    span = Duration.from_days(30.0)  # 4320 steps, one chunk
    before = _launches()
    gen = eph.generate_ephemeris(sc.state, sc.settings, span, direction=-1, device=cuda_device)
    assert [a - b for a, b in zip(_launches(), before)] == [0, 0, 0, 0, 1]
    cpu = eph.generate_ephemeris(sc.state, sc.settings, span, direction=-1, device="cpu")
    for n in cpu.names:
        a, b = cpu[n].coeffs, gen[n].coeffs
        assert a.shape == b.shape and cpu[n].start_s == gen[n].start_s
        if a.size:
            norm = np.abs(fit_matrix(sc.settings.settings[n].degree, True)).sum(1)
            rows = norm > 0
            d = np.abs(a - b).max(axis=(0, 2))[rows] / norm[rows]
            assert d.max() <= 1e-10 * np.abs(a[:, 0]).max(), n


@pytest.mark.parametrize("n", [257, 4096])
def test_f64_generation_takes_kernel1_f64_above_256_on_card(cuda_device, n, monkeypatch):
    """Above 256 bodies "f64" generation on the card runs the native-f64
    step loop: no kernel 11-f64 (its size rule), no kernel 1 or 2 (the fused
    gate is off); its force is kernel 1-f64's square form, exactly one
    launch a force evaluation, the startup's included, and its update
    kernel 2-f64, one launch a multistep step."""
    from ephemeris_explorer_tpu_torch import Duration, Epoch
    from ephemeris_explorer_tpu_torch.ops import nbody

    evals = _count_calls(monkeypatch, nbody, "pairwise_accel")

    pos, mu = _cloud(n, 30)
    names = [f"b{i:04d}" for i in range(n)]
    state = scene.SolarSystemState(
        name=f"cloud{n}", epoch=Epoch.parse("2000-01-01 12:00:00"),
        bodies=[scene.Body(b, float(m), p, np.zeros(3)) for b, m, p in zip(names, mu, pos)])
    settings = scene.EphemeridesSettings(
        dt=Duration(600.0),
        settings={b: scene.InterpolationParameters(degree=8, count=4) for b in names})
    before, before64 = _launches(), _every_launch()
    eph.generate_ephemeris(state, settings, Duration(16 * 600.0), device=cuda_device)
    torch.cuda.synchronize()
    assert _launches() == before
    steps = 16 - get(QT12).order  # the multistep steps after the ORDER startup steps
    assert evals["n"] > 16 and _new_launches(before64) == {"accel_f64": evals["n"],
                                                           "elm2f64_update_shift": steps}


def test_f64_ensemble_force_is_native_on_card(cuda_device, monkeypatch):
    """F2: the f64 ensemble startup and scan on the card (E = 3, N = 256)
    launch no kernel 1 (ensemble form or square): kernel 1-f64's ensemble
    form, one launch a force evaluation, and kernel 2-f64 once a scan step;
    and each member of the ensemble force is the square kernel 1-f64's
    force on it, bitwise."""
    from ephemeris_explorer_tpu_torch.ops import nbody
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh

    e, n = 3, 256
    rng = np.random.default_rng(41)
    pos, vel = rng.normal(size=(e, n, 3)) * 1e6, rng.normal(size=(e, n, 3))
    mu = rng.uniform(1e3, 1e5, n)
    tab = get(QT12)
    evals = _count_calls(monkeypatch, nbody, "pairwise_accel_ensemble")
    before = _every_launch()
    carry0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, 600.0, device=cuda_device)
    sh.make_fused_ensemble_scan(tab, mu, 600.0, 5, device=cuda_device)(carry0)
    torch.cuda.synchronize()
    assert evals["n"] > 5 and _new_launches(before) == {"accel_f64_ensemble": evals["n"],
                                                        "elm2f64_update_shift": 5}
    y, mu_t = torch.tensor(pos, device=cuda_device), torch.tensor(mu, device=cuda_device)
    acc = sh._fused_ensemble_accel(mu, cuda_device)(0.0, y)
    for m in range(e):
        assert torch.equal(acc[m], cuda_nbody64.pairwise_accel_f64(y[m].contiguous(), mu_t))
        assert torch.equal(acc[m], nbody.pairwise_accel(y[m], mu_t))


def test_fleet_on_card(cuda_device):
    """Four ships (two with an Earth-relative burn) as one batch of the fleet
    loop on the card: bitwise to itself across two runs, within 1e-2 km of
    the CPU port at 0.1, 0.5 and 0.9 of each span (the JAX package's
    batched-vs-single bar), the same ends within 1 s; no kernel launched."""
    from ephemeris_explorer_tpu_torch import Duration, Epoch
    from ephemeris_explorer_tpu_torch.spacecraft import propagate_ships

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "sun_earth_moon_2433282.5")
    e = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(5.0), device=cuda_device)
    base = sc.ships[0]
    t_burn = base.start.as_offset_seconds() + 3600.0
    ships = [scene.Ship(
        name=f"fleet-{k}", integrator="Verner87", tolerance=1e-3, start=base.start,
        end=Epoch.from_offset_seconds(base.start.as_offset_seconds() + 86400.0),
        position=base.position + np.array([100.0 * k, 0, 0]), velocity=base.velocity,
        burns=([scene.ShipBurn(start=Epoch.from_offset_seconds(t_burn),
                               duration=Duration.from_seconds(120.0),
                               acceleration=np.array([2e-3, 0.0, 0.0]), reference="Earth")]
               if k % 2 else [])) for k in range(4)]
    before = _launches()
    a = propagate_ships(e, ships, max_knots=4096, device=cuda_device)
    b = propagate_ships(e, ships, max_knots=4096, device=cuda_device)
    assert _launches() == before
    cpu = propagate_ships(e, ships, max_knots=4096, device="cpu")
    for s in ships:
        np.testing.assert_array_equal(a[s.name].ts, b[s.name].ts)
        np.testing.assert_array_equal(a[s.name].pos, b[s.name].pos)
        g, c = a[s.name], cpu[s.name]
        assert abs(g.end_s - c.end_s) < 1.0
        for frac in (0.1, 0.5, 0.9):
            t = c.start_s + frac * (c.end_s - c.start_s)
            assert np.abs(g.position(t) - c.position(t)).max() < 1e-2, (s.name, frac)


# ---------------------------------------------------------------------------
# The Universe session on the card, against the same session on the CPU
# ---------------------------------------------------------------------------

SEM = Path(__file__).resolve().parent.parent / "systems" / "sun_earth_moon_2433282.5"


def _universe_err(a, b):
    """Worst per-body coefficient difference of two universes in sample
    space (backward segments against the backward fit matrices), over each
    body's max |position|; the layouts must be equal."""
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    t0 = a.state.epoch.as_offset_seconds()
    worst = 0.0
    for n in a.names:
        x, y = a.ephemeris[n], b.ephemeris[n]
        assert (x.start_s, x.interval_s, x.segment_count) == (
            y.start_s, y.interval_s, y.segment_count), n
        k = int(round((t0 - x.start_s) / x.interval_s))
        for part, backward in ((slice(0, k), True), (slice(k, None), False)):
            ca, cb = x.coeffs[part], y.coeffs[part]
            if ca.size:
                norm = np.abs(fit_matrix(a.settings.settings[n].degree, backward)).sum(1)
                rows = norm > 0
                d = np.abs(ca - cb).max(axis=(0, 2))[rows] / norm[rows]
                worst = max(worst, float(d.max() / np.abs(y.coeffs[:, 0]).max()))
    return worst


def _sessions(cuda_device):
    """The sun_earth_moon session generated 40 days forward and 30 back on
    the card and on the CPU; the card's kernel launches while generating."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.api import Universe

    before = _launches()
    g = Universe.load(SEM, device=cuda_device)
    g.generate(Duration.from_days(40.0), Duration.from_days(30.0))
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launches(), before)]
    c = Universe.load(SEM, device="cpu")
    c.generate(Duration.from_days(40.0), Duration.from_days(30.0))
    return g, c, launched


def test_universe_generation_on_card(cuda_device):
    """A Universe on the card generates both directions through kernel
    11-f64 (one launch a chunk, no other kernel), within 1e-10 of the CPU
    session in sample space; a background extension paused and resumed,
    then concurrent forward and backward tasks, keep that bar."""
    from ephemeris_explorer_tpu_torch import Duration

    g, c, launched = _sessions(cuda_device)
    assert g.device.type == "cuda" and g._fwd.device.type == "cuda"
    assert launched == [0, 0, 0, 0, 2]
    assert _universe_err(g, c) <= 1e-10
    task = g.extend(Duration.from_days(60.0), background=True)
    task.pause()
    assert task.paused
    task.resume()
    task.join(timeout=300)
    assert not task.in_progress and task.progress == 1.0
    c.extend(Duration.from_days(60.0))
    assert _universe_err(g, c) <= 1e-10
    t_f = g.extend(Duration.from_days(20.0), +1, background=True)
    t_b = g.extend(Duration.from_days(30.0), -1, background=True)
    t_f.join(timeout=300)
    t_b.join(timeout=300)
    c.extend(Duration.from_days(20.0), +1)
    c.extend(Duration.from_days(30.0), -1)
    assert _universe_err(g, c) <= 1e-10


def test_universe_hammer_on_card(cuda_device):
    """Reads racing a backward extension on the card (64-step chunks, each
    merged under the lock) are bit-stable, and the extension lands."""
    from ephemeris_explorer_tpu_torch import Duration, Epoch
    from ephemeris_explorer_tpu_torch.api import PredictionTask, Universe

    g = Universe.load(SEM, device=cuda_device)
    g.generate(Duration.from_days(40.0))
    t0 = g.state.epoch
    at = Epoch.from_offset_seconds(t0.as_offset_seconds() + 10 * 86400.0)
    ref = g.positions(at)
    prop = g._propagator(-1)
    n_steps = int(round(Duration.from_days(60.0).as_seconds() / prop.dt_s))
    task = PredictionTask(prop, g.ephemeris, g.lock, prop.steps_done + n_steps,
                          chunk_steps=64).start()
    worst, reads = 0.0, 0
    while task.in_progress:
        worst = max(worst, float(np.max(np.abs(g.positions(at) - ref))))
        assert len(g.export_state(at).bodies) == len(g.names)
        reads += 1
    task.join(timeout=300)
    assert reads > 0 and worst == 0.0, (reads, worst)
    assert g.ephemeris.start.as_offset_seconds() < t0.as_offset_seconds()


def test_universe_replan_and_events_on_card(cuda_device):
    """On the same coefficients, the card session's replans (a burned Earth
    Station, then an edit of its burn: an incremental replan) stay within
    1e-2 km of the CPU session's at 0.1, 0.5 and 0.9 of the span, end within
    1 s, launch no kernel, keep every knot before the restart, and find the
    same SOI transitions and apsides (bodies and kinds equal, times within
    1 s)."""
    from ephemeris_explorer_tpu_torch import Duration, Epoch
    from ephemeris_explorer_tpu_torch.api import Burn

    g, c, _ = _sessions(cuda_device)
    g.ephemeris.bodies = {n: eph.BodyEphemeris(b.start_s, b.interval_s, b.coeffs.copy())
                          for n, b in c.ephemeris.bodies.items()}
    entries = {}
    for u in (g, c):
        ship = u.scene.ships[0]
        entry = u.spawn_ship(ship, propagate_now=False)
        t_burn = ship.start.as_offset_seconds() + 0.3 * (
            ship.end.as_offset_seconds() - ship.start.as_offset_seconds())
        entry.plan.add_burn(Burn(start=Epoch.from_offset_seconds(t_burn),
                                 duration=Duration.from_seconds(120.0),
                                 acceleration=np.array([5e-4, 0.0, 0.0]), reference="Earth"))
        entries[u] = entry
    before = _launches()
    for stage in ("first", "edited"):
        for u in (g, c):
            entry = entries[u]
            if stage == "edited":
                bid = next(iter(entry.plan.burns))
                kept = entry.trajectory.ts.copy()
                u.edit_burn(entry.ship.name, bid, acceleration=[6e-4, 0.0, 0.0])
                t_restart = entry.plan.burns[bid].start.as_offset_seconds()
                n_kept = int(np.searchsorted(kept, t_restart, side="right"))
                assert np.array_equal(entry.trajectory.ts[:n_kept], kept[:n_kept])
            else:
                u.replan(entry.ship.name)
        a, b = entries[g], entries[c]
        ta, tb = a.trajectory, b.trajectory
        assert abs(ta.end_s - tb.end_s) < 1.0, stage
        for f in (0.1, 0.5, 0.9):
            t = tb.start_s + f * (tb.end_s - tb.start_s)
            assert np.abs(ta.position(t) - tb.position(t)).max() < 1e-2, (stage, f)
        assert [x for _, x in a.transitions] == [x for _, x in b.transitions], stage
        assert [(x.body, x.periapsis) for x in a.apsides] == [
            (x.body, x.periapsis) for x in b.apsides], stage
        assert all(abs(x[0] - y[0]) < 1.0 for x, y in zip(a.transitions, b.transitions))
        assert all(abs(x.time - y.time) < 1.0 for x, y in zip(a.apsides, b.apsides))
    torch.cuda.synchronize()
    assert _launches() == before


# -- kernel 12 (the tf96 force), "extendedF", perturbations and the dd truth --


def _kernel12_case(case):
    """(positions, mu) of a kernel 12 case: a bundled scene, the close-pair
    cluster of test_torch_tf96.py, or a seeded cloud of N bodies ("cap": the
    1,365 that one block's default 48 KiB of shared memory held, the first
    version's cap)."""
    if case in SCENES:
        sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems" / case)
        return np.asarray(sc.state.positions()), np.asarray(sc.state.mus())
    if case == "close_cluster":
        rng = np.random.default_rng(11)
        pos = rng.normal(size=(8, 3)) * 1.0e8
        pos[1] = pos[0] + rng.normal(size=3) * 1.0e3
        return pos, 10.0 ** rng.uniform(3, 11, size=8)
    pos, mu = _cloud(1365 if case == "cap" else case, 12)
    return pos * 1e2, mu


@pytest.mark.parametrize("case", [*SCENES, "close_cluster", 1, 100, "cap", 4096, 6456, 6457])
def test_kernel12_matches_plain_on_card(cuda_device, case):
    """Kernel 12 against its plain version on the card: bitwise (the same
    IEEE f32 ops in the same order, the tree in tf96.tree_sum's order); one
    launch a call.  N = 4096 and 6456 keep each row in shared memory past
    the default 48 KiB (the opt-in), 6457 in the global scratch."""
    from ephemeris_explorer_tpu_torch.ops import nbody_full3

    pos, mu = _kernel12_case(case)
    limbs = ex.from_f64_host(pos, cuda_device)[:3]
    mu_d = torch.tensor(mu, device=cuda_device)
    before = nbody_full3.pairwise_accel_full3.launches
    k = nbody_full3.pairwise_accel_full3(*limbs, mu_d)
    assert nbody_full3.pairwise_accel_full3.launches == before + 1
    p = nbody_full3.pairwise_accel_full3_plain(*limbs, mu_d)
    assert torch.equal(k, p)
    assert torch.isfinite(k).all()


def test_kernel12_above_its_old_cap_on_card(cuda_device):
    """F4: kernel 12 has no cap.  At N = 1,366, one body past what one
    block's default 48 KiB of shared memory held, it launches (no raise, no
    plain route) and is bitwise to its plain version; the library keeps a
    row in shared memory up to nbody_full3.SMEM_BODIES and asks for global
    scratch above it."""
    from ephemeris_explorer_tpu_torch import _build
    from ephemeris_explorer_tpu_torch.ops import nbody_full3

    lib = _build.library()
    assert lib.eet_accel_full3_smem_bodies() == nbody_full3.SMEM_BODIES
    assert lib.eet_accel_full3_scratch_floats(nbody_full3.SMEM_BODIES) == 0
    assert lib.eet_accel_full3_scratch_floats(nbody_full3.SMEM_BODIES + 1) > 0
    n = 1366
    pos, mu = _cloud(n, 13)
    limbs = ex.from_f64_host(pos * 1e2, cuda_device)[:3]
    mu_d = torch.tensor(mu, device=cuda_device)
    before = nbody_full3.pairwise_accel_full3.launches
    k = nbody_full3.pairwise_accel_full3(*limbs, mu_d)
    assert nbody_full3.pairwise_accel_full3.launches == before + 1
    assert torch.equal(k, nbody_full3.pairwise_accel_full3_plain(*limbs, mu_d))
    assert torch.isfinite(k).all()


def test_extendedF_generation_above_the_old_cap_on_card(cuda_device):
    """F4: precision="extendedF" of a 1,366-body cluster over one short chunk
    on the card: finite coefficients, kernel 12 once a force evaluation, the
    startup's included (it raised before)."""
    from ephemeris_explorer_tpu_torch import Duration, Epoch
    from ephemeris_explorer_tpu_torch.ops import nbody_full3

    n, steps = 1366, 32  # one fitted segment of 8 intervals x count 4
    pos, mu = _cloud(n, 14)
    vel = np.random.default_rng(15).normal(size=(n, 3))
    names = [f"b{i:04d}" for i in range(n)]
    state = scene.SolarSystemState(
        name="cluster1366", epoch=Epoch.parse("2000-01-01 12:00:00"),
        bodies=[scene.Body(b, float(m), p, v) for b, m, p, v in zip(names, mu, pos, vel)])
    settings = scene.EphemeridesSettings(
        dt=Duration(600.0),
        settings={b: scene.InterpolationParameters(degree=8, count=4) for b in names})
    tab = get(QT12)
    starter = get(tab.starter)
    evals = 1 + tab.order * tab.substeps * (starter.stages - 1) + steps - tab.order
    before = nbody_full3.pairwise_accel_full3.launches
    e = eph.generate_ephemeris(state, settings, Duration(steps * 600.0), precision="extendedF",
                               device=cuda_device)
    torch.cuda.synchronize()
    assert nbody_full3.pairwise_accel_full3.launches - before == evals
    assert all(np.isfinite(e[b].coeffs).all() and e[b].coeffs.size for b in names)


def _sample_space_close(a, b, settings, bound=1e-10):
    from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

    for n in a.names:
        ca, cb = a[n].coeffs, b[n].coeffs
        assert ca.shape == cb.shape
        if ca.size:
            norm = np.abs(fit_matrix(settings.settings[n].degree)).sum(1)
            rows = norm > 0
            d = np.abs(ca - cb).max(axis=(0, 2))[rows] / norm[rows]
            assert d.max() <= bound * np.abs(ca[:, 0]).max(), n


def test_extendedF_generation_on_card(cuda_device):
    """precision="extendedF" on the card: kernel 12 once per startup force
    evaluation, kernel 13-chunk once for the scan, and no kernel 3, 4 or 13;
    within 1e-10 in sample space of the CPU port over 2 days of
    full_solar_system."""
    from ephemeris_explorer_tpu_torch import Duration

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    tab = get(QT12)
    starter = get(tab.starter)
    evals = 1 + tab.order * tab.substeps * (starter.stages - 1)
    before = _every_launch()
    gpu = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(2.0),
                                 precision="extendedF", device=cuda_device)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"accel_full3": evals, "gen_scan_q": 1}
    cpu = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(2.0),
                                 precision="extendedF", device="cpu")
    _sample_space_close(cpu, gpu, sc.settings)


def test_perturbed_f64_generation_on_card(cuda_device):
    """"f64" with the Sun's 1PN term and the Earth's J2 on the card runs the
    eager native-f64 loop: no kernel 11-f64 (the routing rule), no other
    kernel; within 1e-10 in sample space of the CPU port over 2 days of
    full_solar_system."""
    from ephemeris_explorer_tpu_torch import Duration
    from ephemeris_explorer_tpu_torch.ops import perturbations as perts

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    names = [b.name for b in sc.state.bodies]
    spec = (perts.spec_schwarzschild(names.index("Sun")),
            perts.spec_j2(names.index("Earth"), perts.EARTH_J2, perts.EARTH_RADIUS_KM))
    before = _launches()
    gpu = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(2.0),
                                 perturbations=spec, device=cuda_device)
    torch.cuda.synchronize()
    assert _launches() == before
    cpu = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(2.0),
                                 perturbations=spec, device="cpu")
    _sample_space_close(cpu, gpu, sc.settings)


def test_dd_truth_bitwise_card_vs_cpu(cuda_device):
    """The dd force and three steps of the CF truth stepper on
    full_solar_system: the card's bitwise the CPU's (every dd op is one
    correctly rounded IEEE f64 op on both devices)."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    pos, vel, mu = sc.state.positions(), sc.state.velocities(), sc.state.mus()
    h = sc.settings.dt.as_seconds()
    tab = get(QT12)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        mu_d = torch.tensor(mu, device=dev)

        def accel_dd(t, y, mu_d=mu_d):
            return nbody.pairwise_accel_dd(y, mu_d)

        c = ms.elm2_init_cf(tab, accel_dd, 0.0, torch.tensor(pos, device=dev),
                            torch.tensor(vel, device=dev), h)
        for _ in range(3):
            c = ms.elm2_step_cf(tab, accel_dd, h, c)
        out.append([x.cpu() for x in (c.ys.hi, c.ys.lo, c.ddys.hi, c.ddys.lo, c.dy.hi, c.dy.lo)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


# -- slice 14: the scale-out leftovers and the audit on the card ----------------


def _every_launch() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from ephemeris_explorer_tpu_torch.ops import nbody_full3

    fns = {"accel_df64": cuda_nbody.pairwise_accel_df64,
           "accel_df64_ensemble": cuda_nbody.pairwise_accel_df64_ensemble,
           "accel_df64_rows": cuda_nbody.pairwise_accel_df64_rows,
           "accel_f64": cuda_nbody64.pairwise_accel_f64,
           "accel_f64_ensemble": cuda_nbody64.pairwise_accel_f64_ensemble,
           "accel_f64_rows": cuda_nbody64.pairwise_accel_f64_rows,
           "elm2f_update": cuda_elm2.elm2f_update, "elm2f_update_shift": cuda_elm2.elm2f_update_shift,
           "accel_limbs3": cuda_limbs.pairwise_accel_limbs_pair,
           "accel_limbs3_rows": cuda_limbs.pairwise_accel_limbs_pair_rows,
           "accel_limbs3_f64": cuda_limbs64.pairwise_accel_limbs64,
           "accel_limbs3_f64_pair": cuda_limbs64.pairwise_accel_limbs64_pair,
           "accel_limbs3_f64_rows": cuda_limbs64.pairwise_accel_limbs64_rows,
           "elm2q_update": cuda_elm2q.elm2q_update, "accel_f32": cuda_f32.pairwise_accel_f32,
           "accel_mixed": cuda_mixed.pairwise_accel_mixed,
           "accel_f32_masked": cuda_f32.pairwise_accel_f32_masked,
           "strong_corr": cuda_split.strong_correction_pair,
           "strong_corr_dd": cuda_split.strong_correction_dd,
           "accel_sym": cuda_sym.pairwise_accel_df64_sym, "gen_scan": cuda_gen.elm2_gen_scan,
           "gen_scan_f64": cuda_gen.elm2_gen_scan_f64,
           "accel_full3": nbody_full3.pairwise_accel_full3,
           "elm2f64_update_shift": cuda_elm2f64.elm2f64_update_shift,
           "elm2q_update_shift": cuda_elm2qs.elm2q_update_shift,
           "fleet_scan": cuda_fleet.fleet_scan, "gen_scan_q": cuda_genq.elm2_gen_scan_q}
    return {k: f.launches for k, f in fns.items()}


def _new_launches(before: dict) -> dict:
    return {k: v - before[k] for k, v in _every_launch().items() if v != before[k]}


def test_sharded_ensemble_and_fleet_on_card(cuda_device, tmp_path, monkeypatch):
    """A one-rank NCCL group: the GSPMD ensemble layout (init_ensemble_carry,
    one step, a 3-step scan) bitwise to the unsharded f64 ensemble, its
    force kernel 1-f64's rows form, one launch a member a force evaluation,
    its update kernel 2-f64, one launch a step, and no other kernel (F2);
    four ships through
    make_sharded_fleet_propagator bitwise to propagate_batch, kernel 14
    alone launched, once a host read of the done flags."""
    from ephemeris_explorer_tpu_torch.ops import nbody
    import torch.distributed as dist

    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.ftime import Duration, Epoch
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams
    from ephemeris_explorer_tpu_torch.parallel import sharding as sh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = sh.make_mesh(1, 1)
        rng = np.random.default_rng(29)
        pos, vel = rng.normal(size=(4, 256, 3)) * 1e6, rng.normal(size=(4, 256, 3))
        mu = rng.uniform(1e3, 1e5, size=256)
        tab = get(QT12)
        before = _every_launch()
        rows = _count_calls(monkeypatch, nbody, "pairwise_accel_rows")
        c = sh.init_ensemble_carry(mesh, tab, mu, 0.0, pos, vel, 600.0)
        stepped = sh.make_sharded_ensemble_step(mesh, tab, mu, 600.0)(c)
        out = sh.make_sharded_ensemble_scan(mesh, tab, mu, 600.0, 3)(c)
        torch.cuda.synchronize()
        assert rows["n"] > 4 * 4 and _new_launches(before) == {"accel_f64_rows": rows["n"],
                                                               "elm2f64_update_shift": 1 + 3}
        c0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, 600.0, device=cuda_device)
        refs = (c0, ms.elm2_step(tab, sh._fused_ensemble_accel(mu, cuda_device), 600.0, c0),
                sh.make_fused_ensemble_scan(tab, mu, 600.0, 3, device=cuda_device)(c0))
        for got, ref in zip((c, stepped, out), refs):
            assert torch.equal(got.ys, ref.ys.transpose(0, 1))
            assert torch.equal(got.ddys, ref.ddys.transpose(0, 1))
            assert torch.equal(got.dy, ref.dy) and got.t == ref.t

        sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                              / "sun_earth_moon_2433282.5")
        packed = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0),
                                        device=cuda_device).pack(cuda_device)
        t0 = sc.state.epoch.as_offset_seconds()
        burns = [[scene.ShipBurn(start=Epoch.from_offset_seconds(t0 + 3600.0 + 60.0 * k),
                                 duration=Duration.from_seconds(60.0),
                                 acceleration=np.array([1e-3, 0.0, 0.0]), reference="Earth")]
                 for k in range(4)]
        tl = spacecraft.stack_timelines([spacecraft.build_timeline(b, {"Earth": 1})
                                         for b in burns])
        host = (np.full(4, t0 + 60.0),
                np.stack([sc.ships[0].position + [10.0 * k, 0.0, 0.0] for k in range(4)]),
                np.stack([sc.ships[0].velocity] * 4), np.full(4, t0 + 7200.0))
        params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3, n_max=10_000)
        fn, place = sh.make_sharded_fleet_propagator(mesh, "Verner87", params, 256)
        before = _every_launch()
        spacecraft.propagate_batch.syncs = 0
        res = sh.gather_fleet(mesh, fn(*place(packed, tl, *host)))
        torch.cuda.synchronize()
        assert _new_launches(before) == {"fleet_scan": spacecraft.propagate_batch.syncs} != {}
        ref = spacecraft.propagate_batch(spacecraft.get_method("Verner87"), packed, tl, *host,
                                         params, max_knots=256)
        assert (res.count > 1).all()
        assert all(torch.equal(a, b) for a, b in zip(res, ref))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode,kernels,bound", [
    ("expansion3", {"accel_limbs3_f64", "elm2q_update_shift"}, 1e-15),
    ("expansionF", {"accel_full3", "elm2q_update_shift"}, 0.0),
    ("fused", {"accel_limbs3_f64_pair", "elm2q_update"}, 1e-15)])
def test_audit_kernel_modes_on_card(cuda_device, mode, kernels, bound):
    """48 steps of full_solar_system through an audit kernel mode on the
    card: only its kernels launch (the expansion modes' step is kernel 13
    and the force), and its positions are within ``bound``
    of max |y| of the CPU port's run of the same mode: bitwise through
    kernel 12, which is bitwise to its plain version; a few times the
    ~1e-17 read through the 3-limb route, kernel 3-f64 on the card against
    kernel 3's plain version on the CPU (1.4e-17 between the two plain
    versions over 288 steps on the CPU)."""
    from ephemeris_explorer_tpu_torch import audit

    st = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5").state
    before = _every_launch()
    card, info = audit.trajectory(mode, st, 600.0, 48, 1, device=cuda_device)
    assert set(_new_launches(before)) == kernels and info["backend"] == "cuda"
    cpu, _ = audit.trajectory(mode, st, 600.0, 48, 1, device="cpu")
    gap = np.abs(card - cpu).max() / np.abs(cpu).max()
    assert gap <= bound, (mode, gap)


def test_dryrun_one_nccl_rank_on_card(cuda_device):
    """The dry run at one rank takes NCCL on the card and passes every check."""
    from ephemeris_explorer_tpu_torch.parallel import dryrun

    out = dryrun.dryrun_multichip(1)
    assert out["backend"] == "nccl" and out["mesh"] == [1, 1]
    assert out["checks"]["ensemble_step_rel"] == 0.0
    assert all(out["checks"][k] for k in ("shardmap_ensemble_scan_f", "rowsharded_scan_f",
                                          "rowsharded_scan_qf", "rowsharded_split_force"))


# -- kernel 2-f64 (the native-f64 ELM2 update with the ring shift) ---------------------


@pytest.mark.parametrize("m", [3, 99, 4095, 12288, 196608])
@pytest.mark.parametrize("method", [QT12, "Stormer13"])
def test_kernel2_f64_matches_plain_on_card(cuda_device, method, m):
    """Kernel 2-f64 against its plain version on the card: y and the shifted
    rings bitwise (the same f64 multiplies and adds in the same order, none
    contracted), ddys_new[0] left for the force; one launch a call."""
    tab = get(method)
    rng = np.random.default_rng(m)
    ys = torch.tensor(rng.normal(size=(tab.order, m)) * 1e8, device=cuda_device)
    dd = torch.tensor(rng.normal(size=(tab.order, m)) * 1e-6, device=cuda_device)
    before = cuda_elm2f64.elm2f64_update_shift.launches
    y, ys_new, dd_new = cuda_elm2f64.elm2f64_update_shift(tab, 600.0, ys, dd)
    assert cuda_elm2f64.elm2f64_update_shift.launches == before + 1
    py, pys, pdd = cuda_elm2f64.elm2f64_update_shift_plain(
        cuda_elm2f64._plan(tab, 600.0).coef, ys, dd)
    assert torch.equal(y, py) and torch.equal(ys_new, pys) and torch.equal(dd_new[1:], pdd[1:])
    assert y.data_ptr() == ys_new.data_ptr()


def test_kernel2_f64_wrapper_checks_inputs_on_card(cuda_device):
    """Wrong dtype, shape, contiguity or ring depth raises before any launch."""
    tab = get(QT12)
    ys = torch.zeros((tab.order, 30), dtype=torch.float64, device=cuda_device)
    before = cuda_elm2f64.elm2f64_update_shift.launches
    with pytest.raises(TypeError):
        cuda_elm2f64.elm2f64_update_shift(tab, 600.0, ys.float(), ys.float())
    with pytest.raises(ValueError):
        cuda_elm2f64.elm2f64_update_shift(tab, 600.0, ys, ys[:, :20])
    with pytest.raises(ValueError):
        cuda_elm2f64.elm2f64_update_shift(tab, 600.0, ys, ys.t().contiguous().t())
    with pytest.raises(ValueError):
        cuda_elm2f64.elm2f64_update_shift(tab, 600.0, ys[1:], ys[1:])
    assert cuda_elm2f64.elm2f64_update_shift.launches == before


def test_f64_step_is_two_launches_on_card(cuda_device):
    """The native-f64 step at N = 4096 on the card: kernel 2-f64 and kernel
    1-f64 once each a step and nothing else, no concatenation and no force
    copy (the force writes the new ring row); 10 steps bitwise to the same
    step with kernel 2-f64's plain version in its place."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    tab = get(QT12)
    pos, mu = _cloud(4096, 40)
    vel = np.random.default_rng(41).normal(size=(4096, 3))
    mu_d = torch.tensor(mu, device=cuda_device)

    @ms.writes_into
    def accel(t, y, out=None):
        return nbody.pairwise_accel(y, mu_d, out=out)

    c0 = ms.elm2_init(tab, accel, 0.0, torch.tensor(pos, device=cuda_device),
                      torch.tensor(vel, device=cuda_device), 600.0)
    torch.cuda.synchronize()
    before = _every_launch()
    c = c0
    for _ in range(10):
        c = ms.elm2_step(tab, accel, 600.0, c, with_velocity=False)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"accel_f64": 10, "elm2f64_update_shift": 10}
    ops = _step_ops(lambda x: ms.elm2_step(tab, accel, 600.0, x, with_velocity=False), c0)
    assert "aten.cat" not in ops and "aten.copy_" not in ops, ops
    coef = cuda_elm2f64._plan(tab, 600.0).coef
    p = c0
    for _ in range(10):
        y, ys_new, dd_new = cuda_elm2f64.elm2f64_update_shift_plain(coef, p.ys, p.ddys)
        accel(p.t + 600.0, y, out=dd_new[0])
        p = ms.ELM2Carry(t=p.t + 600.0, ys=ys_new, ddys=dd_new, dy=p.dy)
    assert torch.equal(c.ys, p.ys) and torch.equal(c.ddys, p.ddys) and c.t == p.t


# -- kernel 3-f64 (the native-f64 3-limb pair force) and the 3-limb route ----------


@pytest.mark.parametrize("n", [1, 3, 32, 129, 1365, 4096])
def test_kernel3_f64_matches_plain_on_card(cuda_device, n):
    """Kernel 3-f64's square form against its plain version, the f64 and the
    pair outputs: bitwise (the plain version repeats its ops in its order,
    with CUDA's rsqrt); one launch a call; the pair is split_f64 of the f64
    force; one body feels no force."""
    pos, mu = _cloud(n, 47)
    limbs = ex.from_f64_host(pos, cuda_device)[:3]
    tm = torch.tensor(mu, device=cuda_device)
    before = (cuda_limbs64.pairwise_accel_limbs64.launches,
              cuda_limbs64.pairwise_accel_limbs64_pair.launches)
    k = cuda_limbs64.pairwise_accel_limbs64(*limbs, tm)
    kp = cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm)
    assert (cuda_limbs64.pairwise_accel_limbs64.launches,
            cuda_limbs64.pairwise_accel_limbs64_pair.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(k, cuda_limbs64.pairwise_accel_limbs64_plain(*limbs, tm))
    plain = cuda_limbs64.pairwise_accel_limbs64_pair_plain(*limbs, tm)
    split = cuda_nbody.split_f64(k)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(kp, plain, split))
    if n == 1:
        assert torch.equal(k, torch.zeros_like(k))


@pytest.mark.parametrize("n", [129, 1365, 4096])
def test_kernel3_f64_rows_on_card(cuda_device, n):
    """The rows form at several row0 equals the square form's row slice and
    its plain version bitwise; one launch a call."""
    pos, mu = _cloud(n, 48)
    limbs = ex.from_f64_host(pos, cuda_device)[:3]
    tm = torch.tensor(mu, device=cuda_device)
    src = [l.t().contiguous() for l in limbs]
    sq = cuda_limbs64.pairwise_accel_limbs64_pair(*limbs, tm)
    for r0, nl in ((0, n), (n // 4, n // 4), (n // 3 + 1, n - n // 3 - 1), (n - 1, 1)):
        recv = [l[r0:r0 + nl].contiguous() for l in limbs]
        before = cuda_limbs64.pairwise_accel_limbs64_rows.launches
        got = cuda_limbs64.pairwise_accel_limbs64_rows(*src, tm, *recv, r0)
        assert cuda_limbs64.pairwise_accel_limbs64_rows.launches == before + 1
        plain = cuda_limbs64.pairwise_accel_limbs64_rows_plain(*src, tm, *recv, r0)
        for g, s, p in zip(got, sq, plain):
            assert torch.equal(g, s[r0:r0 + nl]) and torch.equal(g, p)


def test_kernel3_f64_wrappers_check_inputs_on_card(cuda_device):
    """Wrong dtype, shape, layout or device raises before any launch."""
    pos, mu = _cloud(16, 49)
    l0, l1, l2 = ex.from_f64_host(pos, cuda_device)[:3]
    tm = torch.tensor(mu, device=cuda_device)
    src = [l.t().contiguous() for l in (l0, l1, l2)]
    fns = (cuda_limbs64.pairwise_accel_limbs64, cuda_limbs64.pairwise_accel_limbs64_pair,
           cuda_limbs64.pairwise_accel_limbs64_rows)
    before = [f.launches for f in fns]
    with pytest.raises(TypeError):
        cuda_limbs64.pairwise_accel_limbs64(l0.double(), l1, l2, tm)
    with pytest.raises(TypeError):
        cuda_limbs64.pairwise_accel_limbs64_pair(l0, l1, l2, tm.float())
    with pytest.raises(ValueError):
        cuda_limbs64.pairwise_accel_limbs64(l0, l1, l2[:8], tm)
    with pytest.raises(ValueError):
        cuda_limbs64.pairwise_accel_limbs64_pair(l0.t().contiguous().t(), l1, l2, tm)
    with pytest.raises(ValueError):
        cuda_limbs64.pairwise_accel_limbs64(l0, l1, l2, tm.cpu())
    with pytest.raises(ValueError):
        cuda_limbs64.pairwise_accel_limbs64_rows(*src, tm, l0[10:14], l1[10:14], l2[10:14], 14)
    assert [f.launches for f in fns] == before


def test_fused_step_takes_kernel3_f64_on_card(cuda_device):
    """The fused expansion step (elm2_step_qf) through the 3-limb route:
    kernel 3-f64's pair form and kernel 4 once a step, no kernel 3; the
    force written into the ring is the pair form's bitwise."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms

    pos, mu = _cloud(256, 50)
    vel = np.random.default_rng(50).normal(size=(256, 3))
    tm = torch.tensor(mu, device=cuda_device)
    mh, ml = cuda_nbody.split_f64(tm.reshape(1, -1))
    tab = get(QT12)

    def accel_pair(t, limbs):
        return cuda_limbs64.limbs_force_pair(*limbs, tm, mh, ml)

    def accel_limbs(t, limbs):
        return cuda_nbody.combine_f64(*accel_pair(t, limbs))

    c = ms.elm2_qf_from_q(ms.elm2_init_q(tab, None, 0.0, torch.tensor(pos, device=cuda_device),
                                         torch.tensor(vel, device=cuda_device), 600.0,
                                         accel_limbs=accel_limbs))
    before = _every_launch()
    for _ in range(5):
        c = ms.elm2_step_qf(tab, accel_pair, 600.0, c, precise_sums=True)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"accel_limbs3_f64_pair": 5, "elm2q_update": 5}
    force = cuda_limbs64.pairwise_accel_limbs64_pair(*(l[0] for l in c.ys[:3]), tm)
    assert torch.equal(c.dd.hi[0], force[0]) and torch.equal(c.dd.lo[0], force[1])


# -- kernel 13: the expansion step's update with its ring shifts ----------------


def _q_rings(order, m, seed, dev):
    rng = np.random.default_rng(seed)
    ys = ex.from_f64_host(rng.normal(size=(order, m)) * 1e8, dev)
    dd = torch.tensor(rng.normal(size=(order, m)) * 1e-6
                      * np.exp2(rng.integers(-20, 1, size=(order, m))), device=dev)
    return ys, dd


@pytest.mark.parametrize("precise", [True, False], ids=["precise", "plain"])
@pytest.mark.parametrize("m", [3, 96, 1001, 12288])
@pytest.mark.parametrize("method", [QT12, "Stormer13"])
def test_kernel13_matches_plain_on_card(cuda_device, method, m, precise):
    """Kernel 13 bitwise to its plain version on the card, both modes: the
    new limb rings whole and the force ring's moved rows, one launch."""
    tab = get(method)
    ys, dd = _q_rings(tab.order, m, m, cuda_device)
    before = cuda_elm2qs.elm2q_update_shift.launches
    y, ys_new, dd_new = cuda_elm2qs.elm2q_update_shift(tab, 600.0, ys, dd, precise)
    assert cuda_elm2qs.elm2q_update_shift.launches == before + 1
    py, pys, pdd = cuda_elm2qs.elm2q_update_shift_plain(cuda_elm2qs._plan(tab, 600.0, precise),
                                                        ys, dd)
    assert all(torch.equal(a, b) for a, b in zip(ys_new, pys))
    assert all(a.data_ptr() == b[0].data_ptr() for a, b in zip(y, ys_new))
    assert torch.equal(dd_new[1:], pdd[1:])


def test_kernel13_wrapper_checks_inputs_on_card(cuda_device):
    """The wrapper raises on what the kernel does not take: a non-contiguous
    or mistyped ring, a ring depth other than the method's order."""
    tab = get(QT12)
    ys, dd = _q_rings(tab.order, 96, 5, cuda_device)
    with pytest.raises(ValueError):
        cuda_elm2qs.elm2q_update_shift(tab, 600.0, ys, dd[:, ::2], True)
    with pytest.raises(TypeError):
        cuda_elm2qs.elm2q_update_shift(tab, 600.0, ys, dd.float(), True)
    with pytest.raises(ValueError):
        cuda_elm2qs.elm2q_update_shift(tab, 600.0, tuple(l[:-1] for l in ys), dd[:-1], True)


def _fss_q_carry(dev, precise_order=QT12):
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "full_solar_system_2433282.5")
    tab = get(precise_order)
    mu = torch.tensor(sc.state.mus(), device=dev)
    mh, ml = cuda_nbody.split_f64(mu.reshape(1, -1))

    @ms.writes_into
    def accel_limbs(t, limbs, out=None):
        return cuda_limbs64.limbs_force(*limbs, mu, mh, ml, out=out)

    c = ms.elm2_init_q(tab, None, 0.0, None, torch.tensor(sc.state.velocities(), device=dev),
                       600.0, accel_limbs=accel_limbs,
                       y0_limbs=ex.from_f64_host(sc.state.positions(), dev))
    return tab, accel_limbs, c


@pytest.mark.parametrize("method", [QT12, "Stormer13"])
def test_expansion_step_route_matches_eager_on_card(cuda_device, method):
    """200 steps of full_solar_system through the card's ``elm2_step_q``
    route (kernel 13, the force into the new ring row) bitwise to the eager
    step on the card with precise sums, every other step with the velocity.
    Without precise sums the eager step's f64 beta dot is torch's row sum,
    which on the card does not add in ring order: one step of each from the
    200th carry within the two orders' rounding bound, 2^-48 of the sum of
    |c_dy[j] ddy[j]| h^2/beta_d (over 200 steps the difference grows with
    the integration's own sensitivity: past 2^-60 of max |y| on Stormer13)."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms

    tab, accel_limbs, a = _fss_q_carry(cuda_device, method)
    b = a
    for i in range(200):
        a = ms.elm2_step_q(tab, None, 600.0, a, accel_limbs=accel_limbs,
                           with_velocity=i % 2 == 0, precise_sums=True)
        b = ms._step_q_cat(tab, None, 600.0, b, accel_limbs, i % 2 == 0, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a.ys, b.ys))
    assert torch.equal(a.ddys, b.ddys) and torch.equal(a.dy, b.dy)
    r = ms.elm2_step_q(tab, None, 600.0, a, accel_limbs=accel_limbs, with_velocity=False)
    e = ms._step_q_cat(tab, None, 600.0, a, accel_limbs, False, False)
    d = ex.to_f64(ex.add(tuple(l[0] for l in r.ys), ex.neg(tuple(l[0] for l in e.ys))))
    terms = ms._wsum(ms._coef(np.abs(tab.c_dy), a.ddys), a.ddys.abs()) * (600.0**2 / tab.beta_d)
    assert d.abs().max() <= 2.0**-48 * terms.max()


def test_expansion_step_is_two_launches_on_card(cuda_device):
    """An unperturbed expansion step on the card: kernel 13 once and the
    marked force (kernel 3-f64) once, writing the new ring row; nothing
    else launches."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms

    tab, accel_limbs, c = _fss_q_carry(cuda_device)
    before = _every_launch()
    for _ in range(10):
        c = ms.elm2_step_q(tab, None, 600.0, c, accel_limbs=accel_limbs, with_velocity=False,
                           precise_sums=True)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"elm2q_update_shift": 10, "accel_limbs3_f64": 10}
    mu = torch.tensor(scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                                       / "full_solar_system_2433282.5").state.mus(),
                      device=cuda_device)
    assert torch.equal(c.ddys[0], cuda_limbs64.pairwise_accel_limbs64(
        *(l[0] for l in c.ys[:3]), mu))


# kernel 14: the fleet loop.  Ships near Earth on sun_earth_moon, each
# tableau it has an instance for, with the burns that choose its RHS's form:
# TNB burns about Earth on every ship, inertial burns on the odd ships, a
# coast, and TNB burns on the odd ships.
FLEET_CASES = {"Verner87": "relative", "Verner98": "inertial", "DormandPrince54": "coast",
               "Fine45": "relative_odd", "CashKarp45": "relative", "Fehlberg45": "inertial",
               "Tsitouras75": "relative_odd", "DormandPrince87": "relative"}


def _fleet_inputs(b, burns, span_s, device, n_seg_burns=1):
    """(packed ephemeris on the card, stacked timelines, t0s, p0s, v0s,
    ends) of b ships in orbits near the Earth Station's, ``burns`` as in
    FLEET_CASES."""
    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.ftime import Duration, Epoch

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "sun_earth_moon_2433282.5")
    packed = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0),
                                    device=device).pack(device)
    base = sc.ships[0]
    t0 = base.start.as_offset_seconds()
    index = {"Sun": 0, "Earth": 1, "Moon": 2}
    tls = []
    for k in range(b):
        acc = np.array([2e-3, -1e-3, 5e-4]) * (1.0 + 0.01 * k)
        relative = burns == "relative" or (burns == "relative_odd" and k % 2)
        inertial = burns == "inertial" and k % 2
        ship_burns = [scene.ShipBurn(start=Epoch.from_offset_seconds(t0 + 1800.0 + 97.0 * k + j * 7200.0),
                                     duration=Duration.from_seconds(300.0), acceleration=acc,
                                     reference="Earth" if relative else None)
                      for j in range(n_seg_burns) if relative or inertial]
        tls.append(spacecraft.build_timeline(ship_burns, index))
    tl = spacecraft.stack_timelines(tls)
    k = np.arange(b)
    p0s = base.position[None] + np.stack([40.0 * k, -25.0 * k, 10.0 * k], -1)
    v0s = base.velocity[None] * (1.0 + 1e-4 * k)[:, None]
    return packed, tl, np.full(b, t0), p0s, v0s, t0 + span_s * (1.0 + 0.05 * (k % 3))


def _first_difference(a, b) -> str:
    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[:3].tolist()
            return f"{name} differs at {bad}"
    return ""


@pytest.mark.parametrize("b", [1, 4, 64])
@pytest.mark.parametrize("method", list(FLEET_CASES))
def test_kernel14_matches_plain_on_card(cuda_device, method, b):
    """Kernel 14 against its plain version, the eager fleet loop, on the
    card: ts, pos, vel, count, reason and final segment bitwise, at B = 1,
    4 and 64, the tableau's own instance taken;
    kernel 14 alone launched, once a host read."""
    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    packed, tl, t0s, p0s, v0s, ends = _fleet_inputs(b, FLEET_CASES[method], 6 * 3600.0,
                                                    cuda_device, n_seg_burns=2)
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
    tab = get(method)
    assert cuda_fleet.instances()[cuda_fleet.plan(tab, params, True, True).instance][0] == method
    before = _every_launch()
    spacecraft.propagate_batch.syncs = 0
    k = spacecraft.propagate_batch(tab, packed, tl, t0s, p0s, v0s, ends, params, max_knots=1024)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"fleet_scan": spacecraft.propagate_batch.syncs}
    p = spacecraft.propagate_batch_plain(tab, packed, tl, t0s, p0s, v0s, ends, params,
                                         max_knots=1024)
    assert (k.count > 10).all() and (k.reason == spacecraft.DONE_END).all()
    assert all(torch.equal(x, y) for x, y in zip(k, p)), _first_difference(k, p)


@pytest.mark.parametrize("method", ["DormandPrince54", "Fine45", "Verner87"])
def test_kernel14_across_launches_matches_plain_on_card(cuda_device, method, monkeypatch):
    """Five iterations a launch, so that the FSAL cache, the step sizes and
    an unfinished advance go through device memory between launches (two
    FSAL tableaux and Verner87): bitwise to the plain loop."""
    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    monkeypatch.setattr(cuda_fleet, "ITERATIONS_PER_LAUNCH", 5)
    packed, tl, t0s, p0s, v0s, ends = _fleet_inputs(4, FLEET_CASES[method], 6 * 3600.0,
                                                    cuda_device, n_seg_burns=2)
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
    tab = get(method)
    spacecraft.propagate_batch.syncs = 0
    k = spacecraft.propagate_batch(tab, packed, tl, t0s, p0s, v0s, ends, params, max_knots=1024)
    assert spacecraft.propagate_batch.syncs > 10
    p = spacecraft.propagate_batch_plain(tab, packed, tl, t0s, p0s, v0s, ends, params,
                                         max_knots=1024)
    assert all(torch.equal(x, y) for x, y in zip(k, p)), _first_difference(k, p)


def test_kernel14_single_ship_is_its_fleet_row_on_card(cuda_device):
    """A ship flown alone through kernel 14 is its row of the fleet bitwise
    (the same batch flags: every ship burns about Earth), and the fleet's
    short knot buffer ends a ship as DONE_KNOTS_FULL as the plain loop
    does."""
    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    packed, tl, t0s, p0s, v0s, ends = _fleet_inputs(4, "relative", 6 * 3600.0, cuda_device)
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
    tab = get("Verner87")
    fleet = spacecraft.propagate_batch(tab, packed, tl, t0s, p0s, v0s, ends, params,
                                       max_knots=1024)
    for i in (0, 3):
        solo = spacecraft.propagate_batch(tab, packed, spacecraft.Timeline(*(x[i:i + 1] for x in tl)),
                                          t0s[i:i + 1], p0s[i:i + 1], v0s[i:i + 1], ends[i:i + 1],
                                          params, max_knots=1024)
        assert all(torch.equal(x[i], y[0]) for x, y in zip(fleet, solo))
    short = spacecraft.propagate_batch(tab, packed, tl, t0s, p0s, v0s, ends, params, max_knots=16)
    plain = spacecraft.propagate_batch_plain(tab, packed, tl, t0s, p0s, v0s, ends, params,
                                             max_knots=16)
    assert (short.reason == spacecraft.DONE_KNOTS_FULL).all()
    assert all(torch.equal(x, y) for x, y in zip(short, plain)), _first_difference(short, plain)


def _leo_inputs(e, t0, b, span_s, burn_end=None):
    """(stacked timelines, t0s, p0s, v0s, ends) of b ships in 7,000 km orbits
    about the Earth of ephemeris ``e`` at ``t0``, each with two 300 s TNB
    burns about the Earth (the first ending at ``burn_end`` where given)."""
    from ephemeris_explorer_tpu_torch import spacecraft
    from ephemeris_explorer_tpu_torch.ftime import Duration, Epoch

    index = {n: i for i, n in enumerate(e.names)}
    ep, ev = e["Earth"].state_vector(t0)
    v_circ = float(np.sqrt(float(e.mus[index["Earth"]]) / 7000.0))
    tls = []
    for k in range(b):
        starts = [t0 + 1800.0 + 97.0 * k + j * 7200.0 for j in range(2)]
        if burn_end is not None:
            starts[0] = burn_end - 300.0
        tls.append(spacecraft.build_timeline(
            [scene.ShipBurn(start=Epoch.from_offset_seconds(st), duration=Duration.from_seconds(300.0),
                            acceleration=np.array([2e-3, -1e-3, 5e-4]) * (1.0 + 0.01 * k),
                            reference="Earth") for st in starts], index))
    k = np.arange(b)
    p0s = ep[None] + np.stack([7000.0 + 40.0 * k, -25.0 * k, 10.0 * k], -1)
    v0s = ev[None] + np.stack([0.0 * k, v_circ * (1.0 + 1e-4 * k), 0.0 * k], -1)
    return spacecraft.stack_timelines(tls), np.full(b, t0), p0s, v0s, t0 + span_s * (1.0 + 0.05 * (k % 3))


def _sem_on_card(device):
    """sun_earth_moon's 40 days generated on the card: (ephemeris, packed)."""
    from ephemeris_explorer_tpu_torch.ftime import Duration

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "sun_earth_moon_2433282.5")
    e = eph.generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0), device=device)
    return e, e.pack(device)


def _with_dust(packed, n_bodies):
    """``packed`` with bodies up to ``n_bodies``: copies of its bodies'
    tables at 1e-9 of their mu."""
    n = packed.mus.shape[0]
    idx = torch.arange(n_bodies - n, device=packed.mus.device) % n
    return eph.PackedEphemeris(
        mus=torch.cat([packed.mus, packed.mus[idx] * 1e-9]),
        **{k: torch.cat([getattr(packed, k), getattr(packed, k)[idx]])
           for k in ("starts", "intervals", "offsets", "nsegs")},
        coeffs=packed.coeffs)


def _kernel14_vs_plain(method, packed, inputs, params, max_knots=1024):
    """Kernel 14 and the plain loop on one batch, checked bitwise, kernel 14
    alone launched once a host read: (kernel 14's result, its iterations)."""
    from ephemeris_explorer_tpu_torch import spacecraft

    tab = get(method)
    before = _every_launch()
    spacecraft.propagate_batch.syncs = spacecraft.propagate_batch.iterations = 0
    k = spacecraft.propagate_batch(tab, packed, *inputs, params, max_knots=max_knots)
    torch.cuda.synchronize()
    iterations = spacecraft.propagate_batch.iterations
    assert _new_launches(before) == {"fleet_scan": spacecraft.propagate_batch.syncs}
    p = spacecraft.propagate_batch_plain(tab, packed, *inputs, params, max_knots=max_knots)
    assert all(torch.equal(x, y) for x, y in zip(k, p)), _first_difference(k, p)
    return k, iterations


@pytest.mark.parametrize("method", ["Verner87", "Fine45"])
def test_kernel14_straddles_segment_boundaries_on_card(cuda_device, method):
    """Ships whose attempts cross the Moon's first segment boundary, a TNB
    burn ending exactly on it (so a knot, and the next attempt's stage 0,
    fall on it): kernel 14 bitwise to the plain loop."""
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    e, packed = _sem_on_card(cuda_device)
    t_b = float(packed.starts[2] + packed.intervals[2])
    k, _ = _kernel14_vs_plain(method, packed, _leo_inputs(e, t_b - 1800.0, 4, 2 * 3600.0, t_b),
                           AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3))
    ts = k.ts[torch.isfinite(k.ts)]
    assert (ts < t_b).any() and (ts == t_b).any() and (ts > t_b).any()


@pytest.mark.parametrize("n_bodies", [33, 65])
def test_kernel14_several_bodies_a_lane_on_card(cuda_device, n_bodies):
    """33 and 65 bodies (two and three a lane: sun_earth_moon and dust
    bodies): kernel 14 bitwise to the plain loop."""
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    e, packed = _sem_on_card(cuda_device)
    t0 = float(packed.starts.max())
    k, _ = _kernel14_vs_plain("Verner87", _with_dust(packed, n_bodies),
                           _leo_inputs(e, t0, 4, 2 * 3600.0),
                           AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3))
    assert (k.count > 10).all()


def test_kernel14_tight_tolerance_on_card(cuda_device):
    """A tight tolerance with a slow shrink (fac_min 0.98), where most
    attempts fail: kernel 14 bitwise to the plain loop."""
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    e, packed = _sem_on_card(cuda_device)
    k, iterations = _kernel14_vs_plain(
        "Verner87", packed, _leo_inputs(e, float(packed.starts.max()), 1, 6 * 3600.0),
        AdaptiveParams(h_init=600.0, tol_pos=1e-10, tol_vel=1e-10, fac_min=0.98))
    assert int(k.count[0]) * 2 < iterations


@pytest.mark.parametrize("n_bodies,method", [(600, "Verner98"), (9500, "Verner87"),
                                              (9500, "Fine45")])
def test_kernel14_windows_past_shared_memory_on_card(cuda_device, n_bodies, method):
    """Bodies that do not fit one window of shared memory (~9,400 positions
    a block on an H100): 600 bodies at 16 stages (windows of 15 stages),
    and 9,500 bodies (past one stage a window: one stage in chunks of
    bodies): kernel 14 bitwise to the plain loop."""
    from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams

    e, packed = _sem_on_card(cuda_device)
    k, _ = _kernel14_vs_plain(method, _with_dust(packed, n_bodies),
                              _leo_inputs(e, float(packed.starts.max()), 4, 3600.0),
                              AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3))
    assert (k.count > 10).all()


# -- kernel 13-chunk: the expansion generation chunk in one kernel ----------------


def _genq_inputs(dev, scene_name, n_cluster=None):
    """(mu, dt, expansion carry from elm2_init_q with the f64 force) of a
    scene, or of a seeded cloud of ``n_cluster`` bodies."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody

    if n_cluster is None:
        sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems" / scene_name)
        pos, vel, mu, dt = (sc.state.positions(), sc.state.velocities(), sc.state.mus(),
                            sc.settings.dt.as_seconds())
    else:
        pos, mu = _cloud(n_cluster, 44)
        vel, dt = np.random.default_rng(45).normal(size=(n_cluster, 3)), 600.0
    mu = torch.tensor(mu, device=dev)

    def carry(method, h):
        return ms.elm2_init_q(get(method), lambda t, y: nbody.pairwise_accel(y, mu), 0.0,
                              torch.tensor(pos, device=dev), torch.tensor(vel, device=dev), h,
                              y0_limbs=ex.from_f64_host(pos, dev))

    return mu, dt, carry


def _genq_route(tab, h, c, mu, force, precise, steps):
    """``steps`` steps of the two-launch route (kernel 13, then kernel 3-f64's
    f64 form or kernel 12 into the new ring row): emitted heads and carry."""
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms
    from ephemeris_explorer_tpu_torch.ops import nbody_full3

    kernel = {"extended3": cuda_limbs64.pairwise_accel_limbs64,
              "extendedF": nbody_full3.pairwise_accel_full3}[force]

    @ms.writes_into
    def accel_limbs(t, limbs, out=None):
        return kernel(*limbs, mu, out=out)

    heads = []
    for _ in range(steps):
        c = ms._step_q_shift(tab, None, h, c, accel_limbs, False, precise)
        heads.append(ex.to_f64(tuple(l[0] for l in c.ys)))
    return torch.stack(heads), c


def _same_q(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a.ys, b.ys)) and torch.equal(a.ddys, b.ddys)
            and a.t == b.t)


@pytest.mark.parametrize("precise", [True, False], ids=["precise", "plain"])
@pytest.mark.parametrize("force", ["extended3", "extendedF"])
@pytest.mark.parametrize("direction", [1, -1], ids=["forward", "backward"])
@pytest.mark.parametrize("method", [QT12, "Stormer13"])
def test_kernel13_chunk_matches_plain_and_route_on_card(cuda_device, method, direction, force,
                                                        precise):
    """Kernel 13-chunk on full_solar_system: one launch; bitwise to its
    plain version over 6 steps and to the two-launch route (kernel 13 then
    the force) over 96 steps: emitted rows and carry."""
    mu, dt, carry = _genq_inputs(cuda_device, "full_solar_system_2433282.5")
    tab, h = get(method), dt * direction
    c0 = carry(method, h)
    before = _every_launch()
    ys, c = cuda_genq.elm2_gen_scan_q(tab, h, c0, mu, 96, force, precise)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"gen_scan_q": 1}
    ys_r, c_r = _genq_route(tab, h, c0, mu, force, precise, 96)
    assert torch.equal(ys, ys_r) and _same_q(c, c_r)
    ys6, c6 = cuda_genq.elm2_gen_scan_q(tab, h, c0, mu, 6, force, precise)
    ys_p, c_p = cuda_genq.elm2_gen_scan_q_plain(tab, h, c0, mu, 6, force, precise)
    assert torch.equal(ys6, ys_p) and _same_q(c6, c_p)
    assert torch.equal(ys6, ys[:6])


@pytest.mark.parametrize("force", ["extended3", "extendedF"])
@pytest.mark.parametrize("n", [3, 65, cuda_genq.MAX_BODIES_Q])
def test_kernel13_chunk_sizes_on_card(cuda_device, n, force):
    """Kernel 13-chunk on seeded clouds: N = 3 (one tile), 65 (two of kernel
    3-f64's splits) and the cap (one receiver row of terms at a time),
    bitwise to the two-launch route over 12 steps."""
    mu, dt, carry = _genq_inputs(cuda_device, None, n)
    tab = get(QT12)
    c0 = carry(QT12, dt)
    ys, c = cuda_genq.elm2_gen_scan_q(tab, dt, c0, mu, 12, force, True)
    ys_r, c_r = _genq_route(tab, dt, c0, mu, force, True, 12)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys_r) and _same_q(c, c_r)


def test_kernel13_chunk_wrapper_checks_on_card(cuda_device):
    """The library's cap is the wrapper's and its split tile kernel
    3-f64's; above the cap, for another force or for a tableau the kernel
    is not built for the wrapper raises; zero steps return the carry and
    launch nothing."""
    from ephemeris_explorer_tpu_torch import _build
    from ephemeris_explorer_tpu_torch.integrators import multistep as ms

    assert _build.library().eet_gen_scan_q_max_bodies() == cuda_genq.MAX_BODIES_Q
    assert _build.library().eet_gen_scan_q_src_tile() == cuda_nbody64.F64_PAIR_TILE
    mu, dt, carry = _genq_inputs(cuda_device, "sun_earth_moon_2433282.5")
    tab = get(QT12)
    c0 = carry(QT12, dt)
    before = _every_launch()
    ys, c = cuda_genq.elm2_gen_scan_q(tab, dt, c0, mu, 0, "extended3", True)
    assert tuple(ys.shape) == (0, 3, 3) and c is c0 and _new_launches(before) == {}
    with pytest.raises(ValueError, match="force"):
        cuda_genq.elm2_gen_scan_q(tab, dt, c0, mu, 4, "extended", True)
    n = cuda_genq.MAX_BODIES_Q + 1
    z = torch.zeros((12, n, 3), dtype=torch.float32, device=cuda_device)
    big = ms.ELM2CarryQ(t=0.0, ys=(z,) * 4, ddys=z.double(), dy=z[0].double())
    with pytest.raises(ValueError, match=f"at most {cuda_genq.MAX_BODIES_Q}"):
        cuda_genq.elm2_gen_scan_q(tab, dt, big, torch.ones(n, dtype=torch.float64,
                                                           device=cuda_device), 4, "extended3",
                                  True)
