"""The force-mode ladder (kernels 5-9) against the JAX package's.

Kernel 5 (f32), kernel 6 (mixed), kernel 7 (masked f32, the split mode's
weak tail), kernel 8 (the two-float strong-pair correction) and kernel 9
(the same correction on the f64-differenced feed, ``corr="dd"``) run as
their plain versions here (CPU tensors); the JAX side runs its Pallas kernels in
interpret mode with 8 x 8 tiles, as ``tests/test_pallas_nbody.py`` does.
Inputs come from numpy with a seed, and one strong set (``interop.
strong_set_from``) feeds both packages.  The reference's own bars for the
modes are held against the port.  The kernel-against-plain cases on the
card are in ``test_torch_cuda.py``.

Tolerances.  Kernels 5-7 sum f32 terms in another order than the Pallas
kernels (and torch's f32 rsqrt seed differs from XLA:CPU's by an ulp in a
third of the inputs), so they are held to 1e-6 of max |a|.  Kernel 8's
chain and tree are the reference's, but the same seed difference moves a
pair's two-float weight by ~2^-48, so it is held to 1e-14 of max |c|; the
tree itself, and kernel 8's lane order, are checked bitwise, and its
production f64 form bitwise against the route it replaced.  Kernel 9 is
held the same way: 1e-14 of max |c| against the Pallas kernel, its feed
and padding bitwise.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.ops import eft as jeft
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops import pallas_nbody as jp
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.ops import cuda_f32, cuda_mixed, cuda_nbody, cuda_split, eft
from ephemeris_explorer_tpu_torch.ops import nbody, split
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat

REPO = Path(__file__).resolve().parent.parent
TILES = dict(interpret=True, tile_rows=8, tile_cols=8)
F32_VS_PALLAS = 1e-6        # kernels 5-7, of max |a|
STRONG_VS_PALLAS = 1e-14    # kernel 8, of max |c|


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.0e6, rng.uniform(1.0e3, 1.0e5, size=n)


def _hierarchy(n=16, seed=7):
    """tests/test_pallas_nbody.py:_hierarchy: a sun, 3 planets with close
    moon pairs, light far bodies."""
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


def _close_pair():
    """test_mixed_mode_error_envelope's input: a Phobos-Mars-like pair at
    ~5e-5 of the position scale beside a heavy primary."""
    rng = np.random.default_rng(29)
    pos = rng.normal(size=(16, 3)) * 1.0e6
    pos[1] = pos[0] + np.array([40.1234567, 19.7654321, -9.87654321])
    mu = rng.uniform(1.0e3, 1.0e5, size=16)
    mu[0] = 1.0e7
    return pos, mu


INPUTS = {"cloud64": lambda: _cloud(64, 21), "hierarchy": _hierarchy, "close_pair": _close_pair}


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _rel_rows(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.linalg.norm(a - ref, axis=1) / np.linalg.norm(ref, axis=1)


def _f32(pos, mu):
    return (torch.tensor(pos.astype(np.float32)),
            torch.tensor(mu.astype(np.float32).reshape(1, -1)))


def _strong_set(pos, mu, k):
    """The JAX package's strong set, and the same as the port's tensors."""
    idx = jp.strong_pair_indices(jnp.asarray(pos), jnp.asarray(mu), k=k)
    mask = jp.strong_pair_mask(idx, len(pos))
    return (idx, mask), interop.strong_set_from(idx, mask)


# -- kernel 5 -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["cloud64", "hierarchy", "close_pair"])
def test_kernel5_plain_matches_pallas(case):
    pos, mu = INPUTS[case]()
    p32, m32 = _f32(pos, mu)
    before = cuda_f32.pairwise_accel_f32.launches
    port = cuda_f32.pairwise_accel_f32(p32, m32).numpy()
    assert cuda_f32.pairwise_accel_f32.launches == before  # CPU: plain version
    ref = jp.pairwise_accel_f32(jnp.asarray(p32.numpy()), jnp.asarray(m32.numpy()), **TILES)
    assert port.dtype == np.float32 and port.shape == (len(pos), 3)
    assert _rel(port, ref) <= F32_VS_PALLAS


def test_f32_fast_mode_error_envelope():
    """test_f32_fast_mode_error_envelope's bars, on the port: within 1e-5 of
    the two-float force (kernel 1's plain version), and above 1e-9 (it is
    single precision)."""
    pos, mu = _cloud(64, 21)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    ref = cuda_nbody.pairwise_accel(torch.tensor(pos), mh, ml).numpy()
    fast = cuda_f32.pairwise_accel_f32(*_f32(pos, mu)).numpy()
    assert 1e-9 < _rel(fast, ref) < 1e-5


# -- kernel 6 -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["cloud64", "hierarchy", "close_pair"])
def test_kernel6_plain_matches_pallas(case):
    pos, mu = INPUTS[case]()
    m32 = mu.astype(np.float32).reshape(1, -1)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    before = cuda_mixed.pairwise_accel_mixed.launches
    port = cuda_mixed.pairwise_accel_mixed(ph, pl, torch.tensor(m32)).numpy()
    assert cuda_mixed.pairwise_accel_mixed.launches == before
    jph, jpl = jp.split_f64(jnp.asarray(pos), transpose=True)
    ref = jp.pairwise_accel_mixed(jph, jpl, jnp.asarray(m32), **TILES)
    assert _rel(port, ref) <= F32_VS_PALLAS


def test_mixed_mode_error_envelope():
    """test_mixed_mode_error_envelope's bars, on the port: the mixed force is
    within 3e-6 per body of the two-float force on the close pair, where the
    f32 force is more than 30x worse on the pair's body, and above 1e-9."""
    pos, mu = _close_pair()
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    ref = cuda_nbody.pairwise_accel(torch.tensor(pos), mh, ml).numpy()
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    m32 = torch.tensor(mu.astype(np.float32).reshape(1, -1))
    rel_mixed = _rel_rows(cuda_mixed.pairwise_accel_mixed(ph, pl, m32), ref)
    rel_fast = _rel_rows(cuda_f32.pairwise_accel_f32(*_f32(pos, mu)), ref)
    assert rel_mixed.max() < 3e-6
    assert rel_fast[1] > 30 * rel_mixed[1]
    assert rel_mixed.max() > 1e-9


# -- kernel 7 -----------------------------------------------------------------

@pytest.mark.parametrize("diag_in_mask", [False, True])
@pytest.mark.parametrize("case, k", [("cloud64", 8), ("hierarchy", 6)])
def test_kernel7_plain_matches_pallas(case, k, diag_in_mask):
    pos, mu = INPUTS[case]()
    (_, jmask), (_, mask) = _strong_set(pos, mu, k)
    p32, m32 = _f32(pos, mu)
    before = cuda_f32.pairwise_accel_f32_masked.launches
    port = cuda_f32.pairwise_accel_f32_masked(p32, m32, mask, diag_in_mask=diag_in_mask)
    assert cuda_f32.pairwise_accel_f32_masked.launches == before
    ref = jp.pairwise_accel_f32_masked(jnp.asarray(p32.numpy()), jnp.asarray(m32.numpy()),
                                       jmask, diag_in_mask=diag_in_mask, **TILES)
    assert _rel(port, ref) <= F32_VS_PALLAS


def test_kernel7_self_compare_without_diagonal():
    """Without diag_in_mask the self pair is skipped by index: a mask with
    only the strong pairs gives the same force as one that also holds the
    diagonal."""
    pos, mu = _cloud(32, 4)
    p32, m32 = _f32(pos, mu)
    idx = split.strong_pair_indices(torch.tensor(pos), torch.tensor(mu), k=4)
    with_diag = split.strong_pair_mask(idx, 32)
    without = with_diag.clone()
    without.fill_diagonal_(0)
    a = cuda_f32.pairwise_accel_f32_masked(p32, m32, without)
    b = cuda_f32.pairwise_accel_f32_masked(p32, m32, with_diag, diag_in_mask=True)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_kernel7_rows_plain_matches_pallas():
    pos, mu = _cloud(32, 5)
    (jidx, jmask), (_, mask) = _strong_set(pos, mu, 4)
    p32, m32 = _f32(pos, mu)
    for r0 in (0, 8, 24):
        port = cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask[r0:r0 + 8], p32[r0:r0 + 8])
        ref = jp.pairwise_accel_f32_masked_rows(
            jnp.asarray(p32.numpy()), jnp.asarray(m32.numpy()), jmask[r0:r0 + 8],
            jnp.asarray(p32.numpy()[r0:r0 + 8]), **TILES)
        assert _rel(port, ref) <= F32_VS_PALLAS


# -- kernel 8 -----------------------------------------------------------------

@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8), ("cloud64", 5),
                                     ("cloud64", 16)])
def test_kernel8_plain_matches_pallas(case, k):
    """K = 6 and 5 pad to KP = 8 in front; K = 8 and 16 need no padding."""
    pos, mu = INPUTS[case]()
    (jidx, _), (idx, _) = _strong_set(pos, mu, k)
    before = cuda_split.strong_correction_pair.launches
    port = cuda_split._strong_correction_fast(torch.tensor(pos), torch.tensor(mu), idx).numpy()
    assert cuda_split.strong_correction_pair.launches == before
    ref = jp._strong_correction_fast(jnp.asarray(pos), jnp.asarray(mu), jidx, interpret=True)
    assert port.dtype == np.float64
    assert _rel(port, ref) <= STRONG_VS_PALLAS


def _random_pairs(rng, shape):
    a = torch.tensor(rng.normal(size=shape).astype(np.float32))
    b = torch.tensor((rng.normal(size=shape) * 1e-9).astype(np.float32))
    return TwoFloat(*eft.two_sum(a, b))


@pytest.mark.parametrize("kp", [1, 2, 8, 32])
def test_dd_tree_sum_matches_reference(kp):
    """The plain version's tree is the reference's `_dd_tree_sum`, bitwise
    (both run op by op, eagerly)."""
    x = _random_pairs(np.random.default_rng(kp), (5, kp))
    got = cuda_split._dd_tree_sum(x)
    with jax.disable_jit():
        ref = jp._dd_tree_sum(jeft.TwoFloat(jnp.asarray(x.hi.numpy()), jnp.asarray(x.lo.numpy())),
                              axis=-1)
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(ref.hi)[:, 0])
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(ref.lo)[:, 0])


@pytest.mark.parametrize("kp, k", [(8, 8), (8, 5), (16, 9), (32, 17), (1, 1)])
def test_kernel8_stack_order_is_the_reference_tree(kp, k):
    """Kernel 8's summation order, run here in Python: the leaves in
    bit-reversed order through a stack of partial sums (merging ctz(t + 1)
    times after leaf t), the KP - K padding leaves as exact zeros, gives the
    reference's tree over the leaves with the padding in front bitwise, even
    where the reference's padding terms are signed zeros."""
    rng = np.random.default_rng(kp + k)
    leaves = _random_pairs(rng, (7, kp))
    sign = torch.tensor(np.where(rng.uniform(size=(7, kp)) < 0.5, -1.0, 1.0).astype(np.float32))
    pad = kp - k
    hi = torch.cat([torch.zeros(7, pad) * sign[:, :pad], leaves.hi[:, pad:]], 1)
    lo = torch.cat([torch.zeros(7, pad) * sign[:, :pad], leaves.lo[:, pad:]], 1)
    ref = cuda_split._dd_tree_sum(TwoFloat(hi, lo))

    bits = kp.bit_length() - 1
    stack = []
    for t in range(kp):
        leaf = int(format(t, f"0{bits}b")[::-1], 2) if bits else 0
        zero = torch.zeros(7)
        stack.append(TwoFloat(zero, zero) if leaf < pad else TwoFloat(hi[:, leaf], lo[:, leaf]))
        m = t + 1
        while m % 2 == 0:
            top = stack.pop()
            stack.append(eft.add_sloppy(stack.pop(), top))
            m //= 2
    assert len(stack) == 1
    assert torch.equal(stack[0].hi, ref.hi) and torch.equal(stack[0].lo, ref.lo)


def test_kernel8_plain_rejects_out_of_range_index():
    """The plain version raises on an index outside [0, N) (the kernel gives
    NaN for that receiver instead, test_torch_cuda.py)."""
    pos, mu = _cloud(16, 13)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos))
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu))
    idx = split.strong_pair_indices(torch.tensor(pos), torch.tensor(mu), k=4)
    for bad in (16, -1):
        wrong = idx.clone()
        wrong[2, 1] = bad
        with pytest.raises(IndexError):
            cuda_split.strong_correction_pair(ph, pl, ph, pl, mh, ml, wrong)


def test_kernel8_padding_adds_exact_zero():
    """A padding entry (mu = 0, position 0, so d = -p_i) contributes a
    two-float zero: K = 3 (KP = 4, one padding entry) equals the three
    real terms' sum with an exact zero in its place."""
    pos, mu = _cloud(16, 12)
    idx = split.strong_pair_indices(torch.tensor(pos), torch.tensor(mu), k=3)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos))
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu))
    got = cuda_split.strong_correction_pair_plain(ph, pl, ph, pl, mh, ml, idx)
    # the same terms, one source at a time (K = 1 has no padding, no tree)
    terms = [cuda_split.strong_correction_pair_plain(ph, pl, ph, pl, mh, ml, idx[:, j:j + 1])
             for j in range(3)]
    zero = torch.zeros_like(terms[0][0])
    first = eft.add_sloppy(TwoFloat(zero, zero), TwoFloat(*terms[1]))
    second = eft.add_sloppy(TwoFloat(*terms[0]), TwoFloat(*terms[2]))
    want = eft.add_sloppy(first, second)
    assert torch.equal(got[0], want.hi) and torch.equal(got[1], want.lo)


@pytest.mark.parametrize("kp", [1, 2, 4, 8, 16, 32, 64, 128])
def test_kernel8_lane_order_is_the_reference_tree(kp):
    """Kernel 8's lane order, run here in Python: lane s of a segment of
    L = min(KP, 32) lanes holds leaves s + L j and adds them in-lane for the
    tree's levels m >= L (its KP / L leaves in bit-reversed order through a
    stack); then each level m < L is a shuffle down by m within the segment
    (lane s reads lane s + m, or its own value past the segment), the lower
    lane's value the first operand; the KP - K padding leaves are exact
    zeros.  Lane 0's sum is the reference's tree over the leaves with the
    padding in front bitwise, even where its padding terms are signed zeros."""
    k = kp // 2 + 1 if kp > 1 else 1
    rng = np.random.default_rng(100 + kp)
    leaves = _random_pairs(rng, (7, kp))
    sign = torch.tensor(np.where(rng.uniform(size=(7, kp)) < 0.5, -1.0, 1.0).astype(np.float32))
    pad = kp - k
    hi = torch.cat([torch.zeros(7, pad) * sign[:, :pad], leaves.hi[:, pad:]], 1)
    lo = torch.cat([torch.zeros(7, pad) * sign[:, :pad], leaves.lo[:, pad:]], 1)
    ref = cuda_split._dd_tree_sum(TwoFloat(hi, lo))

    seg = min(kp, 32)
    per_lane = kp // seg
    bits = per_lane.bit_length() - 1
    zero = torch.zeros(7)
    lanes = []
    for s in range(seg):
        stack = []
        for t in range(per_lane):
            j = int(format(t, f"0{bits}b")[::-1], 2) if bits else 0
            leaf = s + seg * j
            stack.append(TwoFloat(zero, zero) if leaf < pad else TwoFloat(hi[:, leaf], lo[:, leaf]))
            m = t + 1
            while m % 2 == 0:
                top = stack.pop()
                stack.append(eft.add_sloppy(stack.pop(), top))
                m //= 2
        assert len(stack) == 1
        lanes.append(stack[0])
    m = seg // 2
    while m >= 1:
        lanes = [eft.add_sloppy(lanes[s], lanes[s + m] if s + m < seg else lanes[s])
                 for s in range(seg)]
        m //= 2
    assert torch.equal(lanes[0].hi, ref.hi) and torch.equal(lanes[0].lo, ref.lo)


def _fused_case(case, k):
    """f64 positions and mu, a strong set of K, and kernel 7's plain weak
    tail: the hierarchy and the cloud at 64 bodies."""
    pos, mu = _hierarchy(n=64) if case == "hierarchy64" else _cloud(64, 31)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=k)
    mask = split.strong_pair_mask(idx, 64)
    a32 = cuda_f32.pairwise_accel_f32_masked_plain(*_f32(pos, mu), mask, diag_in_mask=True)
    return tp, tm, idx, mask, a32


@pytest.mark.parametrize("form", ["square", "rows"])
@pytest.mark.parametrize("k", [6, 16, 40])
@pytest.mark.parametrize("case", ["hierarchy64", "cloud64"])
def test_kernel8_fused_plain_is_the_composed_route(case, k, form):
    """Kernel 8's production form (f64 in, split in place, the f64 sum with
    a32 added) is the route it replaces, bitwise: combine_f64 of the
    limb-fed correction on split_f64's limbs, plus a32 in f64; without a32
    the combine alone.  So pairwise_accel_split and _rows keep their bits."""
    tp, tm, idx, mask, a32 = _fused_case(case, k)
    r0 = 0 if form == "square" else 64 // 3
    rows = None if form == "square" else tp[r0:]
    idx_r, a32_r = idx[r0:].contiguous(), a32[r0:].contiguous()
    ph, pl = cuda_nbody.split_f64(tp)
    rh, rl = cuda_nbody.split_f64(tp[r0:])
    mh, ml = cuda_nbody.split_f64(tm)
    combined = cuda_nbody.combine_f64(
        *cuda_split.strong_correction_pair_plain(ph, pl, rh, rl, mh, ml, idx_r))
    got = cuda_split.strong_correction_fused_plain(tp, tm, idx_r, rows, a32_r)
    assert got.dtype == torch.float64 and got.shape == (64 - r0, 3)
    assert torch.equal(got, combined + a32_r.double())
    assert torch.equal(cuda_split.strong_correction_fused_plain(tp, tm, idx_r, rows), combined)
    if form == "square":
        split_force = cuda_split.pairwise_accel_split(tp, tm, idx, mask)
    else:
        split_force = cuda_split.pairwise_accel_split_rows(tp, rows, tm, idx_r,
                                                           mask[r0:].contiguous())
    assert torch.equal(split_force, combined + a32_r.double())


@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8)])
def test_split_rows_match_pallas(case, k):
    """The rows forms against the JAX package's, from one strong set: the
    correction against ``_strong_correction_fast(interpret=True, rows=)``,
    <= 1e-14 of max |c|; ``pairwise_accel_split_rows`` against
    ``pairwise_accel_split_rows``, 1e-6 of max |a|, and inside the mode's
    envelopes against native f64 (2e-9 per body on the hierarchy, 4e-7 on
    the cloud)."""
    pos, mu = INPUTS[case]()
    r0 = len(pos) // 2
    (jidx, jmask), (idx, mask) = _strong_set(pos, mu, k)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    jrows = jnp.asarray(pos[r0:])
    corr = cuda_split._strong_correction_fast(tp, tm, idx[r0:], rows=tp[r0:]).numpy()
    ref = jp._strong_correction_fast(jnp.asarray(pos), jnp.asarray(mu), jidx[r0:],
                                     interpret=True, rows=jrows)
    assert _rel(corr, ref) <= STRONG_VS_PALLAS
    port = cuda_split.pairwise_accel_split_rows(tp, tp[r0:], tm, idx[r0:].contiguous(),
                                                mask[r0:].contiguous())
    ref = jp.pairwise_accel_split_rows(jnp.asarray(pos), jrows, jnp.asarray(mu), jidx[r0:],
                                       jmask[r0:], **TILES)
    assert _rel(port, ref) <= F32_VS_PALLAS
    envelope = {"hierarchy": 2e-9, "cloud64": 4e-7}[case]
    assert _rel_rows(port, _dense_f64(pos, mu)[r0:]).max() < envelope


# -- the split mode, composed ------------------------------------------------

def _dense_f64(pos, mu):
    return np.asarray(jnbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))


def test_split_mode_exact_when_all_strong():
    """test_split_mode_exact_when_all_strong's bars: K = N - 1 masks every
    pair out of kernel 7, so the mode is its correction alone: < 1e-14 per
    body with the f64 correction, < 1e-12 with the two-float one."""
    rng = np.random.default_rng(3)
    n = 16
    pos, mu = rng.normal(size=(n, 3)) * 1e6, rng.uniform(1e3, 1e5, size=n)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=n - 1)
    mask = split.strong_pair_mask(idx, n)
    ref = _dense_f64(pos, mu)
    exact = cuda_split.pairwise_accel_split(tp, tm, idx, mask, exact_f64=True)
    assert _rel_rows(exact, ref).max() < 1e-14
    assert _rel_rows(cuda_split.pairwise_accel_split(tp, tm, idx, mask), ref).max() < 1e-12


def test_strong_correction_fast_matches_f64():
    """test_strong_correction_fast_matches_f64's upper bar (5e-12 per body
    against the f64 correction on the hierarchy, K = 6); its lower bound is
    not a property of the correction and is not held."""
    pos, mu = _hierarchy()
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=6)
    got = cuda_split._strong_correction_fast(tp, tm, idx)
    assert _rel_rows(got, split._strong_correction(tp, tm, idx)).max() < 5e-12


def test_split_mode_hierarchy_envelope():
    """test_split_mode_hierarchy_envelope's bars: < 2e-9 per body on the
    hierarchy (K = 6), the f32 force > 1e3x worse, and > 1e-12 (an f32
    tail)."""
    pos, mu = _hierarchy()
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=6)
    ref = _dense_f64(pos, mu)
    got = _rel_rows(cuda_split.pairwise_accel_split(tp, tm, idx, split.strong_pair_mask(idx, 16)),
                    ref)
    plain = _rel_rows(cuda_f32.pairwise_accel_f32(*_f32(pos, mu)), ref)
    assert 1e-12 < got.max() < 2e-9
    assert plain.max() > 1e3 * got.max()


def test_split_mode_random_cloud_envelope():
    """test_split_mode_random_cloud_envelope's bars: < 4e-7 per body on a
    64-body cloud (K = 8), and below the f32 force's error."""
    rng = np.random.default_rng(11)
    pos, mu = rng.normal(size=(64, 3)) * 1e6, rng.uniform(1e3, 1e5, size=64)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=8)
    ref = _dense_f64(pos, mu)
    got = _rel_rows(cuda_split.pairwise_accel_split(tp, tm, idx, split.strong_pair_mask(idx, 64)),
                    ref)
    assert got.max() < 4e-7
    assert got.max() < _rel_rows(cuda_f32.pairwise_accel_f32(*_f32(pos, mu)), ref).max()


@pytest.mark.parametrize("corr", ["fast", "f64"])
@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8)])
def test_split_mode_matches_jax(case, k, corr):
    """The whole mode against the JAX package's, from one strong set: the
    f32 tails differ by their sum order, 1e-6 of max |a| (the correction
    differs by < 1e-14 of its own size)."""
    pos, mu = INPUTS[case]()
    (jidx, jmask), (idx, mask) = _strong_set(pos, mu, k)
    port = cuda_split.pairwise_accel_split(torch.tensor(pos), torch.tensor(mu), idx, mask,
                                           corr=corr)
    ref = jp.pairwise_accel_split(jnp.asarray(pos), jnp.asarray(mu), jidx, jmask, corr=corr,
                                  **TILES)
    assert _rel(port, ref) <= F32_VS_PALLAS


def test_split_corr_dd_raises_and_exact_f64_spelling():
    """exact_f64=True is corr="f64"; an unknown corr raises."""
    pos, mu = _cloud(16, 2)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=4)
    mask = split.strong_pair_mask(idx, 16)
    a = cuda_split.pairwise_accel_split(tp, tm, idx, mask, exact_f64=True)
    assert torch.equal(a, cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="f64"))
    with pytest.raises(ValueError):
        cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="exact")


# -- kernel 9 -----------------------------------------------------------------

@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8), ("cloud64", 5),
                                     ("cloud64", 16)])
def test_kernel9_plain_matches_pallas(case, k):
    """Kernel 9's plain version against the JAX package's
    ``_strong_correction_df64`` (interpret mode): <= 1e-14 of max |c|; K = 6
    and 5 pad to KP = 8 in front."""
    pos, mu = INPUTS[case]()
    (jidx, _), (idx, _) = _strong_set(pos, mu, k)
    before = cuda_split.strong_correction_dd.launches
    port = cuda_split._strong_correction_df64(torch.tensor(pos), torch.tensor(mu), idx).numpy()
    assert cuda_split.strong_correction_dd.launches == before  # CPU: plain version
    ref = jp._strong_correction_df64(jnp.asarray(pos), jnp.asarray(mu), jidx, interpret=True)
    assert port.dtype == np.float64
    assert _rel(port, ref) <= STRONG_VS_PALLAS


@pytest.mark.parametrize("k", [5, 8])
def test_kernel9_feed_is_the_reference_split(k):
    """The feed, bitwise: the f64 difference pos[idx] - pos[i] split into
    (hi, lo) f32 as ``_split_f64`` does, the KP - K padding zeros in front,
    and the split mu[idx], as the reference builds them on the host."""
    pos, mu = _hierarchy()
    (jidx, _), (idx, _) = _strong_set(pos, mu, k)
    kp = cuda_split._padded_width(k)
    d64 = torch.tensor(pos)[idx.long()] - torch.tensor(pos)[:, None, :]
    jd64 = jnp.asarray(pos)[jidx] - jnp.asarray(pos)[:, None, :]
    for c in range(3):
        got = cuda_split._split_pad(d64[..., c], kp)
        ref = jp._split_f64(jd64[..., c])
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[:, kp - k:].numpy(), np.asarray(r))
            assert not g[:, :kp - k].any()
    got = cuda_split._split_pad(torch.tensor(mu)[idx.long()], kp)
    for g, r in zip(got, jp._split_f64(jnp.asarray(mu)[jidx])):
        np.testing.assert_array_equal(g[:, kp - k:].numpy(), np.asarray(r))


def test_kernel9_padding_adds_exact_zero():
    """A padding entry (d = 0, mu = 0) contributes a two-float zero: K = 3
    (KP = 4) equals the three real terms' tree with an exact zero in front,
    which is what the kernel adds in its place."""
    pos, mu = _cloud(16, 12)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=3)
    got = cuda_split.strong_correction_dd_plain(tp, tm, idx)
    terms = [cuda_split.strong_correction_dd_plain(tp, tm, idx[:, j:j + 1].contiguous())
             for j in range(3)]
    zero = torch.zeros_like(terms[0][0])
    want = eft.add_sloppy(eft.add_sloppy(TwoFloat(zero, zero), TwoFloat(*terms[1])),
                          eft.add_sloppy(TwoFloat(*terms[0]), TwoFloat(*terms[2])))
    assert torch.equal(got[0], want.hi) and torch.equal(got[1], want.lo)


@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8)])
def test_strong_correction_df64_matches_f64(case, k):
    """test_strong_correction_df64_matches_f64's bar on the port: within
    3e-13 per body of the native-f64 correction, and on the hierarchy
    closer than the split-limb feed (kernel 8, ~1.7e-12 there)."""
    pos, mu = INPUTS[case]()
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=k)
    ref = split._strong_correction(tp, tm, idx)
    dd = _rel_rows(cuda_split._strong_correction_df64(tp, tm, idx), ref).max()
    assert dd < 3e-13
    if case == "hierarchy":
        assert dd < _rel_rows(cuda_split._strong_correction_fast(tp, tm, idx), ref).max()


@pytest.mark.parametrize("case, k", [("hierarchy", 6), ("cloud64", 8)])
def test_split_mode_dd_matches_jax(case, k):
    """``pairwise_accel_split(corr="dd")`` against the JAX package's, from
    one strong set: 1e-6 of max |a| (the f32 tails' sum order), and within
    the split mode's envelopes against native f64 (2e-9 per body on the
    hierarchy, 4e-7 on the cloud)."""
    pos, mu = INPUTS[case]()
    (jidx, jmask), (idx, mask) = _strong_set(pos, mu, k)
    port = cuda_split.pairwise_accel_split(torch.tensor(pos), torch.tensor(mu), idx, mask,
                                           corr="dd")
    ref = jp.pairwise_accel_split(jnp.asarray(pos), jnp.asarray(mu), jidx, jmask, corr="dd",
                                  **TILES)
    assert _rel(port, ref) <= F32_VS_PALLAS
    envelope = {"hierarchy": 2e-9, "cloud64": 4e-7}[case]
    assert _rel_rows(port, _dense_f64(pos, mu)).max() < envelope


def test_kernel9_plain_rejects_out_of_range_index():
    """The plain version raises on an index outside [0, N) (the kernel gives
    NaN for that receiver, test_torch_cuda.py)."""
    pos, mu = _cloud(16, 13)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=4)
    for bad in (16, -1):
        wrong = idx.clone()
        wrong[2, 1] = bad
        with pytest.raises(IndexError):
            cuda_split.strong_correction_dd(tp, tm, wrong)
        with pytest.raises(IndexError):
            cuda_split.strong_correction_dd_fused(tp, tm, wrong)


@pytest.mark.parametrize("k", [6, 16, 40])
@pytest.mark.parametrize("case", ["hierarchy64", "cloud64"])
def test_kernel9_fused_plain_is_the_old_dd_route(case, k):
    """Kernel 9's f64 entry (the f64 sum with kernel 7's a32 added) is the
    ``corr="dd"`` route it replaces, bitwise: combine_f64 of the raw pair
    in pos's dtype, plus a32 in pos's dtype; without a32 the combine alone.
    So ``pairwise_accel_split(corr="dd")`` keeps its bits."""
    tp, tm, idx, mask, a32 = _fused_case(case, k)
    combined = cuda_nbody.combine_f64(*cuda_split.strong_correction_dd_plain(tp, tm, idx))
    old = combined.to(tp.dtype) + a32.to(tp.dtype)
    got = cuda_split.strong_correction_dd_fused_plain(tp, tm, idx, a32)
    assert got.dtype == torch.float64 and got.shape == (64, 3)
    assert torch.equal(got, old)
    assert torch.equal(cuda_split.strong_correction_dd_fused_plain(tp, tm, idx), combined)
    before = cuda_split.strong_correction_dd.launches
    assert torch.equal(cuda_split.strong_correction_dd_fused(tp, tm, idx, a32), old)
    assert torch.equal(cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="dd"), old)
    assert torch.equal(cuda_split._strong_correction_df64(tp, tm, idx), combined)
    assert cuda_split.strong_correction_dd.launches == before  # CPU: plain versions


@pytest.mark.parametrize("tail", [True, False])
def test_kernel9_fused_launch_arguments(tail, monkeypatch):
    """Kernel 9's f64 entry hands the kernel the f64 positions, mu, idx,
    kernel 7's weak tail (or a null pointer), the f64 output and N, K; it
    counts on strong_correction_dd.launches."""
    from contextlib import contextmanager

    calls = []

    class FakeLib:
        def eet_strong_corr_dd_f64(self, *args):
            calls.append(args)
            return 0

    @contextmanager
    def on_device(dev):
        yield 0

    monkeypatch.setattr(cuda_split._build, "library", lambda: FakeLib())
    monkeypatch.setattr(cuda_split, "on_device", on_device)
    pos, mu = _cloud(32, 3)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=5)
    a32 = torch.zeros((32, 3)) if tail else None
    before = cuda_split.strong_correction_dd.launches
    out = cuda_split._dd_fused(tp, tm, idx, a32)
    assert cuda_split.strong_correction_dd.launches == before + 1
    assert out.dtype == torch.float64 and out.shape == (32, 3)
    (args,) = calls
    assert args == (tp.data_ptr(), tm.data_ptr(), idx.data_ptr(),
                    None if a32 is None else a32.data_ptr(), out.data_ptr(), 32, 5, 0)
    with pytest.raises(TypeError):
        cuda_split._dd_fused(tp.float(), tm, idx, a32)
    with pytest.raises(TypeError):
        cuda_split._dd_fused(tp, tm, idx, tp)
    with pytest.raises(ValueError):
        cuda_split._dd_fused(tp, tm, idx[:8].contiguous(), None)
    assert cuda_split.strong_correction_dd.launches == before + 1


# -- the strong set -----------------------------------------------------------

def test_strong_pair_selection_invariants():
    """test_strong_pair_selection_invariants, on the port, and the index
    sets equal the JAX package's row by row (torch.topk and lax.top_k may
    order ties differently)."""
    pos, mu = _hierarchy()
    k, n = 5, 16
    idx = split.strong_pair_indices(torch.tensor(pos), torch.tensor(mu), k=k)
    assert idx.shape == (n, k) and idx.dtype == torch.int32
    for i, row in enumerate(idx.tolist()):
        assert i not in row and len(set(row)) == k
    mask = split.strong_pair_mask(idx, n).numpy()
    assert mask.dtype == np.int8 and mask.sum() == n * k + n
    assert np.diagonal(mask).all()
    assert mask[np.repeat(np.arange(n), k), idx.numpy().reshape(-1)].all()
    assert 3 in idx[2] and 2 in idx[3] and 0 in idx[2] and 0 in idx[3]
    jidx = np.asarray(jp.strong_pair_indices(jnp.asarray(pos), jnp.asarray(mu), k=k))
    assert [set(r) for r in idx.tolist()] == [set(r) for r in jidx.tolist()]
    np.testing.assert_array_equal(mask, np.asarray(jp.strong_pair_mask(jnp.asarray(jidx), n)))


def test_strong_pair_indices_rows_match_jax():
    pos, mu = _cloud(32, 5)
    for r0 in (0, 16):
        rows = pos[r0:r0 + 16]
        got = split.strong_pair_indices_rows(torch.tensor(pos), torch.tensor(rows),
                                             torch.tensor(mu), r0, k=4)
        ref = np.asarray(jp.strong_pair_indices_rows(jnp.asarray(pos), jnp.asarray(rows),
                                                     jnp.asarray(mu), jnp.int32(r0), k=4))
        assert [set(r) for r in got.tolist()] == [set(r) for r in ref.tolist()]
        np.testing.assert_array_equal(
            split.strong_pair_mask_rows(got, 32, r0).numpy(),
            np.asarray(jp.strong_pair_mask_rows(jnp.asarray(ref), 32, jnp.int32(r0))))


def test_strong_pair_indices_rejects_k_not_below_n():
    pos, mu = _cloud(8, 1)
    with pytest.raises(AssertionError):
        split.strong_pair_indices(torch.tensor(pos), torch.tensor(mu), k=8)
    with pytest.raises(AssertionError):
        split.strong_pair_indices_rows(torch.tensor(pos), torch.tensor(pos[:4]), torch.tensor(mu),
                                       0, k=8)


def test_split_rows_slices_match_square():
    """test_split_rows_slices_match_square, on the port: the rows forms of
    the strong set, kernel 7, kernel 8 and the composed mode are the square
    forms' row slices, bitwise."""
    rng = np.random.default_rng(5)
    n, k, nl = 32, 4, 8
    pos = np.concatenate([rng.normal(size=(n // 2, 3)) * 1e6,
                          rng.normal(size=(n // 2, 3)) * 1e6 + 3e7])
    mu = rng.uniform(1e3, 1e5, n)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=k)
    mask = split.strong_pair_mask(idx, n)
    p32, m32 = _f32(pos, mu)
    m_sq = cuda_f32.pairwise_accel_f32_masked(p32, m32, mask, diag_in_mask=True)
    c_sq = cuda_split._strong_correction_fast(tp, tm, idx)
    a_sq = cuda_split.pairwise_accel_split(tp, tm, idx, mask)
    for r0 in range(0, n, nl):
        rows = tp[r0:r0 + nl]
        idx_r = split.strong_pair_indices_rows(tp, rows, tm, r0, k=k)
        assert torch.equal(idx_r, idx[r0:r0 + nl])
        mask_r = split.strong_pair_mask_rows(idx_r, n, r0)
        assert torch.equal(mask_r, mask[r0:r0 + nl])
        assert torch.equal(cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask_r,
                                                                   p32[r0:r0 + nl]),
                           m_sq[r0:r0 + nl])
        assert torch.equal(cuda_split._strong_correction_fast(tp, tm, idx_r, rows=rows),
                           c_sq[r0:r0 + nl])
        assert torch.equal(cuda_split.pairwise_accel_split_rows(tp, rows, tm, idx_r, mask_r),
                           a_sq[r0:r0 + nl])


# -- any N, devices, imports ---------------------------------------------------

def test_plain_versions_take_any_n():
    """n = 37 (no tile divides it): every mode is finite and near f64."""
    pos, mu = _cloud(37, 8)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    ref = nbody.pairwise_accel(tp, tm).numpy()
    p32, m32 = _f32(pos, mu)
    ph, pl = cuda_nbody.split_f64(tp, transpose=True)
    idx = split.strong_pair_indices(tp, tm, k=7)
    mask = split.strong_pair_mask(idx, 37)
    assert _rel(cuda_f32.pairwise_accel_f32(p32, m32), ref) < 1e-5
    assert _rel(cuda_mixed.pairwise_accel_mixed(ph, pl, m32), ref) < 1e-5
    assert _rel(cuda_split.pairwise_accel_split(tp, tm, idx, mask), ref) < 1e-6
    assert _rel(cuda_split.pairwise_accel_split(tp, tm, idx, mask, corr="f64"), ref) < 1e-6


# -- the launch geometry of kernels 6 and 7 ------------------------------------

@pytest.mark.parametrize("n0", range(1, 5001, 1000))
def test_f32_pair_geometry_partitions_the_tiles(n0):
    """For every N in [n0, n0 + 1000): the block and the split count stay
    within the kernels' limits, no split is empty, each walks its tiles in
    order, and the splits cover every 32-source tile once."""
    for n in range(n0, n0 + 1000):
        warps, blocks = cuda_nbody._f32_pair_geometry(n)
        assert 1 <= warps <= cuda_nbody.F32_PAIR_WARPS
        assert blocks == 1 or warps == cuda_nbody.F32_PAIR_WARPS
        assert 1 <= warps * blocks <= -(-n // cuda_nbody.F32_PAIR_TILE)
        splits = cuda_nbody._f32_split_tiles(n, warps * blocks)
        assert all(splits), n
        assert all(s == sorted(s) for s in splits), n
        assert sorted(t for s in splits for t in s) == list(range(-(-n // cuda_nbody.F32_PAIR_TILE)))


def test_f32_pair_geometry_at_the_main_path():
    """N = 4096: 32 receiver groups x 64 splits (8 blocks of 8 warps), 2048
    warps for the H100's 132 SMs, 2 tiles a warp."""
    assert cuda_nbody._f32_pair_geometry(4096) == (8, 8)
    assert {len(s) for s in cuda_nbody._f32_split_tiles(4096, 64)} == {2}


@pytest.mark.parametrize("n", [1, 31, 129, 1000, 4096, 4999])
def test_kernel7_launch_takes_its_splits_from_the_sources(n, monkeypatch):
    """Kernel 7's launches in the square and the rows form get the geometry
    of N, whatever NL and the row offset: the source side depends on N
    alone, so a row slice is summed in the square form's order."""
    from contextlib import contextmanager

    calls = []

    class FakeLib:
        def eet_accel_f32_masked(self, *args):
            calls.append(args[7:12])  # n, nl, warps, blocks, diag_in_mask
            return 0

    @contextmanager
    def on_device(dev):
        yield 0

    monkeypatch.setattr(cuda_f32._build, "library", lambda: FakeLib())
    monkeypatch.setattr(cuda_f32, "on_device", on_device)
    pos, mu = _cloud(n, 5)
    p32, m32 = _f32(pos, mu)
    mask = torch.zeros((n, n), dtype=torch.int8)
    cuda_f32._masked(p32, m32, mask, p32, False)
    for r0, nl in ((0, n), (n // 3, max(1, n // 3)), (n - 1, 1)):
        cuda_f32._masked(p32, m32, mask[r0:r0 + nl].contiguous(), p32[r0:r0 + nl].contiguous(),
                         True)
    geometry = cuda_nbody._f32_pair_geometry(n)
    assert calls[0] == (n, n, *geometry, 0)
    assert [c[2:4] for c in calls] == [geometry] * 4
    assert [c[1] for c in calls[1:]] == [n, max(1, n // 3), 1]


@pytest.mark.parametrize("n", [1, 31, 129, 1000, 4096, 4999])
def test_kernel5_launch_takes_its_geometry_from_the_sources(n, monkeypatch):
    """Kernel 5 launches on the warp-tiled loop's geometry of N, with the
    stream's counter buffer (one zeroed counter a 128-receiver group) and a
    (blocks, N, 3) scratch, once a call."""
    from contextlib import contextmanager

    calls = []

    class FakeLib:
        def eet_accel_f32(self, *args):
            calls.append(args)
            return 0

    @contextmanager
    def on_device(dev):
        yield 0

    monkeypatch.setattr(cuda_f32._build, "library", lambda: FakeLib())
    monkeypatch.setattr(cuda_f32, "on_device", on_device)
    monkeypatch.setattr(cuda_nbody, "_PAIR_COUNTERS", {})
    p32, m32 = _f32(*_cloud(n, 5))
    before = cuda_f32.pairwise_accel_f32.launches
    cuda_f32._unmasked(p32, m32)
    assert cuda_f32.pairwise_accel_f32.launches == before + 1
    (args,) = calls
    assert args[5:9] == (n, *cuda_nbody._f32_pair_geometry(n), 0)
    assert args[:2] == (p32.data_ptr(), m32.data_ptr())
    counters = cuda_nbody._PAIR_COUNTERS[(None, 0)]
    assert args[3] == counters.data_ptr()
    assert counters.numel() >= -(-n // cuda_nbody.F32_PAIR_GROUP) and not counters.any()


@pytest.mark.parametrize("form", ["square", "rows", "rows_no_tail"])
def test_kernel8_fused_launch_arguments(form, monkeypatch):
    """Kernel 8's production form hands the kernel the f64 sources, the
    receivers (the sources themselves in the square form), mu, idx, kernel
    7's weak tail (or a null pointer) and N, NL, K; it counts on
    strong_correction_pair.launches."""
    from contextlib import contextmanager

    calls = []

    class FakeLib:
        def eet_strong_corr_f64(self, *args):
            calls.append(args)
            return 0

    @contextmanager
    def on_device(dev):
        yield 0

    monkeypatch.setattr(cuda_split._build, "library", lambda: FakeLib())
    monkeypatch.setattr(cuda_split, "on_device", on_device)
    pos, mu = _cloud(32, 3)
    tp, tm = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(tp, tm, k=5)
    r0 = 0 if form == "square" else 20
    rows = None if form == "square" else tp[r0:]
    idx_r = idx[r0:].contiguous()
    a32 = None if form == "rows_no_tail" else torch.zeros((32 - r0, 3))
    before = cuda_split.strong_correction_pair.launches
    out = cuda_split._fused(tp, tm, idx_r, rows, a32)
    assert cuda_split.strong_correction_pair.launches == before + 1
    assert out.dtype == torch.float64 and out.shape == (32 - r0, 3)
    (args,) = calls
    assert args[:4] == (tp.data_ptr(), (tp if rows is None else rows).data_ptr(), tm.data_ptr(),
                        idx_r.data_ptr())
    assert args[4] == (None if a32 is None else a32.data_ptr())
    assert args[5:10] == (out.data_ptr(), 32, 32 - r0, 5, 0)
    with pytest.raises(TypeError):
        cuda_split._fused(tp.float(), tm, idx_r, rows, a32)
    with pytest.raises(ValueError):
        cuda_split._fused(tp, tm, idx[:8].contiguous(), None, None)


def _meta_calls():
    pos, mu = _cloud(8, 6)
    p32, m32 = (t.to("meta") for t in _f32(pos, mu))
    mask = torch.zeros((8, 8), dtype=torch.int8, device="meta")
    idx = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    ph = torch.zeros((3, 8), device="meta")
    mh = torch.zeros(8, device="meta")
    return {
        "f32": lambda: cuda_f32.pairwise_accel_f32(p32, m32),
        "f32_masked": lambda: cuda_f32.pairwise_accel_f32_masked(p32, m32, mask),
        "f32_masked_rows": lambda: cuda_f32.pairwise_accel_f32_masked_rows(p32, m32, mask, p32),
        "mixed": lambda: cuda_mixed.pairwise_accel_mixed(ph, ph, m32),
        "strong_corr": lambda: cuda_split.strong_correction_pair(p32, p32, p32, p32, mh, mh, idx),
        "strong_corr_dd": lambda: cuda_split.strong_correction_dd(p32.double(), mh.double(), idx),
        "strong_corr_fused": lambda: cuda_split.strong_correction_fused(p32.double(), mh.double(),
                                                                        idx, a32=p32),
        "strong_corr_dd_fused": lambda: cuda_split.strong_correction_dd_fused(
            p32.double(), mh.double(), idx, a32=p32),
    }


@pytest.mark.parametrize("name", ["f32", "f32_masked", "f32_masked_rows", "mixed",
                                  "strong_corr", "strong_corr_dd", "strong_corr_fused",
                                  "strong_corr_dd_fused"])
def test_wrappers_reject_unsupported_device(name):
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()


def test_import_leaves_jax_out():
    """Importing the force-mode modules never imports JAX."""
    code = (
        "import sys\n"
        "import ephemeris_explorer_tpu_torch.ops.cuda_f32, ephemeris_explorer_tpu_torch.ops.cuda_mixed\n"
        "import ephemeris_explorer_tpu_torch.ops.split, ephemeris_explorer_tpu_torch.ops.cuda_split\n"
        "import ephemeris_explorer_tpu_torch.interop\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m.split('.')[0] == 'ephemeris_explorer_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
