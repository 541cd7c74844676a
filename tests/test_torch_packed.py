"""The packed carries, the packed entry points of kernels 2 and 4 (2', 4')
and the packed ensemble scan against the JAX package's and the port's
unpacked ones.

The port runs the kernels' plain versions (CPU tensors); the JAX side runs
its Pallas kernels in interpret mode, as its own tests do.  Inputs come from
numpy with a seed.  The step comparisons with the JAX package feed both
sides the same force, a native-f64 numpy force on the pair (or limb) state
split back into (hi, lo), so that only the carries and the update kernels
are compared; the ensemble scan uses each package's own kernel 1.

Bars.  Packed against unpacked in the port: bitwise (the packed ring is the
flat ring's memory).  Kernel 2' and the FP step against the JAX package's:
bitwise (same ops in the same order; measured bitwise).  Kernel 4' and the
QFP step: limbs 0-1 of one update bitwise and the expansion within 2^-64
of max |y|, the bar of ``test_torch_elm2q.py`` (the interpret-mode kernel
runs as one compiled XLA:CPU program that rounds the deep limbs
differently, ROADMAP queue 3); after six QFP steps 1e-18 of max |y|, the
bar of ``test_torch_multistep_q.py`` (measured 2^-63).  The packed
ensemble scan against the JAX package's: 2^-40 of max |y|,
``test_torch_ensemble.py``'s bar for the unpacked scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops import pallas_elm2 as jelm2
from ephemeris_explorer_tpu.ops.eft import TwoFloat as JTwoFloat
from ephemeris_explorer_tpu.parallel import sharding as jsh
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_elm2, cuda_elm2q
from ephemeris_explorer_tpu_torch.ops import expansion as ex
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
from ephemeris_explorer_tpu_torch.parallel import sharding as sh

QT12 = "QuinlanTremaine12"
H = 600.0
N = 32
STEPS = 6
SHAPE = (N, 3)
DEEP_LIMBS = 2.0**-64
QFP_STEPS_VS_JAX = 1e-18
SCAN_FP_VS_JAX = 2.0**-40


def _system(n=N, seed=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1e6, rng.normal(size=(n, 3)), rng.uniform(1e3, 1e5, n)


def _np_force(y64, mu):
    """Native-f64 pair force on (N, 3) numpy positions, split to f32 (hi, lo)."""
    d = y64[None, :, :] - y64[:, None, :]
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, 1.0)
    inv3 = r2**-1.5
    np.fill_diagonal(inv3, 0.0)
    a = ((mu[None, :] * inv3)[:, :, None] * d).sum(1)
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _pair_forces(mu):
    """The same force for both packages: (port accel_pair, JAX accel_pair)
    on pair states, and (port, JAX) on the three leading limbs."""
    def f64(hi, lo):
        return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)

    def limbs64(limbs):
        return sum(np.asarray(l, np.float64) for l in limbs)

    def port_pair(t, y):
        return TwoFloat(*(torch.from_numpy(x) for x in _np_force(f64(y.hi, y.lo), mu)))

    def jax_pair(t, y):
        return JTwoFloat(*(jnp.asarray(x) for x in _np_force(f64(y.hi, y.lo), mu)))

    def port_limbs(t, limbs):
        return tuple(torch.from_numpy(x) for x in _np_force(limbs64(limbs), mu))

    def jax_limbs(t, limbs):
        return tuple(jnp.asarray(x) for x in _np_force(limbs64(limbs), mu))

    return port_pair, jax_pair, port_limbs, jax_limbs


def _same(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _exp_diff(a, b):
    """max |sum of limb differences| / max |y| over two (ORDER, ...) rings."""
    d = sum(np.asarray(x, np.float64) - np.asarray(y, np.float64) for x, y in zip(a, b))
    return float(np.abs(d).max() / np.abs(np.asarray(b[0], np.float64)).max())


@pytest.fixture(scope="module")
def start():
    pos, vel, mu = _system()
    mu_j = jnp.asarray(mu)
    jc = jms.elm2_init(jget(QT12), lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0,
                       jnp.asarray(pos), jnp.asarray(vel), H)
    jq = jms.elm2_init_q(jget(QT12), lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0,
                         jnp.asarray(pos), jnp.asarray(vel), H)
    return {"mu": mu, "jf": jms.elm2_f_from(jc), "jqf": jms.elm2_qf_from_q(jq)}


def test_pack_round_trip_is_exact(start):
    f = interop.carry_f_from(start["jf"])
    fp = ms.elm2_fp_from(f)
    assert tuple(fp.ys.hi.shape) == (12, 8, N * 3 // 8)
    back = ms.elm2_fp_to(fp, SHAPE)
    assert _same((*back.ys, *back.dd), (*f.ys, *f.dd))
    qf = interop.carry_qf_from(start["jqf"])
    backq = ms.elm2_qfp_to(ms.elm2_qfp_from(qf), SHAPE)
    assert _same((*backq.ys, *backq.dd), (*qf.ys, *qf.dd))


def test_fp_steps_match_unpacked_and_jax(start):
    """Six ELM2CarryFP steps: bitwise to the port's unpacked F steps and to
    the JAX package's FP steps; the deferred velocity bitwise too."""
    port_pair, jax_pair, _, _ = _pair_forces(start["mu"])
    tab, jtab = get(QT12), jget(QT12)
    f = interop.carry_f_from(start["jf"])
    fp, jfp = ms.elm2_fp_from(f), jms.elm2_fp_from(start["jf"])
    before = cuda_elm2.elm2f_update_packed.launches
    for _ in range(STEPS):
        f = ms.elm2_step_f(tab, port_pair, H, f)
        fp = ms.elm2_step_fp(tab, port_pair, H, fp, SHAPE)
        jfp = jms.elm2_step_fp(jtab, jax_pair, H, jfp, SHAPE, interpret=True)
    assert cuda_elm2.elm2f_update_packed.launches == before  # CPU: the plain version
    assert fp.t == f.t == float(jfp.t)
    back = ms.elm2_fp_to(fp, SHAPE)
    assert _same((*back.ys, *back.dd), (*f.ys, *f.dd))
    assert _same((*fp.ys, *fp.dd), (*jfp.ys, *jfp.dd))
    v = ms.elm2_velocity_fp(tab, fp, H, SHAPE)
    assert torch.equal(v, ms.elm2_velocity_f(tab, f, H))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jms.elm2_velocity_fp(jtab, jfp, H, SHAPE)))


@pytest.mark.parametrize("precise", [False, True])
def test_qfp_steps_match_unpacked_and_jax(start, precise):
    """Six ELM2CarryQFP steps: bitwise to the port's unpacked QF steps; the
    JAX package's QFP steps within 1e-18 of max |y| on the expansions."""
    _, _, port_limbs, jax_limbs = _pair_forces(start["mu"])
    tab, jtab = get(QT12), jget(QT12)
    qf = interop.carry_qf_from(start["jqf"])
    qfp, jqfp = ms.elm2_qfp_from(qf), jms.elm2_qfp_from(start["jqf"])
    for _ in range(STEPS):
        qf = ms.elm2_step_qf(tab, port_limbs, H, qf, precise_sums=precise)
        qfp = ms.elm2_step_qfp(tab, port_limbs, H, qfp, SHAPE, precise_sums=precise)
        jqfp = jms.elm2_step_qfp(jtab, jax_limbs, H, jqfp, SHAPE, interpret=True,
                                 precise_sums=precise)
    back = ms.elm2_qfp_to(qfp, SHAPE)
    assert _same((*back.ys, *back.dd), (*qf.ys, *qf.dd))
    assert _exp_diff(qfp.ys, jqfp.ys) <= QFP_STEPS_VS_JAX
    assert torch.equal(ms.elm2_velocity_qfp(tab, qfp, H, SHAPE), ms.elm2_velocity_qf(tab, qf, H))


def _packed_rings(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(12, 8, n * 3 // 8)) * 1e8
    a = rng.normal(size=(12, 8, n * 3 // 8)) * 1e-6
    limbs = [np.asarray(l) for l in ex.from_f64_host(y, "cpu")]
    limbs[3] = (limbs[2].astype(np.float64) * 2.0**-25
                * rng.uniform(-1, 1, y.shape)).astype(np.float32)
    hi = a.astype(np.float32)
    return limbs, (hi, (a - hi.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("n, seed", [(32, 0), (64, 1)])
def test_kernel2_packed_matches_pallas(n, seed):
    """Kernel 2' against the JAX package's elm2f_update_packed(interpret=True)
    bitwise, and against kernel 2 on the unpacked view bitwise."""
    limbs, (ah, al) = _packed_rings(n, seed)
    ys = TwoFloat(torch.from_numpy(limbs[0]), torch.from_numpy(limbs[1]))
    dd = TwoFloat(torch.from_numpy(ah), torch.from_numpy(al))
    out = cuda_elm2.elm2f_update_packed(get(QT12), H, ys, dd)
    assert tuple(out.hi.shape) == (8, n * 3 // 8)
    ref = jelm2.elm2f_update_packed(jget(QT12), H, JTwoFloat(*map(jnp.asarray, limbs[:2])),
                                    JTwoFloat(jnp.asarray(ah), jnp.asarray(al)), interpret=True)
    assert _same(out, ref)
    flat = cuda_elm2.elm2f_update(get(QT12), H, TwoFloat(*(x.reshape(12, -1) for x in ys)),
                                  TwoFloat(*(x.reshape(12, -1) for x in dd)))
    assert _same(out, (x.reshape(8, -1) for x in flat))


@pytest.mark.parametrize("precise", [False, True])
def test_kernel4_packed_matches_pallas(precise):
    """Kernel 4' against the JAX package's elm2q_update_packed(interpret=True):
    limbs 0-1 bitwise, the expansion within 2^-64 of max |y|; against kernel
    4 on the unpacked view bitwise."""
    limbs, (ah, al) = _packed_rings(32, 2)
    ys = tuple(torch.from_numpy(l) for l in limbs)
    dd = TwoFloat(torch.from_numpy(ah), torch.from_numpy(al))
    before = cuda_elm2q.elm2q_update_packed.launches
    out = cuda_elm2q.elm2q_update_packed(get(QT12), H, ys, dd, precise=precise)
    assert cuda_elm2q.elm2q_update_packed.launches == before
    ref = jelm2.elm2q_update_packed(jget(QT12), H, tuple(map(jnp.asarray, limbs)),
                                    JTwoFloat(jnp.asarray(ah), jnp.asarray(al)),
                                    interpret=True, precise=precise)
    assert _same(out[:2], ref[:2])
    assert _exp_diff([x[None] for x in out], [np.asarray(x)[None] for x in ref]) <= DEEP_LIMBS
    flat = cuda_elm2q.elm2q_update(get(QT12), H, tuple(l.reshape(12, -1) for l in ys),
                                   TwoFloat(*(x.reshape(12, -1) for x in dd)), precise=precise)
    assert _same(out, (x.reshape(8, -1) for x in flat))


def test_packed_wrappers_reject_unsupported_device():
    limbs, (ah, al) = _packed_rings(32, 3)
    ys = tuple(torch.from_numpy(l).to("meta") for l in limbs)
    dd = TwoFloat(torch.from_numpy(ah).to("meta"), torch.from_numpy(al).to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_elm2.elm2f_update_packed(get(QT12), H, TwoFloat(ys[0], ys[1]), dd)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_elm2q.elm2q_update_packed(get(QT12), H, ys, dd, precise=True)


def test_packed_ensemble_scan_matches_jax_and_unpacked():
    """make_fused_ensemble_scan_fp at E = 2, N = 32, five steps: bitwise to
    the port's unpacked scan, within 2^-40 of max |y| of the JAX package's
    (kernel 1 sums in another order than the Pallas kernel)."""
    e, steps = 2, 5
    rng = np.random.default_rng(9)
    pos, vel = rng.normal(size=(e, N, 3)) * 1e6, rng.normal(size=(e, N, 3))
    mu = rng.uniform(1e3, 1e5, N)
    shape = (e, N, 3)
    carry0 = sh.init_fused_ensemble_carry(get(QT12), mu, 0.0, pos, vel, H, device="cpu")
    run_fp, to_fp = sh.make_fused_ensemble_scan_fp(get(QT12), mu, H, steps, shape, device="cpu")
    run_f, to_f = sh.make_fused_ensemble_scan_f(get(QT12), mu, H, steps, device="cpu")
    out, ref = run_fp(to_fp(carry0)), run_f(to_f(carry0))
    back = ms.elm2_fp_to(out, shape)
    assert _same((*back.ys, *back.dd), (*ref.ys, *ref.dd))
    assert torch.equal(out.dy, ref.dy)
    jtab = jget(QT12)
    jcarry0 = jsh.init_fused_ensemble_carry(jtab, mu, 0.0, pos, vel, H)
    jrun, jto = jsh.make_fused_ensemble_scan_fp(jtab, mu, H, steps, shape, interpret=True,
                                                tile_rows=8, tile_cols=8)
    jout = jrun(jto(jcarry0))
    y = back.ys.hi[0].double().numpy() + back.ys.lo[0].double().numpy()
    jb = jms.elm2_fp_to(jout, shape)
    yj = np.asarray(jb.ys.hi[0], np.float64) + np.asarray(jb.ys.lo[0], np.float64)
    assert np.abs(y - yj).max() <= SCAN_FP_VS_JAX * np.abs(yj).max()
