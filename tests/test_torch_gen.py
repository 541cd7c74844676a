"""Kernel 11 (a whole generation chunk in one kernel) against the JAX
package's ``elm2_gen_scan``, the double-double truth, and the port's
generation routes.

The port runs the kernel's plain version (CPU tensors); the JAX side runs
its Pallas kernel in interpret mode, as ``tests/test_pallas_nbody.py``
does.  Inputs come from numpy with a seed and cross over through
``interop``.  The kernel-against-plain cases on the card are in
``test_torch_cuda.py``.

The interpret-mode JAX kernel costs 10-20 s of CPU per step after the first
(measured at n = 10 and 32), so the comparison with it runs two steps at
n = 10 (ghost padding) and one at n = 32; the 8-step cases hold the port
against the dd truth and its own invariants.

Bars.  Against the JAX kernel: 2^-44 of max |y| (emissions and position
ring) and of max |a| (force ring).  The emissions and rings are bitwise at
n = 10; the force ring is not (~1e-14 of max |a|: XLA:CPU compiles the
interpret-mode body as one program, ROADMAP queue 3).  Against the dd
truth: the envelope of ``test_gen_scan_kernel_matches_plain``, err <=
max(5 x the native-f64 step's err, 2^-42 max |y|).  The generation branch
against the native-f64 route: 1e-10 in sample space, the bar of
``test_fused_generation_on_card``.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.integrators import multistep as jms
from ephemeris_explorer_tpu.ops import nbody as jnbody
from ephemeris_explorer_tpu.ops.eft import TwoFloat as JTwoFloat
from ephemeris_explorer_tpu.ops.pallas_gen import elm2_gen_scan as jgen_scan
from ephemeris_explorer_tpu.ops.pallas_nbody import split_f64 as jsplit
from ephemeris_explorer_tpu_torch import Duration, interop
from ephemeris_explorer_tpu_torch import ephemeris as eph
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.ops import cuda_gen, nbody
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
from ephemeris_explorer_tpu_torch.ops.polyfit import fit_matrix

QT12 = "QuinlanTremaine12"
H = 600.0
STEPS = 8
GEN_VS_PALLAS = 2.0**-44
ROOT = Path(__file__).resolve().parent.parent


def _start(n, seed=13):
    """test_gen_scan_kernel_matches_plain's system: the JAX f64 startup
    carry and the split mu."""
    rng = np.random.default_rng(seed)
    pos, vel = rng.normal(size=(n, 3)) * 1.0e6, rng.normal(size=(n, 3))
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    mu_j = jnp.asarray(mu)

    def accel(t, y):
        return jnbody.pairwise_accel(y, mu_j)

    c0 = jms.elm2_init(jget(QT12), accel, 0.0, jnp.asarray(pos), jnp.asarray(vel), H)
    return {"mu": mu, "accel": accel, "c0": c0, "pos": pos, "vel": vel,
            "mu_pair": jsplit(mu_j.reshape(1, -1))}


@pytest.fixture(scope="module", params=[(10, 2), (32, 1)])
def scans(request):
    """The JAX kernel's chunk and the port's, from the same carry: (n, steps)."""
    n, steps = request.param
    s = _start(n)
    mh, ml = s["mu_pair"]
    ys, cn = jgen_scan(jget(QT12), H, s["c0"], JTwoFloat(mh, ml), steps, interpret=True)
    mu_pair = TwoFloat(torch.tensor(np.asarray(mh)), torch.tensor(np.asarray(ml)))
    before = cuda_gen.elm2_gen_scan.launches
    tys, tcn = cuda_gen.elm2_gen_scan(get(QT12), H, interop.carry_from(s["c0"]), mu_pair, steps)
    assert cuda_gen.elm2_gen_scan.launches == before  # CPU: the plain version
    return {**s, "n": n, "steps": steps, "jys": np.asarray(ys), "jc": cn, "ys": tys, "c": tcn}


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_gen_plain_matches_pallas(scans):
    ys, c, jc = scans["ys"], scans["c"], scans["jc"]
    n = scans["n"]
    assert tuple(ys.shape) == (scans["steps"], n, 3) and ys.dtype == torch.float64
    assert tuple(c.ys.shape) == (12, n, 3) and tuple(c.ddys.shape) == (12, n, 3)
    assert c.t == pytest.approx(float(jc.t))
    bitwise = np.array_equal(ys.numpy(), scans["jys"])
    print(f"kernel 11 plain vs Pallas interpret at n={n}: emissions bitwise={bitwise}")
    assert _rel(ys.numpy(), scans["jys"]) <= GEN_VS_PALLAS
    assert _rel(c.ys.numpy(), jc.ys) <= GEN_VS_PALLAS
    assert _rel(c.ddys.numpy(), jc.ddys) <= GEN_VS_PALLAS


def test_gen_invariants(scans):
    """The last emission is the committed ring head, the time advanced by
    n_steps h, and the force ring's head is f(y) to pair precision (1e-13,
    the reference test's bar)."""
    ys, c = scans["ys"], scans["c"]
    assert torch.equal(ys[-1], c.ys[0])
    assert c.t == pytest.approx(float(scans["c0"].t) + scans["steps"] * H, abs=1e-9)
    f_ref = nbody.pairwise_accel(c.ys[0], torch.tensor(scans["mu"]))
    scale = f_ref.abs().max().item()
    np.testing.assert_allclose(c.ddys[0].numpy(), f_ref.numpy(), rtol=1e-13, atol=scale * 1e-13)


def test_gen_envelope_vs_dd_truth():
    """n = 10 (ghost padding), 8 steps: the chunk's error against the JAX
    package's double-double truth (elm2_step_c) stays within 5x the
    native-f64 step's, or 2^-42 of max |y|."""
    s = _start(10)
    cc = jms.elm2_init_c(jget(QT12), s["accel"], 0.0, jnp.asarray(s["pos"]),
                         jnp.asarray(s["vel"]), H)
    for _ in range(STEPS):
        cc = jms.elm2_step_c(jget(QT12), s["accel"], H, cc)
    truth = np.asarray(cc.ys.hi[0]) + np.asarray(cc.ys.lo[0])
    mu = torch.tensor(s["mu"])
    p = interop.carry_from(s["c0"])
    mh, ml = s["mu_pair"]
    _, c = cuda_gen.elm2_gen_scan(get(QT12), H, p, TwoFloat(torch.tensor(np.asarray(mh)),
                                                             torch.tensor(np.asarray(ml))), STEPS)
    for _ in range(STEPS):
        p = ms.elm2_step(get(QT12), lambda t, y: nbody.pairwise_accel(y, mu), H, p,
                         with_velocity=False)
    err_plain = np.abs(p.ys[0].numpy() - truth).max()
    err_gen = np.abs(c.ys[0].numpy() - truth).max()
    floor = np.abs(truth).max() * 2.0**-42
    assert err_gen <= max(5.0 * err_plain, floor), (err_gen, err_plain, floor)


def _coeff_err(a, b, settings):
    worst = 0.0
    for name in a.names:
        ca, cb = a[name].coeffs, b[name].coeffs
        assert ca.shape == cb.shape
        if ca.size:
            norm = np.abs(fit_matrix(settings.settings[name].degree)).sum(1)
            rows = norm > 0
            d = np.abs(ca - cb).max(axis=(0, 2))[rows] / norm[rows]
            worst = max(worst, float(d.max() / np.abs(ca[:, 0]).max()))
    return worst


def test_gen_branch_matches_native_f64_route(monkeypatch):
    """``_chunk_fn``'s kernel-11 branch (the gate patched open) against the
    native-f64 route over 2 days of full_solar_system in 200-step chunks:
    the same segments, within 1e-10 in sample space; one kernel-11 call per
    chunk after the startup."""
    sc = scene.load_scene(ROOT / "systems" / "full_solar_system_2433282.5")
    span = Duration.from_days(2.0)  # 288 steps: 12 startup + 188, then 88
    plain = eph.generate_ephemeris(sc.state, sc.settings, span, chunk_steps=200, device="cpu")
    calls, scan = [], cuda_gen.elm2_gen_scan

    def counted(*args):
        calls.append(args[-1])
        return scan(*args)

    monkeypatch.setattr(eph, "_use_gen_kernel", lambda n, device: True)
    monkeypatch.setattr(eph.cuda_gen, "elm2_gen_scan", counted)
    gen = eph.generate_ephemeris(sc.state, sc.settings, span, chunk_steps=200, device="cpu")
    assert calls == [188, 88]
    assert _coeff_err(plain, gen, sc.settings) <= 1e-10


def test_gen_scan_zero_steps_and_limit():
    """No steps leave the carry's rings as they were, rounded to two-float
    state; more than 256 bodies after padding raise, naming the limit."""
    s = _start(5)
    mh, ml = s["mu_pair"]
    mu_pair = TwoFloat(torch.tensor(np.asarray(mh)), torch.tensor(np.asarray(ml)))
    c0 = interop.carry_from(s["c0"])
    ys, c = cuda_gen.elm2_gen_scan(get(QT12), H, c0, mu_pair, 0)
    assert tuple(ys.shape) == (0, 5, 3) and c.t == c0.t
    rounded = ms.elm2_f_to(ms.elm2_f_from(c0))
    assert torch.equal(c.ys, rounded.ys) and torch.equal(c.ddys, rounded.ddys)
    big = ms.ELM2Carry(t=0.0, ys=torch.zeros(12, 257, 3, dtype=torch.float64),
                       ddys=torch.zeros(12, 257, 3, dtype=torch.float64),
                       dy=torch.zeros(257, 3, dtype=torch.float64))
    z = torch.zeros(1, 257)
    with pytest.raises(ValueError, match="at most 256"):
        cuda_gen.elm2_gen_scan(get(QT12), H, big, TwoFloat(z, z), 4)
