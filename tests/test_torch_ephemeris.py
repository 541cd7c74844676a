"""The port's generation path against the JAX package's.

Both packages generate from the same scene (carried over through
``interop``) in native f64.  They round differently at the ulp level
(summation order, fused multiply-adds in XLA), and the multistep grows that
to ~1e-14 of the positions over these spans.  The degree-6..8 fit rows then
amplify a sample difference by up to ~2000x, so coefficients are compared
in sample space: each degree's difference is divided by its fit-matrix row
norm (the most a unit sample difference can move it) and by the body's
max |position|.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris as jgenerate
from ephemeris_explorer_tpu.ephemeris import merge_bidirectional as jmerge
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu.ops.polyfit import fit_matrix
from ephemeris_explorer_tpu_torch import Duration, interop
from ephemeris_explorer_tpu_torch import ephemeris as eph

REPO = Path(__file__).resolve().parent.parent


def _scene(name):
    j = jscene.load_scene(REPO / "systems" / name)
    return j, interop.state_from(j.state), interop.settings_from(j.settings)


@pytest.fixture(scope="module")
def sem():
    return _scene("sun_earth_moon_2433282.5")


@pytest.fixture(scope="module")
def fss():
    return _scene("full_solar_system_2433282.5")


def _sample_space_err(a, b, settings, backward=False):
    worst = 0.0
    for n in a.names:
        ca, cb = a[n].coeffs, b[n].coeffs
        assert ca.shape == cb.shape, (n, ca.shape, cb.shape)
        if not ca.size:
            continue
        norm = np.abs(fit_matrix(settings.settings[n].degree, backward)).sum(1)
        rows = norm > 0
        d = np.abs(ca - cb).max(axis=(0, 2))[rows] / norm[rows]
        worst = max(worst, float(d.max() / np.abs(cb[:, 0]).max()))
    return worst


def _same_layout(a, b):
    assert a.names == b.names
    for n in a.names:
        assert a[n].start_s == b[n].start_s and a[n].interval_s == b[n].interval_s, n
        assert a[n].segment_count == b[n].segment_count, n


@pytest.mark.parametrize("scene_name, days", [("sem", 40.0), ("fss", 20.0)])
def test_generation_matches_jax(scene_name, days, request):
    """Coefficients <= 1e-12 of max|position| in sample space."""
    j, state, settings = request.getfixturevalue(scene_name)
    ej = jgenerate(j.state, j.settings, JDuration.from_days(days), precision="f64")
    et = eph.generate_ephemeris(state, settings, Duration.from_days(days))
    _same_layout(et, ej)
    assert _sample_space_err(et, ej, settings) <= 1e-12


def test_backward_generation_and_merge_match_jax(sem):
    j, state, settings = sem
    span = 20.0
    ej = jmerge(jgenerate(j.state, j.settings, JDuration.from_days(span), precision="f64"),
                jgenerate(j.state, j.settings, JDuration.from_days(span), direction=-1,
                          precision="f64"))
    et = eph.merge_bidirectional(
        eph.generate_ephemeris(state, settings, Duration.from_days(span)),
        eph.generate_ephemeris(state, settings, Duration.from_days(span), direction=-1),
    )
    _same_layout(et, ej)
    assert _sample_space_err(et, ej, settings) <= 1e-12


def test_chunked_equals_unchunked(sem):
    """Chunk boundaries change nothing: identical coefficients."""
    _, state, settings = sem
    span = Duration.from_days(40.0)
    whole = eph.generate_ephemeris(state, settings, span)
    for chunk in (13, 37, 64):
        parts = eph.generate_ephemeris(state, settings, span, chunk_steps=chunk)
        _same_layout(parts, whole)
        for n in whole.names:
            np.testing.assert_array_equal(parts[n].coeffs, whole[n].coeffs)


def test_evaluation_matches_jax(sem):
    """positions/state_vector (host) and PackedEphemeris (tensors) on the
    JAX package's own coefficients: <= 1e-15 of the values (same Horner)."""
    j, _, _ = sem
    ej = jgenerate(j.state, j.settings, JDuration.from_days(30.0), precision="f64")
    et = eph.Ephemeris(
        names=list(ej.names), mus=np.asarray(ej.mus),
        bodies={n: eph.BodyEphemeris(b.start_s, b.interval_s, np.asarray(b.coeffs))
                for n, b in ej.bodies.items()},
    )
    t0 = ej.start.as_offset_seconds()
    span = ej.end.as_offset_seconds() - t0
    packed_j, packed_t = ej.pack(), et.pack()
    for frac in (0.0, 0.137, 0.5, 0.999, 1.0):
        t = t0 + frac * span
        pj, pt = ej.positions(t), et.positions(t)
        np.testing.assert_allclose(pt, pj, rtol=1e-15, atol=0)
        for n in ej.names:
            (xj, vj), (xt, vt) = ej[n].state_vector(t), et[n].state_vector(t)
            np.testing.assert_allclose(xt, xj, rtol=1e-15, atol=0)
            np.testing.assert_allclose(vt, vj, rtol=1e-13, atol=1e-18)
        np.testing.assert_allclose(packed_t.positions(t).numpy(),
                                   np.asarray(packed_j.positions(t)), rtol=1e-15, atol=0)
        xpj, vpj = packed_j.state_vectors(t)
        xpt, vpt = packed_t.state_vectors(t)
        np.testing.assert_allclose(xpt.numpy(), np.asarray(xpj), rtol=1e-15, atol=0)
        np.testing.assert_allclose(vpt.numpy(), np.asarray(vpj), rtol=1e-13, atol=1e-18)
    assert et.positions(t0 + 2 * span) is None


def test_fused_branch_matches_jax_f64(sem, monkeypatch):
    """The fused two-float branch (gate forced open; kernels' plain versions
    on CPU) against JAX's f64 generation: <= 1e-11 of max|position| in
    sample space over 160 steps.  A two-float state rounds at 2^-48 per step
    and ELM2 integrates that twice (measured 7.8e-13); the bound also holds
    the f64 branch's own 1e-14."""
    j, state, settings = sem
    days = 40.0
    ej = jgenerate(j.state, j.settings, JDuration.from_days(days), precision="f64")
    monkeypatch.setattr(eph, "_use_fused_f", lambda n, device: True)
    steps = {"update": 0}
    orig = eph.elm2_step_f

    def counting_step(*a, **k):
        steps["update"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(eph, "elm2_step_f", counting_step)
    et = eph.generate_ephemeris(state, settings, Duration.from_days(days), chunk_steps=64)
    assert steps["update"] == 160 - 12  # every step after the startup went through it
    _same_layout(et, ej)
    assert _sample_space_err(et, ej, settings) <= 1e-11


def test_fused_gate():
    """The fused branch needs N*3 >= 4096 bodies' coordinates on CUDA."""
    assert not eph._use_fused_f(1365, torch.device("cuda"))
    assert eph._use_fused_f(1366, torch.device("cuda"))
    assert not eph._use_fused_f(4096, torch.device("cpu"))


@pytest.mark.parametrize("precision", ["extended", "extended3", "extendedF"])
def test_unported_precisions_raise(sem, precision):
    _, state, settings = sem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eph.NBodyPropagator(state, settings, precision=precision)


def test_bucket_tail_matches_jax():
    from ephemeris_explorer_tpu.ephemeris import CHUNK_STEPS, bucket_tail

    assert eph.CHUNK_STEPS == CHUNK_STEPS
    for n in list(range(1, 80)) + [1000, 5000, 13183, 20000]:
        assert eph.bucket_tail(n, CHUNK_STEPS, 12) == bucket_tail(n, CHUNK_STEPS, 12)


@pytest.mark.parametrize("degree, backward", [(5, False), (6, True), (8, False), (8, True)])
def test_polyfit_matches_jax(degree, backward):
    """Fit matrices equal; fit_segments / horner / horner_and_deriv within
    1e-15 of the values (same arithmetic, other summation order)."""
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops import polyfit as jpoly
    from ephemeris_explorer_tpu_torch.ops import polyfit as tpoly

    np.testing.assert_array_equal(tpoly.sample_taus(backward), jpoly.sample_taus(backward))
    m = tpoly.fit_matrix(degree, backward)
    np.testing.assert_array_equal(m, jpoly.fit_matrix(degree, backward))
    rng = np.random.default_rng(degree)
    samples = rng.normal(size=(4, 9, 3)) * 1e8
    cj = np.asarray(jpoly.fit_segments(samples, m))
    ct = tpoly.fit_segments(torch.tensor(samples), torch.tensor(m)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-15 * np.abs(cj).max())
    tau = rng.uniform(size=4)
    np.testing.assert_allclose(tpoly.horner(torch.tensor(cj), torch.tensor(tau)).numpy(),
                               np.asarray(jpoly.horner(jnp.asarray(cj), jnp.asarray(tau))),
                               rtol=1e-15, atol=0)
    vj, dj = jpoly.horner_and_deriv(jnp.asarray(cj), jnp.asarray(tau))
    vt, dt = tpoly.horner_and_deriv(torch.tensor(cj), torch.tensor(tau))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-15, atol=0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-14, atol=1e-15 * np.abs(dj).max())


def test_spline_edits_match_jax(sem):
    """UniformSpline edits (push, clear, between, append) leave the same
    (start, coefficients) as the JAX package's BodyEphemeris."""
    from ephemeris_explorer_tpu.ephemeris import BodyEphemeris as JBody

    j, _, _ = sem
    moon = jgenerate(j.state, j.settings, JDuration.from_days(40.0), precision="f64")["Moon"]
    coeffs = np.asarray(moon.coeffs)
    i = moon.interval_s

    def pair():
        return (JBody(moon.start_s, i, coeffs.copy()), eph.BodyEphemeris(moon.start_s, i, coeffs.copy()))

    def same(jb, tb):
        assert tb.start_s == jb.start_s and tb.end_s == jb.end_s
        np.testing.assert_array_equal(tb.coeffs, jb.coeffs)

    t_mid = moon.start_s + 7.5 * i
    for edit in (lambda b: b.clear_after(t_mid), lambda b: b.clear_before(t_mid),
                 lambda b: b.clear_after(moon.start_s - 1.0),
                 lambda b: b.push_back(coeffs[:2]), lambda b: b.push_front(coeffs[:3])):
        jb, tb = pair()
        edit(jb)
        edit(tb)
        same(jb, tb)
    jb, tb = pair()
    for t in (t_mid, moon.start_s + 3 * i, moon.end_s, moon.end_s + 1.0):
        assert tb.contains(t) == jb.contains(t)
    same(jb.between(t_mid, t_mid + 4 * i), tb.between(t_mid, t_mid + 4 * i))
    jb.append(JBody(jb.end_s, i, coeffs[:2].copy()))
    tb.append(eph.BodyEphemeris(tb.end_s, i, coeffs[:2].copy()))
    same(jb, tb)
