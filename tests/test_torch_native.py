"""The port's native host runtime loader against Python and the JAX package.

Every case of ``test_native.py`` runs on the port against the JAX package's
own ephemeris coefficients (``interop.ephemeris_from``), with the reference's
tolerances against the port's Python evaluation.  Both packages load the same
C++ source (``native/eet_native.cpp``); the port builds its own library from
it and never calls the JAX package's loader, which builds in place.  The
library must build where the tests run: ``available()`` is asserted, not
skipped on, so a broken build shows.
"""

from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import native as jnative
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris as jgenerate
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu_torch import interop, native
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.plot import PlotPoints
from ephemeris_explorer_tpu_torch.spacecraft import propagate_ship

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"


@pytest.fixture(scope="module")
def ctx():
    j = jscene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    jeph = jgenerate(j.state, j.settings, JDuration.from_days(40.0))
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    return sc, interop.ephemeris_from(jeph)


def test_native_library_builds():
    """The port's loader builds and loads the shared C++ runtime."""
    assert native.available()
    assert native._SO.exists() and native._SRC == jnative._SRC


def test_spline_eval_matches(ctx):
    sc, eph = ctx
    ne = native.NativeEphemeris(eph)
    rng = np.random.default_rng(0)
    t0 = sc.state.epoch.as_offset_seconds()
    times = t0 + rng.uniform(0, 24 * 86400.0, 500)
    pos, vel, ok = ne.eval_batch(times)
    assert ok.all()
    for i in (0, 123, 499):
        for b, name in enumerate(eph.names):
            p, v = eph[name].state_vector(times[i])
            np.testing.assert_allclose(pos[i, b], p, rtol=0, atol=1e-9)
            np.testing.assert_allclose(vel[i, b], v, rtol=0, atol=1e-12)
    # coverage flags: out-of-bounds -> ok false
    _, _, ok2 = ne.eval_batch(np.array([t0 - 100.0]))
    assert not ok2.any()


def test_hermite_eval_matches(ctx):
    sc, eph = ctx
    traj = propagate_ship(eph, sc.ships[0], device="cpu")
    times = np.linspace(traj.start_s, traj.end_s, 300)
    pos, vel, ok = native.hermite_eval_batch(traj, times)
    assert ok.all()
    for i in (0, 150, 299):
        p, v = traj.state_vector(times[i])
        np.testing.assert_allclose(pos[i], p, rtol=0, atol=1e-9)
        np.testing.assert_allclose(vel[i], v, rtol=0, atol=1e-12)


def test_native_polyline_matches_python(ctx):
    sc, eph = ctx
    ne = native.NativeEphemeris(eph)
    moon = eph["Moon"]
    cam = np.array([0.0, 0.0, 5e8])
    t0, t1 = moon.start_s, moon.start_s + 20 * 86400.0
    nt, npts = ne.plot_polyline("Moon", t0, t1, cam, 2e-5)

    def eval_sv(t):
        sv = moon.state_vector(t)
        return None if sv is None else sv

    py = PlotPoints.build(eval_sv, t0, t1, cam, 2e-5)
    assert len(nt) == len(py.times)
    np.testing.assert_allclose(nt, py.times, rtol=1e-12)
    np.testing.assert_allclose(npts, py.points, rtol=1e-12)

    # picking agrees too
    target = npts[len(npts) // 2]
    d = target - cam
    d = d / np.linalg.norm(d)
    hits_n = native.ray_distances(nt, npts, cam, d)
    hits_p = py.ray_distances(cam, d)
    assert len(hits_n) == len(hits_p)
    np.testing.assert_allclose(
        np.array(hits_n), np.array(hits_p), rtol=1e-9, atol=1e-6
    )
