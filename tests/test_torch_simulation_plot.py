"""The port's simulation clock, warp, scene evaluation and plotting against
the JAX package's.

Every case of ``test_simulation_plot.py`` runs on the port against the JAX
package's own ephemeris coefficients (``interop.ephemeris_from``).  Both
modules are numpy, so the clocks, warps and polylines are equal on the same
inputs; the scene evaluation agrees within 1e-14 of each value (the two
packages evaluate the spline polynomials with torch and jnp respectively).
"""

from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import Epoch as JEpoch
from ephemeris_explorer_tpu import plot as jplot
from ephemeris_explorer_tpu import simulation as jsim
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris as jgenerate
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu.spacecraft import HermiteTrajectory as JHermiteTrajectory
from ephemeris_explorer_tpu_torch import Epoch, interop
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.plot import PlotPoints
from ephemeris_explorer_tpu_torch.simulation import (
    SimulationClock,
    Warp,
    cubic_ease_in_out,
    evaluate_scene,
)
from ephemeris_explorer_tpu_torch.spacecraft import propagate_ship

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"


@pytest.fixture(scope="module")
def ctx():
    j = jscene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    jeph = jgenerate(j.state, j.settings, JDuration.from_days(40.0))
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    return sc, interop.ephemeris_from(jeph), jeph


def _jepoch(e):
    return JEpoch.from_offset_seconds(e.as_offset_seconds())


def test_clock_bounds_and_advance(ctx):
    sc, eph, jeph = ctx
    clock = SimulationClock(current=sc.state.epoch, time_scale=3600.0)
    clock.sync_bounds([eph[n] for n in eph.names])
    assert clock.start.as_offset_seconds() == sc.state.epoch.as_offset_seconds()
    clock.advance(1.0)
    assert clock.current.as_offset_seconds() == sc.state.epoch.as_offset_seconds() + 3600.0
    jclock = jsim.SimulationClock(current=_jepoch(sc.state.epoch), time_scale=3600.0)
    jclock.sync_bounds([jeph[n] for n in jeph.names])
    jclock.advance(1.0)
    assert (clock.start.as_offset_seconds(), clock.end.as_offset_seconds()) == (
        jclock.start.as_offset_seconds(), jclock.end.as_offset_seconds())
    # clamped at the end
    clock.advance(1e9)
    assert clock.current.as_offset_seconds() == clock.end.as_offset_seconds()


def test_auto_extend_trigger(ctx):
    sc, eph, jeph = ctx
    requests = []
    for cls, e, epoch in ((SimulationClock, eph, Epoch), (jsim.SimulationClock, jeph, JEpoch)):
        clock = cls(current=epoch.from_offset_seconds(sc.state.epoch.as_offset_seconds()),
                    time_scale=86400.0)
        clock.sync_bounds([e[n] for n in e.names])
        clock.set_time(epoch.from_offset_seconds(clock.end.as_offset_seconds() - 1000.0))
        req = clock.auto_extend_span()
        assert req is not None
        span, direction = req
        assert direction == +1
        assert span.as_seconds() == 2 * 5.0 * 86400.0
        requests.append((span.as_seconds(), direction))
    assert requests[0] == requests[1]


def test_warp_easing(ctx):
    sc, eph, jeph = ctx
    runs = []
    for cls, warp_cls, e, epoch in ((SimulationClock, Warp, eph, Epoch),
                                    (jsim.SimulationClock, jsim.Warp, jeph, JEpoch)):
        clock = cls(current=epoch.from_offset_seconds(sc.state.epoch.as_offset_seconds()))
        clock.sync_bounds([e[n] for n in e.names])
        target = epoch.from_offset_seconds(sc.state.epoch.as_offset_seconds() + 10 * 86400.0)
        warp = warp_cls(clock, target)
        assert clock.paused
        path = []
        while not warp.done:
            path.append(warp.tick(0.1).as_offset_seconds())
        assert not clock.paused
        assert abs(clock.current.as_offset_seconds() - target.as_offset_seconds()) < 1e-6
        runs.append(path)
    assert runs[0] == runs[1]
    assert cubic_ease_in_out(0.0) == 0.0 and cubic_ease_in_out(1.0) == 1.0
    x = np.linspace(0.0, 1.0, 11)
    assert [cubic_ease_in_out(v) for v in x] == [jsim.cubic_ease_in_out(v) for v in x]


def test_evaluate_scene(ctx):
    sc, eph, jeph = ctx
    ship_traj = propagate_ship(eph, sc.ships[0], device="cpu")
    at = Epoch.from_offset_seconds(ship_traj.start_s + 3600.0)
    out = evaluate_scene(eph, {"Earth Station": ship_traj}, at)
    assert set(out) == {"Sun", "Earth", "Moon", "Earth Station"}
    # out-of-span ships are omitted, bodies still present
    out2 = evaluate_scene(eph, {"Earth Station": ship_traj},
                          Epoch.from_offset_seconds(ship_traj.end_s + 86400.0))
    assert "Earth Station" not in out2 and "Earth" in out2
    # the JAX package's evaluation of the same coefficients and trajectory
    jtraj = JHermiteTrajectory(ts=ship_traj.ts, pos=ship_traj.pos, vel=ship_traj.vel)
    jout = jsim.evaluate_scene(jeph, {"Earth Station": jtraj}, _jepoch(at))
    assert set(jout) == set(out)
    for name, (p, v) in out.items():
        np.testing.assert_allclose(p, jout[name][0], rtol=1e-14, atol=0)
        np.testing.assert_allclose(v, jout[name][1], rtol=1e-14, atol=0)


def test_plot_polyline_and_picking(ctx):
    sc, eph, jeph = ctx
    moon = eph["Moon"]

    def eval_sv(t):
        sv = moon.state_vector(t)
        return None if sv is None else (sv[0], sv[1])

    cam = np.array([0.0, 0.0, 5e8])
    args = (eval_sv, moon.start_s, moon.start_s + 27.3 * 86400.0, cam)
    pts = PlotPoints.build(*args, tan2_angular_resolution=2e-5, max_points=5000)
    # one lunar orbit resolved by a modest number of adaptive points
    assert 10 < len(pts.times) < 5000
    assert np.all(np.diff(pts.times) > 0)
    # polyline approximates the true trajectory within the angular budget
    tm = (pts.times[0] + pts.times[-1]) / 2
    approx = pts.evaluate(tm)
    exact = moon.position(tm)
    assert np.linalg.norm(approx - exact) < 5e4

    # picking: a ray straight at the mid point comes close to the polyline
    target = pts.evaluate(tm)
    direction = target - cam
    direction = direction / np.linalg.norm(direction)
    hits = pts.ray_distances(cam, direction)
    assert hits
    assert min(h[1] for h in hits) < 5e4

    # the JAX package's polyline and picking on the same evaluator are equal
    jpts = jplot.PlotPoints.build(*args, tan2_angular_resolution=2e-5, max_points=5000)
    np.testing.assert_array_equal(pts.times, jpts.times)
    np.testing.assert_array_equal(pts.points, jpts.points)
    assert hits == jpts.ray_distances(cam, direction)
