"""The port's SOI assignment, transitions, apsides and analysis against the
JAX package's.

Every case of ``test_events.py`` runs on the port (``device="cpu"``) against
the JAX package's own ephemeris coefficients, carried across with
``interop.ephemeris_from``.  The scanner is numpy in both packages, so on
the same trajectory and the same packed coefficients the port's transitions
and apsides equal the JAX package's bitwise (:func:`_events_both`: the port
scans its torch pack through its host mirror, the JAX package the same
numbers as numpy arrays).  SOI assignment, hierarchies and segmentations
are equal; the closest-approach searches are equal on the same callables.
"""

from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import analysis as janalysis
from ephemeris_explorer_tpu import events as jevents
from ephemeris_explorer_tpu.ephemeris import PackedEphemeris as JPackedEphemeris
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris as jgenerate
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu.spacecraft import build_timeline as jbuild_timeline
from ephemeris_explorer_tpu_torch import Duration, Epoch, analysis, events, interop
from ephemeris_explorer_tpu_torch.ephemeris import generate_ephemeris
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.io.scene import Ship, ShipBurn
from ephemeris_explorer_tpu_torch.spacecraft import build_timeline, propagate_ship

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"
CPU = "cpu"


@pytest.fixture(scope="module")
def ctx():
    j = jscene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    jeph = jgenerate(j.state, j.settings, JDuration.from_days(40.0))
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    eph = interop.ephemeris_from(jeph)
    soi = analysis.assign_soi(sc.state)
    return sc, eph, soi, j, jeph


def _apsides_key(aps):
    return [(a.time, a.body, a.distance, a.periapsis) for a in aps]


def _events_both(traj, packed, radii):
    """The port's transitions and apsides, held bitwise to the JAX package's
    on the same trajectory and the same packed coefficients."""
    tr = events.soi_transitions(traj, packed, radii)
    aps = events.apsides(traj, packed, tr)
    jpacked = JPackedEphemeris(*(x.numpy() for x in packed))
    jtr = jevents.soi_transitions(traj, jpacked, radii)
    assert tr == jtr
    assert _apsides_key(aps) == _apsides_key(jevents.apsides(traj, jpacked, jtr))
    return tr, aps


def test_assign_soi(ctx):
    sc, eph, soi, j, _ = ctx
    i_sun = sc.state.body_index("Sun")
    i_earth = sc.state.body_index("Earth")
    i_moon = sc.state.body_index("Moon")
    assert np.isinf(soi.radii[i_sun])
    assert soi.parent[i_earth] == i_sun
    assert soi.parent[i_moon] == i_earth
    # Earth's SOI ~ 9.2e5 km; Moon's ~ 6.6e4 km
    assert 8e5 < soi.radii[i_earth] < 1.1e6
    assert 5e4 < soi.radii[i_moon] < 8e4
    assert soi.depth[i_sun] == 0 and soi.depth[i_earth] == 1 and soi.depth[i_moon] == 2
    jsoi = janalysis.assign_soi(j.state)
    for field in ("radii", "depth", "parent"):
        np.testing.assert_array_equal(getattr(soi, field), getattr(jsoi, field))


def test_hierarchy(ctx):
    sc, eph, soi, j, jeph = ctx
    t = sc.state.epoch.as_offset_seconds() + 86400.0
    h = analysis.hierarchy_at(eph, soi, t)
    i_sun = sc.state.body_index("Sun")
    i_earth = sc.state.body_index("Earth")
    i_moon = sc.state.body_index("Moon")
    assert h[i_moon] == i_earth
    assert h[i_earth] == i_sun
    assert h[i_sun] == -1
    assert h == janalysis.hierarchy_at(jeph, janalysis.assign_soi(j.state), t)


def test_soi_transitions_and_apsides(ctx):
    """An Earth-orbiting ship: stays in Earth SOI, periapses/apoapses detected."""
    sc, eph, soi, _, _ = ctx
    ship = sc.ships[0]  # Earth Station, elliptical-ish Earth orbit
    traj = propagate_ship(eph, ship, device=CPU)
    tr, aps = _events_both(traj, eph.pack(CPU), soi.radii)

    i_earth = sc.state.body_index("Earth")
    assert len(tr) >= 1
    assert tr[0][1] == i_earth  # starts inside Earth's SOI
    assert all(b == i_earth for _, b in tr)  # never leaves over 3 days

    # ~7000 km orbit with ~1.6h period over 3 days: tens of apsides
    assert len(aps) >= 10
    for a in aps:
        assert a.body == i_earth
        assert 5e3 < a.distance < 1e5
    kinds = {a.periapsis for a in aps}
    assert kinds == {True, False}
    # alternating peri/apo
    for x, y in zip(aps, aps[1:]):
        assert x.periapsis != y.periapsis
        assert y.time > x.time


def test_escape_transition(ctx):
    """A huge burn escapes Earth's SOI; transitions show Earth -> Sun."""
    sc, eph, soi, _, _ = ctx
    base = sc.ships[0]
    t0 = base.start.as_offset_seconds()
    ship = Ship(
        name="Escaper",
        integrator="Verner87",
        tolerance=1e-3,
        start=base.start,
        end=Epoch.from_offset_seconds(t0 + 20 * 86400.0),
        position=base.position,
        velocity=base.velocity,
        burns=[
            ShipBurn(
                start=Epoch.from_offset_seconds(t0 + 600.0),
                duration=Duration.from_seconds(600.0),
                acceleration=np.array([8e-3, 0.0, 0.0]),
                reference="Earth",
            )
        ],
    )
    traj = propagate_ship(eph, ship, device=CPU)
    tr, _ = _events_both(traj, eph.pack(CPU), soi.radii)
    i_earth = sc.state.body_index("Earth")
    i_sun = sc.state.body_index("Sun")
    bodies = [b for _, b in tr]
    assert bodies[0] == i_earth
    assert i_sun in bodies, f"expected escape to Sun SOI, got {tr}"

    # segmentation: Earth segment then Sun segment; Earth span is an Escape
    names = [b.name for b in sc.state.bodies]
    kw = dict(soi_parent_of=lambda b, t: int(soi.parent[b]), start=traj.start_s, end=traj.end_s)
    segs = analysis.segment_trajectory(tr, None, names, **kw)
    names_seg = [s.name for s in segs]
    assert any("Earth Escape" in n for n in names_seg), names_seg
    assert any("Sun" in n for n in names_seg), names_seg
    jsegs = janalysis.segment_trajectory(tr, None, names, **kw)
    assert [(s.start, s.end, s.body, s.name) for s in segs] == [
        (s.start, s.end, s.body, s.name) for s in jsegs]


def test_closest_separation(ctx):
    sc, eph, soi, _, _ = ctx
    ship = sc.ships[0]
    traj = propagate_ship(eph, ship, device=CPU)
    args = (traj.position, eph["Moon"].position, traj.start_s, traj.end_s)
    t = analysis.closest_separation(*args, precision=1.0)
    assert t is not None and traj.start_s <= t <= traj.end_s
    assert t == janalysis.closest_separation(*args, precision=1.0)


def test_relative_trajectory(ctx):
    sc, eph, soi, _, _ = ctx
    rel = analysis.RelativeTrajectory(eph["Moon"], eph["Earth"])
    t = rel.start_s + (rel.end_s - rel.start_s) / 2
    p = rel.position(t)
    assert 3.4e5 < np.linalg.norm(p) < 4.2e5  # Moon-Earth distance
    pv = rel.state_vector(t)
    assert np.linalg.norm(pv[1]) < 1.2e0  # relative speed ~1 km/s
    tmin = rel.closest_separation(precision=1.0)
    assert tmin is not None and rel.contains(tmin)
    # bounds are the intersection
    assert rel.start_s == max(eph["Moon"].start_s, eph["Earth"].start_s)
    jrel = janalysis.RelativeTrajectory(eph["Moon"], eph["Earth"])
    assert (jrel.start_s, jrel.end_s) == (rel.start_s, rel.end_s)
    np.testing.assert_array_equal(jrel.position(t), p)
    assert jrel.closest_separation(precision=1.0) == tmin


@pytest.mark.parametrize("transitions, want", [
    # single span, no transitions around it -> Orbit
    ([(0.0, 1)], [("Orbit", 1)]),
    # Earth -> Moon -> Earth: the Moon span is a Flyby (entered from and
    # leaving to its SOI parent)
    ([(0.0, 1), (100.0, 2), (200.0, 1)], ("Flyby", 2)),
    # Earth -> Moon (stays): Capture
    ([(0.0, 1), (100.0, 2)], ("Capture", 2)),
    # Moon -> Earth (leaves to parent): the Moon span is an Escape
    ([(0.0, 2), (100.0, 1)], ("Escape", 2)),
    # Sun -> Moon -> Sun: Moon entered NOT from its parent -> Transit
    ([(0.0, 0), (100.0, 2), (200.0, 0)], ("Transit", 2)),
])
def test_segment_classification_branches(transitions, want):
    """All Capture/Escape/Flyby/Transit/Orbit branches (analysis.rs:279-296),
    the same in both packages."""
    names = ["Sun", "Earth", "Moon"]
    parent = {0: -1, 1: 0, 2: 1}  # Moon's SOI parent = Earth
    kinds = {}
    for mod in (analysis, janalysis):
        segs = mod.segment_trajectory(transitions, None, names, lambda b, t: parent[b],
                                      start=0.0, end=1000.0)
        kinds[mod] = [(s.kind.value, s.body) for s in segs]
    got = kinds[analysis]
    assert got == kinds[janalysis]
    if isinstance(want, list):
        assert got == want
    else:
        assert want in got


def test_segment_burn_subdivision():
    from ephemeris_explorer_tpu import Epoch as JEpoch
    from ephemeris_explorer_tpu.io.scene import ShipBurn as JShipBurn

    names = ["Sun", "Earth"]
    index = {"Earth": 1, "Sun": 0}
    tl = build_timeline(
        [ShipBurn(
            start=Epoch.from_offset_seconds(100.0),
            duration=Duration.from_seconds(50.0),
            acceleration=np.array([1e-2, 0, 0]),
            reference="Earth",
        )],
        index,
    )
    segs = analysis.segment_trajectory(
        [(0.0, 1)], tl, names, lambda b, t: 0, start=0.0, end=1000.0
    )
    # coast + burn + coast pieces, burn flagged and named "... Burn"
    assert [s.burn for s in segs] == [False, True, False]
    assert "Burn" in segs[1].name
    assert segs[1].start == 100.0 and segs[1].end == 150.0
    jtl = jbuild_timeline(
        [JShipBurn(start=JEpoch.from_offset_seconds(100.0),
                   duration=JDuration.from_seconds(50.0),
                   acceleration=np.array([1e-2, 0, 0]), reference="Earth")],
        index,
    )
    jsegs = janalysis.segment_trajectory([(0.0, 1)], jtl, names, lambda b, t: 0,
                                         start=0.0, end=1000.0)
    assert [(s.start, s.end, s.burn, s.name) for s in segs] == [
        (s.start, s.end, s.burn, s.name) for s in jsegs]


def test_apsis_times_match_kepler_closed_form():
    """Apsis epochs/distances vs the two-body closed form.

    A ship on an eccentric Kepler orbit around a lone central body has
    periapsis passages at t0 + k*T and apoapsides at t0 + (k + 1/2)*T with
    T = 2*pi*sqrt(a^3/mu); detected events must hit those to sub-second
    accuracy (bisection precision is 1e-3 s; the integrator and Hermite
    interpolation own the rest).  Closed-form analogue of the radial-velocity
    zero crossings in dynamics/spacecraft.rs:566-583.  The port generates
    and flies here; its events equal the JAX package's scan of the same
    inputs bitwise.
    """
    mu = 398600.4418
    a, e = 9000.0, 0.35
    T = 2.0 * np.pi * np.sqrt(a**3 / mu)
    r_p = a * (1.0 - e)
    v_p = np.sqrt(mu * (1.0 + e) / (a * (1.0 - e)))

    epoch = Epoch.from_offset_seconds(0.0)
    state = scene.SolarSystemState(
        "TwoBody",
        epoch,
        [scene.Body("Star", mu, np.zeros(3), np.zeros(3))],
    )
    settings = scene.EphemeridesSettings(
        Duration.from_seconds(600.0),
        {"Star": scene.InterpolationParameters(degree=6, count=1)},
    )
    eph = generate_ephemeris(state, settings, Duration.from_days(1.5), device=CPU)
    packed = eph.pack(CPU)
    soi = analysis.assign_soi(state)

    n_periods = 3
    ship = Ship(
        name="Kepler",
        integrator="Verner87",
        tolerance=1e-9,
        start=epoch,
        end=Epoch.from_offset_seconds((n_periods + 0.2) * T),
        position=np.array([r_p, 0.0, 0.0]),
        velocity=np.array([0.0, v_p, 0.0]),
    )
    traj = propagate_ship(eph, ship, device=CPU)

    tr, aps = _events_both(traj, packed, soi.radii)
    assert [b for _, b in tr] == [0]
    assert len(aps) >= 2 * n_periods  # alternating apo/peri over 3 periods

    for ap in aps:
        k = round((ap.time - epoch.as_offset_seconds()) / (T / 2.0))
        t_exact = epoch.as_offset_seconds() + k * (T / 2.0)
        assert abs(ap.time - t_exact) < 0.5, (ap, t_exact)
        want_peri = k % 2 == 0
        assert ap.periapsis == want_peri
        r_exact = r_p if want_peri else a * (1.0 + e)
        # km: Hermite knots every 600 s put ~1 m of interpolation error at
        # the periapsis speed; 5 m bounds it with margin
        assert abs(ap.distance - r_exact) < 5e-3, (ap, r_exact)


def test_host_mirror_one_copy_per_pack(ctx):
    """The scanner mirrors a torch pack to the host once per pack snapshot
    (cached on its coefficient tensor); a numpy pack is read in place."""
    _, eph, _, _, _ = ctx
    packed = eph.pack(CPU)
    h1 = events._host(packed)
    assert events._host(packed) is h1
    assert events._host(eph.pack(CPU)) is not h1
    for x, y in zip(h1, packed):
        np.testing.assert_array_equal(x, y.numpy())
    npacked = JPackedEphemeris(*(x.numpy() for x in packed))
    assert events._host(npacked).coeffs is npacked.coeffs
