"""The port's Universe, FlightPlan and PredictionTask against the JAX package's.

Every case of ``test_api.py`` runs on the port (``device="cpu"``) and the
same operations run on the JAX package beside it.  Tolerances:

* generation inside a Universe: the same segment layout, coefficients
  <= 1e-12 of max|position| in sample space (the bar of
  ``test_torch_ephemeris.py::test_generation_matches_jax``; backward
  segments against the backward fit matrices);
* ships: the port flies against the JAX package's own coefficients, carried
  across with ``interop.ephemeris_from`` (:func:`_jax_bits`), so both fly
  against the same bits; then the spacecraft port's bars hold
  (``test_torch_spacecraft.py``):
  the same knot count and positions within 1e-2 km at 0.1, 0.5 and 0.9 of
  the span;
* events of those flights: the same bodies in the same order and event
  times within 1 s (the flights themselves differ by < 1e-2 km; bitwise
  events on the same trajectory are ``test_torch_events.py``'s);
* the interpolation audit on the same coefficients: per body within 1e-3 m
  or 1% of the JAX package's metres, whichever is larger;
* host-only objects (flight plans, event containers, rotations, exports of
  ship configs): equal.

Measured gaps go into the junit XML report (``record``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import Epoch as JEpoch
from ephemeris_explorer_tpu import api as japi
from ephemeris_explorer_tpu.integrators.adaptive import AdaptiveParams as JAdaptiveParams
from ephemeris_explorer_tpu.ops.polyfit import fit_matrix
from ephemeris_explorer_tpu_torch import Duration, Epoch, interop
from ephemeris_explorer_tpu_torch.api import (
    Burn,
    ExplorerSession,
    FlightPlan,
    PredictionTask,
    Universe,
    interpolation_error,
)
from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams
from ephemeris_explorer_tpu_torch.io import scene as scene_io

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"
SEM = SYSTEMS / "sun_earth_moon_2433282.5"
CPU = "cpu"
GEN_BAR = 1e-12
PORT_VS_JAX_KM = 1e-2
EVENT_S = 1.0


@pytest.fixture
def record(request):
    """record(name, value): a measured value into the junit XML report."""
    return lambda name, value: request.node.user_properties.append((name, value))


@pytest.fixture()
def uni():
    u = Universe.load(SEM, device=CPU)
    u.generate(Duration.from_days(40.0))
    return u


@pytest.fixture()
def juni():
    j = japi.Universe.load(SEM)
    j.generate(JDuration.from_days(40.0))
    return j


def _jax_bits(u, j):
    """Give the port's universe the JAX package's coefficients (same bits)."""
    u.ephemeris.bodies = interop.ephemeris_from(j.ephemeris).bodies


def _jepoch(e):
    return JEpoch.from_offset_seconds(e.as_offset_seconds())


def _burns(t_start, dur_s, acc, ref="Earth"):
    """The same burn for both packages: (port Burn, JAX Burn)."""
    return (Burn(start=Epoch.from_offset_seconds(t_start), duration=Duration.from_seconds(dur_s),
                 acceleration=np.asarray(acc, dtype=np.float64), reference=ref),
            japi.Burn(start=JEpoch.from_offset_seconds(t_start),
                      duration=JDuration.from_seconds(dur_s),
                      acceleration=np.asarray(acc, dtype=np.float64), reference=ref))


def _sample_space_err(u, j):
    """Worst per-body coefficient difference in sample space (forward and
    backward segments against their own fit matrices) over max|position|."""
    t0 = u.state.epoch.as_offset_seconds()
    worst = 0.0
    for n in u.names:
        a, b = u.ephemeris[n], j.ephemeris[n]
        assert (a.start_s, a.interval_s, a.segment_count) == (
            b.start_s, b.interval_s, b.segment_count), n
        k = int(round((t0 - a.start_s) / a.interval_s))  # backward segments first
        ca, cb = a.coeffs, np.asarray(b.coeffs)
        scale = np.abs(cb[:, 0]).max()
        deg = u.settings.settings[n].degree
        for part, backward in ((slice(0, k), True), (slice(k, None), False)):
            pa, pb = ca[part], cb[part]
            if not pa.size:
                continue
            norm = np.abs(fit_matrix(deg, backward)).sum(1)
            rows = norm > 0
            d = np.abs(pa - pb).max(axis=(0, 2))[rows] / norm[rows]
            worst = max(worst, float(d.max() / scale))
    return worst


def _flight_km(traj, jtraj):
    return max(float(np.abs(traj.position(t) - jtraj.position(t)).max())
               for t in (jtraj.start_s + f * (jtraj.end_s - jtraj.start_s) for f in (0.1, 0.5, 0.9)))


def _assert_flight_matches(traj, jtraj, record, tag=""):
    """The spacecraft port's bars: the same knot count, 1e-2 km at 0.1,
    0.5 and 0.9 of the span."""
    assert len(traj.ts) == len(jtraj.ts), (len(traj.ts), len(jtraj.ts))
    km = _flight_km(traj, jtraj)
    assert km < PORT_VS_JAX_KM, km
    record(f"knots{tag}", len(traj.ts))
    record(f"km_vs_jax{tag}", f"{km:.3g}")


def _assert_events_match(entry, jentry, record):
    tr, jtr = list(entry.transitions), list(jentry.transitions)
    assert [b for _, b in tr] == [b for _, b in jtr]
    ap, jap = list(entry.apsides), list(jentry.apsides)
    assert [(a.body, a.periapsis) for a in ap] == [(a.body, a.periapsis) for a in jap]
    dt = max([abs(x[0] - y[0]) for x, y in zip(tr, jtr)]
             + [abs(x.time - y.time) for x, y in zip(ap, jap)], default=0.0)
    assert dt < EVENT_S, dt
    record("event_dt_s", f"{dt:.3g}")


def test_generate_and_extend(uni, juni, record):
    t0 = uni.state.epoch
    assert uni.ephemeris.contains(t0.as_offset_seconds() + 86400.0)
    end0 = uni.ephemeris.end
    # extend forward incrementally: bounds advance without regeneration
    uni.extend(Duration.from_days(30.0))
    assert uni.ephemeris.end.as_offset_seconds() > end0.as_offset_seconds()
    # the overlap region is unchanged
    mid = t0.as_offset_seconds() + 20 * 86400.0
    assert uni.ephemeris.positions(mid) is not None
    juni.extend(JDuration.from_days(30.0))
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("sample_space_err", f"{err:.3g}")


def test_backward_extension(uni, juni, record):
    t0 = uni.state.epoch.as_offset_seconds()
    uni.extend(Duration.from_days(30.0), direction=-1)
    p = uni.ephemeris.positions(t0 - 20 * 86400.0)
    assert p is not None
    juni.extend(JDuration.from_days(30.0), direction=-1)
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("sample_space_err", f"{err:.3g}")


def test_background_task_controls(uni, juni, record):
    task = uni.extend(Duration.from_days(60.0), background=True)
    task.pause()
    assert task.paused
    task.resume()
    task.join(timeout=300)
    assert not task.in_progress
    assert task.progress == 1.0
    # the same span as the JAX package's task (its tail chunk bucketed alike)
    jtask = juni.extend(JDuration.from_days(60.0), background=True)
    jtask.join(timeout=300)
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("sample_space_err", f"{err:.3g}")


def test_background_task_error_surfaces_on_join(uni):
    """An exception in the worker is raised again by join(), not swallowed."""
    prop = uni._propagator(+1)

    def boom(n):
        raise RuntimeError("chunk failed")

    prop.step_chunk = boom
    task = PredictionTask(prop, uni.ephemeris, uni.lock, prop.steps_done + 1000).start()
    with pytest.raises(RuntimeError, match="chunk failed"):
        task.join(timeout=60)
    assert not task.in_progress


def test_export_roundtrip(uni, juni, tmp_path, record):
    at = Epoch.from_offset_seconds(uni.state.epoch.as_offset_seconds() + 10 * 86400.0)
    snap = uni.export_state(at)
    path = tmp_path / "state.json"
    scene_io.save_state(snap, path)
    re = scene_io.load_state(path)
    assert [b.name for b in re.bodies] == uni.names
    assert str(re.epoch) == str(at)
    # the snapshot is a valid initial state: positions match the spline
    np.testing.assert_allclose(
        re.bodies[1].position, uni.ephemeris[uni.names[1]].position(at), rtol=0, atol=1e-9
    )
    # on the same coefficients the JAX package exports the same state
    _jax_bits(uni, juni)
    snap = uni.export_state(at)
    jsnap = juni.export_state(_jepoch(at))
    gap = 0.0
    for b, jb in zip(snap.bodies, jsnap.bodies):
        assert b.name == jb.name and b.mu == jb.mu
        np.testing.assert_allclose(b.position, jb.position, rtol=1e-15, atol=0)
        np.testing.assert_allclose(b.velocity, jb.velocity, rtol=1e-14, atol=0)
        gap = max(gap, float(np.abs(b.position - jb.position).max()))
    record("position_gap_km", f"{gap:.3g}")


def test_flight_plan_overlap_and_dv():
    results = []
    for mod, params, epoch, duration, burn_cls, plan_cls in (
        ("port", AdaptiveParams(), Epoch, Duration, Burn, FlightPlan),
        ("jax", JAdaptiveParams(), JEpoch, JDuration, japi.Burn, japi.FlightPlan),
    ):
        fp = plan_cls(method="Verner87", params=params, end=epoch.from_offset_seconds(1e6))
        b1 = burn_cls(
            start=epoch.from_offset_seconds(0.0),
            duration=duration.from_seconds(100.0),
            acceleration=np.array([1e-2, 0, 0]),
            reference="Earth",
        )
        b2 = burn_cls(
            start=epoch.from_offset_seconds(50.0),
            duration=duration.from_seconds(100.0),
            acceleration=np.array([0, 1e-2, 0]),
            reference="Earth",
        )
        fp.add_burn(b1)
        fp.add_burn(b2)
        fp.compute_overlaps()
        assert b1.overlaps and b2.overlaps
        assert fp.total_delta_v() == 0.0  # overlapping burns are inactive
        fp.remove_burn(b2.id)
        fp.compute_overlaps()
        assert not b1.overlaps
        assert abs(fp.total_delta_v() - 1.0) < 1e-12
        results.append((fp.total_delta_v(), b1.delta_v(), b2.delta_v()))
    assert results[0] == results[1]


def test_replan_incremental(uni, juni, record):
    _jax_bits(uni, juni)
    ship, jship = uni.scene.ships[0], juni.scene.ships[0]
    entry = uni.spawn_ship(ship)
    jentry = juni.spawn_ship(jship)
    traj1 = entry.trajectory
    n1 = len(traj1.ts)
    assert n1 > 10
    _assert_flight_matches(traj1, jentry.trajectory, record, "_first")

    # add a burn near the end: replan restarts from the last common event
    t_burn = traj1.start_s + 0.8 * (traj1.end_s - traj1.start_s)
    burn, jburn = _burns(t_burn, 60.0, [1e-3, 0, 0])
    entry.plan.add_burn(burn)
    jentry.plan.add_burn(jburn)
    before = traj1.pos[: n1 // 2].copy()
    uni.replan(ship.name)
    juni.replan(jship.name)
    traj2 = uni.ships[ship.name].trajectory
    # early knots unchanged (incremental restart preserved them)
    np.testing.assert_array_equal(traj2.pos[: n1 // 2], before)
    # trajectory diverges after the burn
    assert traj2.end_s >= traj1.end_s - 1.0
    _assert_flight_matches(traj2, juni.ships[jship.name].trajectory, record, "_replanned")


def test_replan_preserves_pre_restart_events(uni, juni, record):
    """Incremental replans maintain the event containers with clear_after +
    insert (dynamics/spacecraft.rs:331-361,427-446): events strictly before
    the restart epoch survive OBJECT-IDENTICALLY, not recomputed."""
    _jax_bits(uni, juni)
    ship, jship = uni.scene.ships[0], juni.scene.ships[0]
    entry = uni.spawn_ship(ship, propagate_now=False)
    jentry = juni.spawn_ship(jship, propagate_now=False)
    span = ship.end.as_offset_seconds() - ship.start.as_offset_seconds()
    # an existing early burn so a later change restarts AFTER it (adding a
    # burn to a burn-less plan always diverges at the first coast segment
    # and is a legitimate full restart)
    t_b1 = ship.start.as_offset_seconds() + 0.2 * span
    burn, jburn = _burns(t_b1, 60.0, [5e-4, 0, 0])
    entry.plan.add_burn(burn)
    jentry.plan.add_burn(jburn)
    uni.replan(ship.name)
    juni.replan(jship.name)
    traj1 = entry.trajectory
    assert len(entry.transitions) >= 1
    assert len(entry.apsides) >= 1

    # restart epoch will be the end of burn 1 (the last common timeline event)
    t_restart = t_b1 + 60.0
    t_burn2 = traj1.start_s + 0.8 * (traj1.end_s - traj1.start_s)
    pre_tr = [e for e in entry.transitions if e[0] <= t_restart]
    pre_ap = [a for a in entry.apsides if a.time <= t_restart]
    pre_tr_ids = [id(e) for e in pre_tr]
    pre_ap_ids = [id(a) for a in pre_ap]
    assert pre_ap, "fixture ship should have apsides before the restart"

    burn, jburn = _burns(t_burn2, 60.0, [1e-3, 0, 0])
    entry.plan.add_burn(burn)
    jentry.plan.add_burn(jburn)
    uni.replan(ship.name)
    juni.replan(jship.name)
    # everything at/before the restart must be the same tuples/objects
    got_tr = [e for e in entry.transitions if e[0] <= t_restart]
    got_ap = [a for a in entry.apsides if a.time <= t_restart]
    assert [id(e) for e in got_tr][: len(pre_tr_ids)] == pre_tr_ids
    assert [id(a) for a in got_ap][: len(pre_ap_ids)] == pre_ap_ids
    # containers stay sorted and deduped after the merge
    ts = [e[0] for e in entry.transitions]
    assert ts == sorted(ts)
    bodies = [b for _, b in entry.transitions]
    assert all(bodies[i] != bodies[i + 1] for i in range(len(bodies) - 1))
    ats = [a.time for a in entry.apsides]
    assert ats == sorted(ats)
    _assert_flight_matches(entry.trajectory, jentry.trajectory, record)
    _assert_events_match(entry, jentry, record)


def _container_ops(events_mod):
    """The container sequence of test_api.py, on one package's classes."""
    out = []
    tr = events_mod.SoiTransitions()
    tr.insert(10.0, 1)
    tr.insert(20.0, 2)
    tr.insert(15.0, 2)   # dedup: predecessor at 10.0 is body 1 -> inserted
    assert list(tr) == [(10.0, 1), (15.0, 2), (20.0, 2)]
    out.append(list(tr))
    tr2 = events_mod.SoiTransitions()
    tr2.insert(10.0, 1)
    tr2.insert(12.0, 1)  # dedup against predecessor body
    assert list(tr2) == [(10.0, 1)]
    assert tr.soi_at(14.9) == 1 and tr.soi_at(15.0) == 2 and tr.soi_at(5.0) is None
    out.append((tr.soi_at(14.9), tr.soi_at(15.0), tr.soi_at(5.0)))
    tr.clear_after(15.0)  # keeps exact match
    assert list(tr) == [(10.0, 1), (15.0, 2)]
    tr.insert(15.0, 3)    # exact-time replace
    assert list(tr) == [(10.0, 1), (15.0, 3)]
    tr.clear_before(15.0)
    assert list(tr) == [(15.0, 3)]
    out.append(list(tr))

    ap = events_mod.Apsides()
    a1 = events_mod.Apsis(5.0, 0, 100.0, True)
    a2 = events_mod.Apsis(9.0, 0, 200.0, False)
    ap.extend([a2, a1])
    assert list(ap) == [a1, a2]
    ap.clear_after(5.0)
    assert list(ap) == [a1]
    out.append([(a.time, a.body, a.distance, a.periapsis) for a in ap])
    return out


def test_event_containers_unit():
    """Container semantics vs spacecraft.rs:302-446, the same in both packages."""
    from ephemeris_explorer_tpu import events as jevents
    from ephemeris_explorer_tpu_torch import events

    assert _container_ops(events) == _container_ops(jevents)


def test_ship_analysis(uni, juni, record):
    _jax_bits(uni, juni)
    ship = uni.scene.ships[0]
    uni.spawn_ship(ship)
    juni.spawn_ship(juni.scene.ships[0])
    entry = uni.ships[ship.name]
    assert len(entry.transitions) >= 1
    segs = uni.ship_segments(ship.name)
    assert len(segs) >= 1
    assert any("Orbit" in s.name or "Earth" in s.name for s in segs)
    jsegs = juni.ship_segments(ship.name)
    assert [(s.name, s.body, s.burn) for s in segs] == [(s.name, s.body, s.burn) for s in jsegs]
    _assert_events_match(entry, juni.ships[ship.name], record)


def test_interpolation_error_audit(uni, juni, record):
    errs = interpolation_error(
        uni.ephemeris, uni.state, uni.settings, span=Duration.from_days(30.0), device=CPU
    )
    assert set(errs) == set(uni.names)
    # the audit's own regime: metres (debug.rs reports metres)
    assert all(e < 10.0 for e in errs.values()), errs
    # on the same coefficients, against the JAX package's audit
    _jax_bits(uni, juni)
    errs = interpolation_error(
        uni.ephemeris, uni.state, uni.settings, span=Duration.from_days(30.0), device=CPU
    )
    jerrs = japi.interpolation_error(
        juni.ephemeris, juni.state, juni.settings, span=JDuration.from_days(30.0)
    )
    for n in uni.names:
        gap = abs(errs[n] - jerrs[n])
        assert gap <= max(1e-3, 0.01 * jerrs[n]), (n, errs[n], jerrs[n])
        record(f"{n}_m_port_jax_gap", f"{errs[n]:.6g} {jerrs[n]:.6g} {gap:.3g}")


def test_interpolation_error_on_the_card_needs_cuda(uni, monkeypatch):
    """The audit defaults to the card: without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interpolation_error(uni.ephemeris, uni.state, uni.settings,
                            span=Duration.from_days(30.0))


def test_rotation():
    from ephemeris_explorer_tpu import rotation as jrotation
    from ephemeris_explorer_tpu_torch.rotation import Rotating, quat_rotate

    rot = Rotating(
        right_ascension=0.0,
        declination=np.pi / 2,  # z-axis spin
        reference_epoch=Epoch.ZERO,
        reference_rotation=0.0,
        rotation_rate=np.pi,  # half turn per day
    )
    q = rot.at(Epoch.ZERO + Duration.from_days(1.0))
    v = quat_rotate(q, np.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [-1.0, 0.0, 0.0], atol=1e-12)
    jrot = jrotation.Rotating(0.0, np.pi / 2, JEpoch.ZERO, 0.0, np.pi)
    jq = jrot.at(JEpoch.ZERO + JDuration.from_days(1.0))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(v, jrotation.quat_rotate(jq, np.array([1.0, 0.0, 0.0])))


def test_explorer_session_tick(uni, juni):
    uni.spawn_ship(uni.scene.ships[0])
    sess = ExplorerSession(uni, time_scale=86400.0)  # 1 day per real second
    frame = sess.tick(0.5)
    assert "Earth" in frame and "Earth Station" in frame
    # drive the clock to the edge: an auto-extension request fires
    sess.clock.set_time(sess.clock.end)
    sess.tick(0.1)
    assert sess._extend_task is not None
    sess._extend_task.join(timeout=300)
    sess.tick(0.1)  # merge the extension
    assert sess.clock.end.as_offset_seconds() > uni.state.epoch.as_offset_seconds() + 39 * 86400

    # the JAX package's session ticks to the same frame keys and bounds
    juni.spawn_ship(juni.scene.ships[0])
    jsess = japi.ExplorerSession(juni, time_scale=86400.0)
    jframe = jsess.tick(0.5)
    assert set(frame) == set(jframe)
    jsess.clock.set_time(jsess.clock.end)
    jsess.tick(0.1)
    jsess._extend_task.join(timeout=300)
    jsess.tick(0.1)
    assert sess.clock.end.as_offset_seconds() == jsess.clock.end.as_offset_seconds()
    assert sess.clock.current.as_offset_seconds() == jsess.clock.current.as_offset_seconds()


def test_concurrent_forward_backward_tasks(uni, juni, record):
    """fwd + bwd predictions run as concurrent tasks (main.rs:109-114)."""
    t_f = uni.extend(Duration.from_days(20.0), +1, background=True)
    t_b = uni.extend(Duration.from_days(30.0), -1, background=True)
    t_f.join(timeout=300)
    t_b.join(timeout=300)
    t0 = uni.state.epoch.as_offset_seconds()
    # 40 d initial + 20 d fwd: covered up to the Sun's 48 d segment boundary
    assert uni.ephemeris.positions(t0 + 45 * 86400.0) is not None
    # 30 d bwd: covered back to the Sun's -24 d boundary
    assert uni.ephemeris.positions(t0 - 12 * 86400.0) is not None
    juni.extend(JDuration.from_days(20.0), +1)
    juni.extend(JDuration.from_days(30.0), -1)
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("sample_space_err", f"{err:.3g}")


def test_spawn_scene_ships_and_export(uni, juni):
    entries = uni.spawn_scene_ships()
    assert len(entries) == len(uni.scene.ships)
    name = uni.scene.ships[0].name
    js = uni.export_ship(name)
    re_ship = scene_io.load_ship(json.loads(js))
    assert re_ship.name == name
    assert re_ship.integrator == uni.ships[name].plan.method
    # the ship config exports byte for byte as the JAX package's
    juni.spawn_scene_ships(propagate_now=False)
    assert js == juni.export_ship(name)


def test_extend_to_epoch(uni, juni, record):
    target = Epoch.from_offset_seconds(
        uni.state.epoch.as_offset_seconds() + 100 * 86400.0
    )
    uni.extend_to(target)
    # covered up to the last full Sun segment before the target
    assert uni.ephemeris.end.as_offset_seconds() >= target.as_offset_seconds() - 24 * 86400.0
    back = Epoch.from_offset_seconds(uni.state.epoch.as_offset_seconds() - 50 * 86400.0)
    uni.extend_to(back)
    assert uni.ephemeris.start.as_offset_seconds() <= back.as_offset_seconds() + 24 * 86400.0
    # already covered -> no-op
    assert uni.extend_to(uni.state.epoch) is None
    juni.extend_to(_jepoch(target))
    juni.extend_to(_jepoch(back))
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("sample_space_err", f"{err:.3g}")


def test_replan_deferred_outside_context(uni, juni, record):
    """Ships whose start is outside the context don't propagate (guard,
    flight_plan.rs:342-344) and pick up later when coverage arrives."""
    from ephemeris_explorer_tpu.io.scene import Ship as JShip
    from ephemeris_explorer_tpu_torch.io.scene import Ship

    far = Epoch.from_offset_seconds(uni.state.epoch.as_offset_seconds() + 60 * 86400.0)
    kw = dict(name="Late", integrator="Verner87", tolerance=1e-3,
              position=uni.scene.ships[0].position, velocity=uni.scene.ships[0].velocity,
              burns=[])
    ship = Ship(start=far, end=Epoch.from_offset_seconds(far.as_offset_seconds() + 86400.0), **kw)
    entry = uni.spawn_ship(ship)
    assert len(entry.trajectory.ts) == 0  # deferred
    uni.extend(Duration.from_days(60.0))
    uni.replan("Late")
    assert len(entry.trajectory.ts) > 1
    assert entry.trajectory.start_s == far.as_offset_seconds()

    jship = JShip(start=_jepoch(ship.start), end=_jepoch(ship.end), **kw)
    jentry = juni.spawn_ship(jship)
    assert len(jentry.trajectory.ts) == 0
    juni.extend(JDuration.from_days(60.0))
    _jax_bits(uni, juni)
    uni.replan("Late")  # a full restart on the JAX package's coefficients
    juni.replan("Late")
    _assert_flight_matches(entry.trajectory, jentry.trajectory, record)


def test_spawn_ship_relative(uni, juni, record):
    import math

    _jax_bits(uni, juni)
    at = Epoch.from_offset_seconds(uni.state.epoch.as_offset_seconds() + 86400.0)
    mu_e = uni.state.bodies[uni.body_index["Earth"]].mu
    r = 7000.0
    v = math.sqrt(mu_e / r)
    entry = uni.spawn_ship_relative(
        "RelSat", "Earth", [r, 0.0, 0.0], [0.0, v, 0.0],
        at=at, end=Epoch.from_offset_seconds(at.as_offset_seconds() + 86400.0),
    )
    traj = entry.trajectory
    t = at.as_offset_seconds() + 43200.0
    d = np.linalg.norm(traj.position(t) - uni.ephemeris["Earth"].position(t))
    assert abs(d - r) < 200.0  # circular-ish orbit around Earth
    jentry = juni.spawn_ship_relative(
        "RelSat", "Earth", [r, 0.0, 0.0], [0.0, v, 0.0],
        at=_jepoch(at), end=JEpoch.from_offset_seconds(at.as_offset_seconds() + 86400.0),
    )
    np.testing.assert_allclose(entry.ship.position, jentry.ship.position, rtol=1e-15, atol=0)
    _assert_flight_matches(traj, jentry.trajectory, record)


def test_reader_writer_hammer(uni, juni, record):
    """Tight reader loop racing a background backward extension.

    The backward merge path (clear_before + prepend) is the torn-state
    hazard: new coefficients with an old start shift every evaluation by a
    whole chunk span.  BodyEphemeris publishes (start_s, coeffs) atomically
    and Universe readers take the lock, so positions at a fixed epoch inside
    the already-covered span must be bit-stable throughout.
    """
    t0 = uni.state.epoch
    at = Epoch.from_offset_seconds(t0.as_offset_seconds() + 10 * 86400.0)
    ref = uni.positions(at)
    assert ref is not None

    # small chunks -> many merge events to race against
    prop = uni._propagator(-1)
    n_steps = int(round(Duration.from_days(60.0).as_seconds() / prop.dt_s))
    task = PredictionTask(
        prop, uni.ephemeris, uni.lock, prop.steps_done + n_steps, chunk_steps=64
    ).start()

    worst = 0.0
    reads = 0
    while task.in_progress:
        p = uni.positions(at)
        assert p is not None
        worst = max(worst, float(np.max(np.abs(p - ref))))
        reads += 1
        snap = uni.export_state(at)  # multi-body consistent read under lock
        assert len(snap.bodies) == len(uni.names)
    task.join(timeout=300)
    assert reads > 0
    assert worst == 0.0, f"torn read: positions drifted by {worst} km"
    # the backward extension actually landed, as the JAX package's does
    assert uni.ephemeris.start.as_offset_seconds() < t0.as_offset_seconds()
    jprop = juni._propagator(-1)
    japi.PredictionTask(jprop, juni.ephemeris, juni.lock, jprop.steps_done + n_steps,
                        chunk_steps=64).start().join(timeout=300)
    err = _sample_space_err(uni, juni)
    assert err <= GEN_BAR
    record("reads", reads)
    record("sample_space_err", f"{err:.3g}")


def test_clear_after_out_of_range_noop():
    """UniformSpline::clear_after is a no-op for t outside the spline
    (trajectory.rs: get_index returns None for t < start), in both packages."""
    from ephemeris_explorer_tpu.ephemeris import BodyEphemeris as JBodyEphemeris
    from ephemeris_explorer_tpu_torch.ephemeris import BodyEphemeris

    for cls in (BodyEphemeris, JBodyEphemeris):
        b = cls(start_s=100.0, interval_s=10.0, coeffs=np.zeros((4, 9, 3)))
        b.clear_after(0.0)  # before start: reference semantics = untouched
        assert b.segment_count == 4
        b.clear_after(1000.0)  # after end: untouched
        assert b.segment_count == 4
        b.clear_after(120.0)  # in range: truncates
        assert b.segment_count == 2


def test_edit_burn_surface(uni, juni, record):
    """Universe.add_burn/edit_burn/remove_burn/set_plan_end mirror the
    reference's burn editor: mutate + incremental replan from divergence
    (ui/windows/body.rs:655-864, flight_plan.rs:310-361)."""
    _jax_bits(uni, juni)
    ship = uni.scene.ships[0]
    entry = uni.spawn_ship(ship)
    juni.spawn_ship(juni.scene.ships[0])
    traj1 = entry.trajectory
    n1 = len(traj1.ts)

    t_burn = traj1.start_s + 0.7 * (traj1.end_s - traj1.start_s)
    burn, jburn = _burns(t_burn, 60.0, [1e-3, 0, 0])
    bid = uni.add_burn(ship.name, burn)
    jbid = juni.add_burn(ship.name, jburn)
    traj2 = uni.ships[ship.name].trajectory
    early = traj2.pos[: n1 // 2].copy()

    # drag the burn later: knots before the OLD start are preserved
    burn = uni.edit_burn(
        ship.name, bid, start=Epoch.from_offset_seconds(t_burn + 1800.0)
    )
    juni.edit_burn(ship.name, jbid, start=JEpoch.from_offset_seconds(t_burn + 1800.0))
    assert burn.start.as_offset_seconds() == t_burn + 1800.0
    traj3 = uni.ships[ship.name].trajectory
    np.testing.assert_array_equal(traj3.pos[: n1 // 2], early)
    _assert_flight_matches(traj3, juni.ships[ship.name].trajectory, record, "_dragged")

    # edit acceleration + disable: trajectory returns to coast-only track
    uni.edit_burn(ship.name, bid, acceleration=[2e-3, 0, 0], enabled=False)
    traj4 = uni.ships[ship.name].trajectory
    got = traj4.get(traj1.ts[-1])
    ref = traj1.get(traj1.ts[-1])
    assert got is not None and ref is not None
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6)

    # remove + shorten the plan end
    uni.remove_burn(ship.name, bid)
    assert bid not in uni.ships[ship.name].plan.burns
    end = Epoch.from_offset_seconds(traj1.start_s + 0.5 * (traj1.end_s - traj1.start_s))
    uni.set_plan_end(ship.name, end)
    assert uni.ships[ship.name].plan.end == end
    juni.edit_burn(ship.name, jbid, acceleration=[2e-3, 0, 0], enabled=False)
    juni.remove_burn(ship.name, jbid)
    juni.set_plan_end(ship.name, _jepoch(end))
    _assert_flight_matches(uni.ships[ship.name].trajectory, juni.ships[ship.name].trajectory,
                           record, "_final")


def _lifecycle(u, burn_cls, epoch, duration, record_knots):
    """test_api.py's randomized burn-editing sequence on one universe,
    checking the container invariants after every operation."""
    rng = np.random.default_rng(42)
    ship = u.scene.ships[0]
    u.spawn_ship(ship)
    name = ship.name

    def span():
        tr = u.ships[name].trajectory
        return tr.start_s, tr.end_s

    def check():
        tr = u.ships[name].trajectory
        ts = np.asarray(tr.ts)
        assert np.all(np.diff(ts) > 0), "knots not strictly increasing"
        assert np.isfinite(np.asarray(tr.pos)).all()
        assert np.isfinite(np.asarray(tr.vel)).all()
        ev = [t for t, *_ in u.ships[name].transitions]
        assert ev == sorted(ev)
        for t in ev:
            assert tr.start_s - 1.0 <= t <= tr.end_s + 1.0
        ap = [a.time for a in u.ships[name].apsides]
        assert ap == sorted(ap)
        record_knots.append(len(tr.ts))

    burn_ids = []
    for i in range(10):
        op = rng.integers(0, 5)
        s0, s1 = span()
        if op == 0 or not burn_ids:  # add
            t = s0 + (0.2 + 0.6 * rng.random()) * (s1 - s0)
            bid = u.add_burn(
                name,
                burn_cls(
                    start=epoch.from_offset_seconds(float(t)),
                    duration=duration.from_seconds(float(30 + 60 * rng.random())),
                    acceleration=rng.normal(size=3) * 1e-4,
                    reference="Earth" if rng.random() < 0.5 else None,
                ),
            )
            burn_ids.append(bid)
        elif op == 1:  # shift a burn
            bid = burn_ids[rng.integers(0, len(burn_ids))]
            b = u.ships[name].plan.burns.get(bid)
            if b is not None:
                u.edit_burn(
                    name, bid,
                    start=b.start + duration.from_seconds(float(rng.normal() * 600)),
                )
        elif op == 2:  # toggle
            bid = burn_ids[rng.integers(0, len(burn_ids))]
            b = u.ships[name].plan.burns.get(bid)
            if b is not None:
                u.edit_burn(name, bid, enabled=not b.enabled)
        elif op == 3:  # remove
            bid = burn_ids.pop(rng.integers(0, len(burn_ids)))
            u.remove_burn(name, bid)
        else:  # queries at random epochs
            t = s0 + rng.random() * (s1 - s0)
            got = u.ships[name].trajectory.get(float(t))
            if got is not None:
                assert np.isfinite(np.asarray(got[0])).all()
            u.positions(epoch.from_offset_seconds(float(t)))
            u.ship_segments(name)
        check()
    return u.ships[name]


def test_universe_lifecycle_fuzz(uni, juni, record):
    """Randomized burn-editing / extension / query sequence holds the
    container invariants after every operation (sorted event times within
    bounds, strictly increasing knots, finite states), and ends where the
    JAX package's same sequence ends."""
    _jax_bits(uni, juni)
    knots, jknots = [], []
    entry = _lifecycle(uni, Burn, Epoch, Duration, knots)
    jentry = _lifecycle(juni, japi.Burn, JEpoch, JDuration, jknots)
    assert knots == jknots
    _assert_flight_matches(entry.trajectory, jentry.trajectory, record)


def test_universe_defaults_to_the_card(monkeypatch):
    """Without CUDA, a Universe that names no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Universe.load(SEM)
