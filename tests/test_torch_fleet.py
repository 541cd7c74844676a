"""The fleet loop's plain version (kernel 14's) and its route, on the CPU.

``spacecraft.propagate_batch_plain`` is the eager fleet loop with its sums
over bodies, norms and cross products written out in kernel 14's order
(``csrc/fleet_scan.cu``).  Here it is held against the JAX package's
``propagate`` / ``propagate_resuming`` on the JAX package's own
coefficients (``interop.ephemeris_from``), at the bars of
``test_torch_spacecraft.py``: the same end reason and final segment, knot
counts within 1%, positions within 1e-2 km at 0.1, 0.5 and 0.9 of the span
(the JAX package's batched-vs-single bar, ``test_spacecraft.py:210-217``),
for each tableau family the kernel is built for.  Each package is flown to
each of those epochs, where its last knot lands, so no interpolation enters
the distance.  The two round apart at
the ulp (XLA:CPU fuses the compiled loop; the sums run in other orders),
and the adaptive step sequences drift from there.

A flight across the Moon's first segment boundary (coasting, and with a
burn ending exactly on it) is held to the JAX package's at the same bars.
The bodies at an attempt's stage times (``spacecraft._stage_bodies``), which
kernel 14 evaluates before its stage chain, are held bitwise to each stage
time's own evaluation across, on and past segment boundaries.  The
lane-tree body sum is held to a replay of the kernel's lanes
(bitwise) and to ``torch.sum`` (within the summation-order bound).  The
route: CPU tensors take the eager loop; the kernel's route raises on a
failed build or launch, and never falls back to the eager loop.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``, ``cuda``).
"""

import ctypes
from contextlib import contextmanager
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import Epoch as JEpoch
from ephemeris_explorer_tpu import spacecraft as jsc
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris as jgenerate
from ephemeris_explorer_tpu.integrators import get as jget
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu.io.scene import ShipBurn as JBurn
from ephemeris_explorer_tpu_torch import Duration, Epoch, interop
from ephemeris_explorer_tpu_torch import spacecraft as sc_
from ephemeris_explorer_tpu_torch.integrators import get as get_method
from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams
from ephemeris_explorer_tpu_torch.io import scene
from ephemeris_explorer_tpu_torch.io.scene import ShipBurn
from ephemeris_explorer_tpu_torch.ops import cuda_fleet

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"
CPU = "cpu"
PORT_VS_JAX_KM = 1e-2
KNOTS_REL = 0.01
SPAN_S = 43200.0


@pytest.fixture(scope="module")
def sem():
    """The sun_earth_moon scene, the JAX package's 40 days of it, and the
    same coefficients in the port."""
    jsc_scene = jscene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    jeph = jgenerate(jsc_scene.state, jsc_scene.settings, JDuration.from_days(40.0))
    return scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5"), interop.ephemeris_from(jeph), jeph


def _burns(kind, t0):
    """The Earth Station's burns for a case: none, a TNB burn about Earth,
    or an inertial burn; 300 s an hour after t0."""
    if kind == "coast":
        return []
    return [ShipBurn(start=Epoch.from_offset_seconds(t0 + 3600.0),
                     duration=Duration.from_seconds(300.0),
                     acceleration=np.array([4e-3, -1e-3, 2e-3]),
                     reference="Earth" if kind == "tnb" else None)]


def _jburns(burns):
    return [JBurn(start=JEpoch.from_offset_seconds(b.start.as_offset_seconds()),
                  duration=JDuration.from_seconds(b.duration.as_seconds()),
                  acceleration=b.acceleration, reference=b.reference) for b in burns]


FRACTIONS = (0.1, 0.5, 0.9)


def _flights(sem, method, kind, end_s, max_knots=2048, resuming=False):
    """The Earth Station flown by the port (the plain loop on the CPU) and
    by the JAX package to ``end_s``: (port, JAX) results of ``propagate``,
    or (trajectory, reason) pairs of ``propagate_resuming``."""
    sc, eph, jeph = sem
    ship = sc.ships[0]
    t0 = ship.start.as_offset_seconds()
    index = {n: i for i, n in enumerate(eph.names)}
    burns = _burns(kind, t0)
    params = sc_.ship_params(ship)
    jparams = jsc.AdaptiveParams(h_init=params.h_init, tol_pos=params.tol_pos,
                                 tol_vel=params.tol_vel, n_max=params.n_max)
    tl, jtl = sc_.build_timeline(burns, index), jsc.build_timeline(_jburns(burns), index)
    if resuming:
        args = (t0, ship.position, ship.velocity, end_s)
        return (sc_.propagate_resuming(method, eph.pack(CPU), tl, *args, params,
                                       max_knots=max_knots),
                jsc.propagate_resuming(method, jeph.pack(), jtl, *args, jparams,
                                       max_knots=max_knots))
    return (sc_.propagate(get_method(method), eph.pack(CPU), tl, t0, ship.position,
                          ship.velocity, end_s, params, max_knots=max_knots),
            jsc.propagate(jget(method), jeph.pack(), jsc.Timeline(*map(jnp.asarray, jtl)), t0,
                          jnp.asarray(ship.position), jnp.asarray(ship.velocity), end_s, jparams,
                          max_knots=max_knots))


def _last(r):
    """The last knot's (t, position) of a ``propagate`` result."""
    k = int(r.count)
    return float(r.ts[k - 1]), np.asarray(r.pos[k - 1])


def _km_at_fractions(sem, method, kind, resuming=False) -> list:
    """Port against JAX at 0.1, 0.5 and 0.9 of the span, each package flown
    to that epoch, where its last knot lands (no interpolation: cubic
    Hermite between two packages' knots, whose times part at the ulp, errs
    by tens of metres in low Earth orbit)."""
    t0 = sem[0].ships[0].start.as_offset_seconds()
    out = []
    for f in FRACTIONS:
        end = t0 + f * SPAN_S
        if resuming:
            (traj, _), (jtraj, _) = _flights(sem, method, kind, end, max_knots=64, resuming=True)
            (t, p), (jt, jp) = (traj.ts[-1], traj.pos[-1]), (jtraj.ts[-1], jtraj.pos[-1])
        else:
            (t, p), (jt, jp) = map(_last, _flights(sem, method, kind, end))
        assert t == jt == end
        out.append(float(np.abs(p - jp).max()))
    return out


@pytest.mark.parametrize("method,kind", [
    ("Verner87", "coast"), ("Verner87", "tnb"), ("Verner87", "inertial"),
    ("Verner98", "tnb"), ("DormandPrince54", "tnb"), ("Fine45", "tnb")])
def test_plain_loop_matches_jax(sem, method, kind):
    """Half a day of the Earth Station, the fleet loop's plain version
    (``propagate``, B = 1) against the JAX package's ``propagate``: the same
    reason and final segment, knot counts within 1%, 1e-2 km at 0.1, 0.5
    and 0.9 of the span."""
    t0 = sem[0].ships[0].start.as_offset_seconds()
    r, jr = _flights(sem, method, kind, t0 + SPAN_S)
    k, jk = int(r.count), int(jr.count)
    assert int(r.reason) == int(jr.reason) == sc_.DONE_END
    assert int(r.final_seg) == int(jr.final_seg) == (0 if kind == "coast" else 2)
    assert abs(k - jk) <= KNOTS_REL * jk
    km = _km_at_fractions(sem, method, kind)
    assert max(km) < PORT_VS_JAX_KM, km


def test_plain_loop_resuming_matches_jax(sem):
    """``propagate_resuming`` through a 64-knot buffer (the plain loop
    restarted at every full buffer) with a TNB burn, against the JAX
    package's: the same end reason, knot counts within 1%, 1e-2 km at 0.1,
    0.5 and 0.9 of the span."""
    t0 = sem[0].ships[0].start.as_offset_seconds()
    (traj, reason), (jtraj, jreason) = _flights(sem, "Verner87", "tnb", t0 + SPAN_S,
                                                max_knots=64, resuming=True)
    assert reason == jreason == sc_.DONE_END and len(traj.ts) > 64
    assert abs(len(traj.ts) - len(jtraj.ts)) <= KNOTS_REL * len(jtraj.ts)
    km = _km_at_fractions(sem, "Verner87", "tnb", resuming=True)
    assert max(km) < PORT_VS_JAX_KM, km


def _lanes_replayed(x: np.ndarray) -> np.ndarray:
    """Kernel 14's sum over the bodies of (N, 3), replayed lane by lane in
    Python floats: lane l adds bodies l, l + 32, ... to 0.0, then lane l
    takes lane l + off's partial for off = 16, 8, 4, 2, 1."""
    out = np.zeros(3)
    for c in range(3):
        lanes = [0.0] * 32
        for i in range(x.shape[0]):
            lanes[i % 32] = lanes[i % 32] + float(x[i, c])
        off = 16
        while off:
            lanes = [lanes[l] + lanes[l + off] for l in range(off)]
            off //= 2
        out[c] = lanes[0]
    return out


@pytest.mark.parametrize("n", [3, 32, 33, 65])
def test_lane_sum_is_the_kernels_order(n):
    """The plain version's body sum (``spacecraft._lane_sum``) is the
    kernel's lane order bitwise, and within the summation-order bound of
    ``torch.sum`` (2 (n - 1) u sum |x|): the two add in other orders."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(4, n, 3)) * np.exp2(rng.integers(-20, 20, size=(4, n, 3)))
    got = sc_._lane_sum(torch.as_tensor(x))
    for b in range(4):
        assert np.array_equal(got[b].numpy(), _lanes_replayed(x[b]))
    ref = torch.as_tensor(x).sum(-2)
    bound = 2 * (n - 1) * 2.0**-53 * np.abs(x).sum(-2)
    assert (np.abs(got.numpy() - ref.numpy()) <= bound).all()


def test_tnb_parts_are_written_out():
    """The TNB transform's norms, cross products and matrix product, in the
    kernel's order: each component of a cross product is two products and a
    subtraction; a norm the square root of a left-to-right sum."""
    rng = np.random.default_rng(3)
    a, b = (torch.as_tensor(rng.normal(size=(5, 3)) * 1e4) for _ in range(2))
    c = sc_._cross(a, b)
    for i in range(5):
        x, y = a[i].tolist(), b[i].tolist()
        assert c[i].tolist() == [x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                                 x[0] * y[1] - x[1] * y[0]]
        n = np.sqrt((x[0] * x[0] + x[1] * x[1]) + x[2] * x[2])
        assert sc_._unit(a[i]).tolist() == [x[0] / n, x[1] / n, x[2] / n]
    ref = torch.linalg.cross(a, b)
    assert (c - ref).abs().max() <= 4 * 2.0**-53 * (a.abs().max() * b.abs().max())


def _batch(sem, b=2):
    """(tab, packed, timelines, t0s, p0s, v0s, ends, params) of b Earth
    Station copies, one with a TNB burn, on the CPU."""
    sc, eph, _ = sem
    ship = sc.ships[0]
    t0 = ship.start.as_offset_seconds()
    index = {n: i for i, n in enumerate(eph.names)}
    tls = sc_.stack_timelines([sc_.build_timeline(_burns("tnb" if k % 2 else "coast", t0), index)
                               for k in range(b)])
    k = np.arange(b)
    return (get_method("Verner87"), eph.pack(CPU), tls, np.full(b, t0),
            ship.position[None] + np.stack([10.0 * k, 0 * k, 0 * k], -1),
            np.repeat(ship.velocity[None], b, 0), np.full(b, t0 + 7200.0),
            AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3))


def test_cpu_tensors_take_the_plain_loop(sem, monkeypatch):
    """``propagate_batch`` on CPU tensors is the eager loop, bitwise, and
    never reaches kernel 14's route."""
    args = _batch(sem)
    monkeypatch.setattr(sc_, "_propagate_batch_kernel",
                        lambda *a, **k: pytest.fail("the CPU took kernel 14's route"))
    got = sc_.propagate_batch(*args, max_knots=512)
    ref = sc_.propagate_batch_plain(*args, max_knots=512)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert (got.count > 5).all()


@contextmanager
def _no_plain(monkeypatch):
    monkeypatch.setattr(sc_, "propagate_batch_plain",
                        lambda *a, **k: pytest.fail("kernel 14's route fell back to the plain loop"))
    yield


def test_kernel_route_refuses_cpu_tensors(sem, monkeypatch):
    """Kernel 14's route on CPU tensors raises: it runs on CUDA tensors and
    does not fall back."""
    args = _batch(sem)
    with _no_plain(monkeypatch):
        with pytest.raises(ValueError, match="CUDA tensors"):
            sc_._propagate_batch_kernel(*args, 512)


def _as_card(monkeypatch):
    """Let kernel 14's wrapper take CPU tensors, on the current stream 0."""
    @contextmanager
    def on_device(dev):
        yield 0

    monkeypatch.setattr(cuda_fleet, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(cuda_fleet, "on_device", on_device)


def test_kernel_route_raises_on_a_failed_build(sem, monkeypatch):
    """A build that fails raises from ``propagate_batch``'s kernel route;
    the eager loop is never called."""
    args = _batch(sem)
    _as_card(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found at /usr/local/cuda/bin/nvcc")

    monkeypatch.setattr(cuda_fleet._build, "library", no_nvcc)
    with _no_plain(monkeypatch):
        with pytest.raises(RuntimeError, match="nvcc"):
            sc_._propagate_batch_kernel(*args, 512)


def test_kernel_route_raises_on_a_failed_launch(sem, monkeypatch):
    """A launch that returns a CUDA error raises; nothing falls back, and
    the launch is not counted."""
    args = _batch(sem)
    _as_card(monkeypatch)

    class FakeLib:
        def eet_fleet_scan(self, *a):
            return 700

    monkeypatch.setattr(cuda_fleet._build, "library", lambda: FakeLib())
    before = cuda_fleet.fleet_scan.launches
    with _no_plain(monkeypatch):
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            sc_._propagate_batch_kernel(*args, 512)
    assert cuda_fleet.fleet_scan.launches == before


def test_kernel_route_reads_the_done_flags_once_a_launch(sem, monkeypatch):
    """The host loop around kernel 14 (through a fake library that runs
    ``budget`` iterations of nothing and marks a ship done at its third
    launch): one read of the done flags a launch, iterations counted from
    the kernel's row, the launch arguments in the wrapper's order."""
    tab, packed, tls, t0s, p0s, v0s, ends, params = _batch(sem, b=3)
    _as_card(monkeypatch)
    calls = []

    class FakeLib:
        def eet_fleet_scan(self, *a):
            (instance, prm, n_max, fsal, burns, frames, *_rest) = a
            b, max_knots, budget = a[-4], a[-3], a[-2]
            calls.append((instance, n_max, fsal, burns, frames, b, max_knots, budget))
            istate = np.ctypeslib.as_array(
                (ctypes.c_longlong * (cuda_fleet.I_ROWS * b)).from_address(a[-6]))
            istate = istate.reshape(cuda_fleet.I_ROWS, b)
            istate[cuda_fleet.I_ITERS] = budget
            if len(calls) == 3:
                istate[cuda_fleet.I_DONE] = 1
                istate[cuda_fleet.I_ITERS] = [5, 7, 2]
            host = np.ctypeslib.as_array((ctypes.c_double * 8).from_address(prm))
            assert host[5] == 1.0 / params.tol_pos and host[7] == -1.0 / 7
            return 0

    monkeypatch.setattr(cuda_fleet._build, "library", lambda: FakeLib())
    sc_.propagate_batch.iterations = sc_.propagate_batch.syncs = 0
    before = cuda_fleet.fleet_scan.launches
    with _no_plain(monkeypatch):
        r = sc_._propagate_batch_kernel(tab, packed, tls, t0s, p0s, v0s, ends, params, 512)
    assert cuda_fleet.fleet_scan.launches - before == sc_.propagate_batch.syncs == 3
    assert sc_.propagate_batch.iterations == 2 * cuda_fleet.ITERATIONS_PER_LAUNCH + 7
    verner87 = [name for name, *_ in cuda_fleet.instances()].index("Verner87")
    assert calls[0] == (verner87, params.n_max, 0, 1, 1, 3, 512, cuda_fleet.ITERATIONS_PER_LAUNCH)
    assert r.ts.shape == (3, 512) and r.count.tolist() == [1, 1, 1]
    assert r.final_seg.tolist() == [0, 0, 0] and torch.isinf(r.ts[:, 1:]).all()


def test_kernel_tables_and_start_state():
    """The coefficients an instance is matched by, the tableaux the kernel
    is built for, and the ships' start state."""
    v98, fine = get_method("Verner98"), get_method("Fine45")
    bits = cuda_fleet._bits(v98).view(np.float64)
    m = v98.stages
    assert bits.shape == (m + m * m + 2 * m,) and np.array_equal(bits[:m], v98.c)
    assert np.array_equal(bits[m:m + m * m].reshape(m, m), v98.a)
    assert np.array_equal(bits[m + m * m:m + m * m + m], v98.b)
    assert np.array_equal(bits[m + m * m + m:], v98.e)
    bits = cuda_fleet._bits(fine).view(np.float64)
    s = fine.stages
    assert bits.shape == (s + 2 * s * s + 4 * s,)
    assert np.array_equal(bits[s + s * s:s + 2 * s * s].reshape(s, s), fine.av)
    assert np.array_equal(bits[-s:], fine.ev)
    params = AdaptiveParams()
    from ephemeris_explorer_tpu_torch.integrators import methods

    for name in methods.ADAPTIVE_METHODS:
        p = cuda_fleet.plan(get_method(name), params, True, False)
        assert cuda_fleet.instances()[p.instance][0] == name
        assert p.fsal == get_method(name).fsal
    with pytest.raises(ValueError, match="no instance"):
        cuda_fleet.plan(get_method("RK4"), params, False, False)
    t0 = torch.tensor([1.0, 2.0], dtype=torch.float64)
    p0 = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    f, i = cuda_fleet.start_state(t0, p0, -p0, torch.tensor([0, 3]), 60.0)
    assert f[cuda_fleet.F_T].tolist() == [1.0, 2.0]
    assert torch.equal(f[cuda_fleet.F_Y:cuda_fleet.F_Y + 3].T, p0)
    assert torch.equal(f[cuda_fleet.F_Y + 3:cuda_fleet.F_Y + 6].T, -p0)
    assert f[cuda_fleet.F_NEXT_H].tolist() == f[cuda_fleet.F_H_TRY].tolist() == [60.0, 60.0]
    assert i[cuda_fleet.I_SEG].tolist() == [0, 3] and i[cuda_fleet.I_COUNT].tolist() == [1, 1]
    assert i[cuda_fleet.I_STALE].tolist() == [1, 1] and not i[cuda_fleet.I_DONE].any()


def _stage_times(packed, case):
    """(B = 2, S = 5) stage times on the port's sun_earth_moon pack: across
    the Moon's first segment boundary (``straddle``), with stages exactly on
    it and on the Earth's first one (``on``), or past every body's last
    segment, where each clamps to it (``clamp``)."""
    moon = float(packed.starts[2] + packed.intervals[2])
    earth = float(packed.starts[1] + packed.intervals[1])
    end = float((packed.starts + packed.intervals * packed.nsegs).max())
    offsets = np.array([0.0, 17.5, 60.25, 111.0, 180.0])
    if case == "straddle":
        rows = [moon - 90.0 + offsets, moon - 3.0 + offsets / 7.0]
    elif case == "on":
        rows = [moon + offsets - offsets[1], earth - 60.25 + offsets]
    else:
        rows = [end + 10.0 + offsets, end + 3600.0 * 30 + offsets]
    return torch.as_tensor(np.stack(rows)), moon, earth, end


@pytest.mark.parametrize("case", ["straddle", "on", "clamp"])
@pytest.mark.parametrize("frames", [False, True])
def test_stage_bodies_are_each_stage_times_own_evaluation(sem, case, frames):
    """The plain loop's bodies at an attempt's stage times
    (``spacecraft._stage_bodies``, one batched evaluation) are, row by row,
    the bits of evaluating each stage time alone (``positions`` /
    ``state_vectors`` at one time): what kernel 14's evaluation of every
    stage time before the stage chain rests on.  With ``frames`` the
    positions come from the value-and-derivative form, and the frame body's
    position and velocity are its row of the single evaluation."""
    packed = sem[1].pack(CPU)
    ts, moon, earth, end = _stage_times(packed, case)
    fb = torch.tensor([1, 2])
    rows = sc_._stage_bodies(packed, ts, fb if frames else None, frames)
    assert len(rows) == ts.shape[1]
    for s, (bpos, fpos, fvel) in enumerate(rows):
        for b in range(ts.shape[0]):
            t = ts[b, s]
            if frames:
                pos, vel = packed.state_vectors(t)
                assert torch.equal(fpos[b], pos[fb[b]]) and torch.equal(fvel[b], vel[fb[b]])
            else:
                pos = packed.positions(t)
                assert fpos is None and fvel is None
            assert torch.equal(bpos[b], pos)
    # the stage times fall where the case says
    _, tau = packed._segments(ts)
    local = ts[..., None] - packed.starts
    idx = torch.minimum((torch.ceil(local / packed.intervals).long() - 1).clamp(min=0),
                        packed.nsegs - 1)
    if case == "straddle":
        assert (ts[0] < moon).any() and (ts[0] > moon).any()
        assert len(set(idx[0, :, 2].tolist())) == 2
    elif case == "on":
        assert (ts[0] == moon).any() and (ts[1] == earth).any()
        assert tau[0, 1, 2] == 1.0 and tau[1, 2, 1] == 1.0
    else:
        assert (ts > end).all() and (idx == packed.nsegs - 1).all() and (tau > 1.0).all()


@pytest.mark.parametrize("kind", ["coast", "tnb"])
def test_plain_loop_across_segment_boundaries_matches_jax(sem, kind):
    """A flight in low Earth orbit across the Moon's first segment boundary,
    the fleet loop's plain version against the JAX package's ``propagate``
    on the same coefficients: coasting, an attempt spans the boundary;
    with a TNB burn about the Earth that ends exactly on it, a knot and the
    next attempt's first stage fall on it.  The same reason and final
    segment, knot counts within 1%, 1e-2 km at the boundary (``tnb``) and
    at the end."""
    sc, eph, jeph = sem
    packed = eph.pack(CPU)
    moon = float(packed.starts[2] + packed.intervals[2])
    t0, end = moon - 1800.0, moon + 1800.0
    index = {n: i for i, n in enumerate(eph.names)}
    ep, ev = eph["Earth"].state_vector(t0)
    pos0 = ep + np.array([7000.0, 0.0, 0.0])
    vel0 = ev + np.array([0.0, float(np.sqrt(eph.mus[index["Earth"]] / 7000.0)), 0.0])
    burns = [] if kind == "coast" else [
        ShipBurn(start=Epoch.from_offset_seconds(moon - 300.0), duration=Duration.from_seconds(300.0),
                 acceleration=np.array([4e-3, -1e-3, 2e-3]), reference="Earth")]
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3)
    jparams = jsc.AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3, n_max=params.n_max)
    tl, jtl = sc_.build_timeline(burns, index), jsc.build_timeline(_jburns(burns), index)
    r = sc_.propagate(get_method("Verner87"), packed, tl, t0, pos0, vel0, end, params,
                      max_knots=1024)
    jr = jsc.propagate(jget("Verner87"), jeph.pack(), jsc.Timeline(*map(jnp.asarray, jtl)), t0,
                       jnp.asarray(pos0), jnp.asarray(vel0), end, jparams, max_knots=1024)
    k, jk = int(r.count), int(jr.count)
    assert int(r.reason) == int(jr.reason) == sc_.DONE_END
    assert int(r.final_seg) == int(jr.final_seg)
    assert abs(k - jk) <= max(1, KNOTS_REL * jk)
    ts, jts = r.ts[:k].numpy(), np.asarray(jr.ts[:jk])
    if kind == "coast":
        assert ((ts[:-1] < moon) & (ts[1:] > moon)).any()
    else:
        at, jat = np.nonzero(ts == moon)[0], np.nonzero(jts == moon)[0]
        assert len(at) == len(jat) == 1
        assert np.abs(r.pos[at[0]].numpy() - np.asarray(jr.pos[jat[0]])).max() < PORT_VS_JAX_KM
    assert ts[-1] == jts[-1] == end
    assert np.abs(r.pos[k - 1].numpy() - np.asarray(jr.pos[jk - 1])).max() < PORT_VS_JAX_KM
