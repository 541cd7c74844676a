"""Public engine API: the orchestration layer the explorer UI would front.

Rebuilds the reference's app-level compute orchestration as a pure library:

* :class:`FlightPlan` - burn list with overlap detection, timeline generation
  and the incremental replanning rule (flight_plan.rs:19-304),
* :class:`PredictionTask` - background incremental propagation with progress /
  pause / cancel, the equivalent of the AsyncComputeTaskPool prediction tasks
  (prediction.rs:344-485),
* :class:`Universe` - scene + ephemerides + ships: generate/extend/evaluate/
  propagate/export (load/mod.rs flow + ui/windows/export.rs).

Port of ``ephemeris_explorer_tpu.api``.  A :class:`Universe` runs on one
device, the card unless its caller names another (``device=None``:
:func:`._device.resolve`, which raises without CUDA; ``device="cpu"`` for
the CPU).  Its propagators generate there (kernel 11-f64 on the card up to
256 bodies), each replan packs the ephemeris there and flies the ship
there, and the event scanner mirrors that pack back to the host once.  A
:class:`PredictionTask` drives its propagator's device from its own worker
thread.  :func:`interpolation_error` re-integrates through kernel 11-f64 on
the card, the route generation takes, and through the eager ``elm2_step``
loop elsewhere.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _device, analysis, events
from . import ephemeris as ephemeris_mod
from .ephemeris import (
    CHUNK_STEPS,
    BodyEphemeris,
    Ephemeris,
    NBodyPropagator,
    bucket_tail,
)
from .ftime import Duration, Epoch
from .integrators.adaptive import AdaptiveParams
from .integrators.methods import ADAPTIVE_METHODS, get as get_method
from .integrators.multistep import elm2_init, elm2_step
from .io import scene as scene_io
from .io.scene import EphemeridesSettings, Scene, Ship, ShipBurn, SolarSystemState
from .ops import cuda_gen, nbody
from .spacecraft import (
    KNOT_CAPACITY,
    HermiteTrajectory,
    Timeline,
    build_timeline,
    divergence_time,
    propagate_resuming,
    ship_params,
)

logger = logging.getLogger("ephemeris_explorer_tpu_torch")


# ---------------------------------------------------------------------------
# Flight plans (flight_plan.rs)
# ---------------------------------------------------------------------------


@dataclass
class Burn:
    """flight_plan.rs:42-122."""

    start: Epoch
    duration: Duration
    acceleration: np.ndarray
    reference: str | None = None       # body name; None = inertial frame
    enabled: bool = True
    overlaps: bool = False
    id: str = field(default_factory=lambda: str(uuid.uuid4()))

    @property
    def end(self) -> Epoch:
        return self.start + self.duration

    def is_active(self) -> bool:
        return self.enabled and not self.overlaps

    def delta_v(self) -> float:
        return float(np.linalg.norm(self.acceleration)) * self.duration.as_seconds()

    def overlaps_with(self, other: "Burn") -> bool:
        return (
            self.enabled
            and other.enabled
            and self.start < other.end
            and self.end > other.start
        )

    def to_ship_burn(self) -> ShipBurn:
        return ShipBurn(
            start=self.start,
            duration=self.duration,
            acceleration=np.asarray(self.acceleration, dtype=np.float64),
            reference=self.reference,
        )


@dataclass
class FlightPlan:
    """flight_plan.rs:187-304."""

    method: str                      # one of ADAPTIVE_METHODS
    params: AdaptiveParams
    end: Epoch
    burns: dict[str, Burn] = field(default_factory=dict)

    def __post_init__(self):
        if self.method not in ADAPTIVE_METHODS:
            raise ValueError(f"unknown integration method {self.method}")

    def add_burn(self, burn: Burn) -> str:
        self.burns[burn.id] = burn
        return burn.id

    def remove_burn(self, burn_id: str) -> None:
        self.burns.pop(burn_id, None)

    def compute_overlaps(self) -> None:
        burns = list(self.burns.values())
        for i, b in enumerate(burns):
            b.overlaps = any(
                j != i and other.overlaps_with(b) for j, other in enumerate(burns)
            )

    def total_delta_v(self) -> float:
        return sum(b.delta_v() for b in self.burns.values() if b.is_active())

    def generate_timeline(self, body_index, pad_to: int | None = None) -> Timeline:
        self.compute_overlaps()
        return build_timeline(
            [b.to_ship_burn() for b in self.burns.values() if b.is_active()],
            body_index,
            pad_to=pad_to,
        )

    def restart_epoch(
        self,
        previous_timeline: Timeline | None,
        previous_method: str | None,
        previous_params: AdaptiveParams | None,
        trajectory: HermiteTrajectory,
        body_index,
    ) -> float:
        """The incremental-replanning rule (flight_plan.rs:264-303).

        Restart from the latest knot unaffected by the change: full restart if
        the method or tolerances changed, else from the last timeline event
        common to old and new plans (clamped into the trajectory).
        """
        if (
            previous_timeline is None
            or previous_method != self.method
            or previous_params is None
            or (previous_params.tol_pos, previous_params.tol_vel, previous_params.n_max)
            != (self.params.tol_pos, self.params.tol_vel, self.params.n_max)
        ):
            return trajectory.start_s
        new_tl = self.generate_timeline(body_index)
        before = min(self.end.as_offset_seconds(), trajectory.end_s)
        t = divergence_time(new_tl, previous_timeline, before)
        return max(t, trajectory.start_s)


# ---------------------------------------------------------------------------
# Background prediction tasks (prediction.rs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Synchronisation:
    """Snapshot cadence (prediction.rs:271-341): either merge every N steps
    or at a wall-clock frequency (converted to a step chunk by the task)."""

    steps: int | None = None
    hertz: float | None = None

    @classmethod
    def every_steps(cls, n: int) -> "Synchronisation":
        return cls(steps=n)

    @classmethod
    def at_hertz(cls, hz: float) -> "Synchronisation":
        return cls(hertz=hz)


class PredictionTask:
    """Incremental background propagation with progress/pause/cancel.

    The reference spawns prediction tasks on a compute thread pool, streams
    snapshot batches over a bounded channel and merges them on the main
    thread (prediction.rs:344-485).  Here the worker thread drives the
    device in chunks and merges finished segments into the shared
    :class:`Ephemeris` under a lock; `pause` is a flag the worker polls
    (prediction.rs:423-426) and `cancel` stops at the next chunk boundary.

    The worker makes the propagator's device its current CUDA device (the
    current device is per thread) and queues its chunks on that device's
    current stream, so each chunk's host-to-device copies are ordered
    before the coefficient fetch that the merge reads.  An exception in the
    worker is raised again by :meth:`join`.
    """

    def __init__(
        self,
        propagator: NBodyPropagator,
        target: Ephemeris,
        lock: threading.Lock,
        total_steps: int,
        chunk_steps: int | None = None,
        synchronisation: "Synchronisation | None" = None,
    ):
        # the package-canonical chunk (ephemeris.CHUNK_STEPS); an EXPLICIT
        # chunk_steps is a contract — no canonical default and no tail
        # bucketing
        self._bucket_tails = chunk_steps is None
        if chunk_steps is None:
            chunk_steps = CHUNK_STEPS
        self._prop = propagator
        self._target = target
        self._lock = lock
        self._total = total_steps
        if synchronisation is not None and synchronisation.steps:
            chunk_steps = synchronisation.steps
        self._sync = synchronisation
        self._chunk = chunk_steps
        self._chunk_times: list[float] = []
        self._pause = threading.Event()
        self._cancel = threading.Event()
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "PredictionTask":
        self._thread.start()
        return self

    # -- control (prediction.rs:237-263) --------------------------------
    def pause(self) -> None:
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def paused(self) -> bool:
        return self._pause.is_set()

    @property
    def in_progress(self) -> bool:
        return self._thread.is_alive()

    @property
    def progress(self) -> float:
        """(current - start) / (target - start)  (prediction.rs:246-250)."""
        if self._total == 0:
            return 1.0
        return min(self._prop.steps_done / self._total, 1.0)

    def join(self, timeout=None) -> None:
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error

    # -- worker ----------------------------------------------------------
    def _run(self) -> None:
        t_task = time.perf_counter()
        logger.info(
            "prediction task started: %s steps (%s)",
            self._total - self._prop.steps_done,
            "backward" if self._prop.spec.backward else "forward",
        )
        dev = self._prop.device
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                self._extend()
        except Exception as e:  # noqa: BLE001 - surfaced on join()
            self._error = e
        finally:
            # wall-clock task timing (prediction.rs:418-419,445)
            logger.info(
                "prediction task finished in %.2fs (%d chunks)",
                time.perf_counter() - t_task,
                len(self._chunk_times),
            )

    def _extend(self) -> None:
        """Step and merge chunks until the target, a cancel or an error."""
        backward = self._prop.spec.backward
        while self._prop.steps_done < self._total and not self._cancel.is_set():
            while self._pause.is_set() and not self._cancel.is_set():
                self._pause.wait(0.05)
            n = min(self._chunk, self._total - self._prop.steps_done)
            if self._bucket_tails and self._sync is None and n < self._chunk:
                # bucket the tail chunk (the span overshoots slightly), as
                # the JAX package does to bound its compile shapes: the
                # covered span follows from it.  The startup chunk must
                # cover the multistep order.
                n = bucket_tail(n, self._chunk, min_n=self._prop._tab.order + 1)
            first_seg = self._prop._segments_done(self._prop.steps_done)
            t_chunk = time.perf_counter()
            res = self._prop.step_chunk(n)
            dt_chunk = time.perf_counter() - t_chunk
            self._chunk_times.append(dt_chunk)
            # Frequency-mode sync: retune the chunk so merges land at the
            # requested wall-clock cadence (prediction.rs:300-341)
            if self._sync is not None and self._sync.hertz and dt_chunk > 0:
                per_step = dt_chunk / max(n, 1)
                want = max(int(1.0 / (self._sync.hertz * per_step)), 1)
                self._chunk = max(min(want, 1 << 20), 1)
            with self._lock:
                for i, name in enumerate(self._prop.names):
                    coeffs = res[name]
                    if coeffs.shape[0] == 0:
                        continue
                    start, interval = self._prop.segment_epochs(
                        name, int(first_seg[i]), coeffs.shape[0]
                    )
                    body = self._target.bodies.get(name)
                    piece = BodyEphemeris(
                        start_s=start,
                        interval_s=interval,
                        coeffs=coeffs[::-1] if backward else coeffs,
                    )
                    if body is None or body.segment_count == 0:
                        self._target.bodies[name] = piece
                    elif backward:
                        # clear_before + prepend (celestial.rs:216-235)
                        body.clear_before(piece.end)
                        body.prepend(piece)
                    else:
                        # clear_after + append (celestial.rs:198-213)
                        body.clear_after(piece.start)
                        body.append(piece)


# ---------------------------------------------------------------------------
# Universe: the top-level session (load/mod.rs flow)
# ---------------------------------------------------------------------------


@dataclass
class ShipEntry:
    ship: Ship
    plan: FlightPlan
    trajectory: HermiteTrajectory | None = None
    last_timeline: Timeline | None = None
    last_method: str | None = None
    last_params: AdaptiveParams | None = None
    transitions: events.SoiTransitions = field(default_factory=events.SoiTransitions)
    apsides: events.Apsides = field(default_factory=events.Apsides)
    # final termination reason of the last replan (spacecraft.DONE_* code);
    # DONE_ERROR means the committed trajectory is TRUNCATED before the
    # plan's end epoch (the reference's "end here, flush what we have",
    # prediction.rs:429-432) — surfaced so callers/UI can tell
    last_reason: int = 0


class Universe:
    """A loaded scene with ephemerides and ships, on one device (``device``:
    None = the card, raising without CUDA; ``"cpu"`` for the CPU)."""

    def __init__(self, sc: Scene, method: str = "QuinlanTremaine12", device=None):
        self.device = _device.resolve(device)
        self.scene = sc
        self.state = sc.state
        self.settings = sc.settings
        self.method = method
        self.soi = analysis.assign_soi(sc.state)
        self.names = [b.name for b in sc.state.bodies]
        self.body_index = {n: i for i, n in enumerate(self.names)}
        self.ephemeris = Ephemeris(names=self.names, mus=sc.state.mus(), bodies={})
        # RLock: reader paths (positions/export_state/replan's pack) take it
        # too, and replan may be reached from code already holding it.
        self.lock = threading.RLock()
        self._fwd: NBodyPropagator | None = None
        self._bwd: NBodyPropagator | None = None
        self._inflight: dict[int, PredictionTask] = {}
        self.ships: dict[str, ShipEntry] = {}

    # -- loading ----------------------------------------------------------
    @classmethod
    def load(cls, directory, **kw) -> "Universe":
        """The scene in ``directory``; ``kw`` (``method``, ``device``) go to
        the constructor."""
        return cls(scene_io.load_scene(directory), **kw)

    # -- celestial ephemerides -------------------------------------------
    def _propagator(self, direction: int) -> NBodyPropagator:
        attr = "_fwd" if direction > 0 else "_bwd"
        prop = getattr(self, attr)
        if prop is None:
            prop = NBodyPropagator(
                self.state, self.settings, direction=direction, method=self.method,
                device=self.device,
            )
            setattr(self, attr, prop)
        return prop

    def extend(self, span: Duration, direction: int = +1, background: bool = False):
        """Extend the ephemeris by `span` in `direction`.

        Synchronous by default; with background=True returns a running
        :class:`PredictionTask` (planner-window semantics,
        ui/windows/planner.rs:32-200).
        """
        # dedupe against an in-flight task for this direction
        # (handle_extend_request, auto_extend.rs:105-129)
        existing = self._inflight.get(direction)
        if existing is not None and existing.in_progress:
            if background:
                return existing
            existing.join()
            return None
        prop = self._propagator(direction)
        n_steps = int(round(abs(span.as_seconds()) / prop.dt_s))
        total = prop.steps_done + n_steps
        task = PredictionTask(prop, self.ephemeris, self.lock, total)
        task.start()
        self._inflight[direction] = task
        if background:
            return task
        task.join()
        return None

    def extend_to(self, epoch: Epoch, background: bool = False):
        """Extend coverage to an arbitrary epoch (planner semantics,
        ui/windows/planner.rs:32-200): picks the direction automatically and
        sizes the span from the current bounds."""
        t = epoch.as_offset_seconds()
        if self.ephemeris.bodies and any(
            b.segment_count for b in self.ephemeris.bodies.values()
        ):
            start = self.ephemeris.start.as_offset_seconds()
            end = self.ephemeris.end.as_offset_seconds()
        else:
            start = end = self.state.epoch.as_offset_seconds()
        if t > end:
            return self.extend(Duration.from_seconds(t - end), +1, background)
        if t < start:
            return self.extend(Duration.from_seconds(start - t), -1, background)
        return None

    def generate(self, span: Duration, backward_span: Duration | None = None) -> None:
        """Initial bidirectional generation (load/mod.rs:673-687)."""
        self.extend(span, +1)
        if backward_span is not None:
            self.extend(backward_span, -1)

    # -- evaluation / export ---------------------------------------------
    # Readers hold the universe lock so multi-body results are one consistent
    # cut across an in-flight background merge (the reference's RwLock read
    # guard, dynamics/mod.rs:84-147).
    def positions(self, at: Epoch):
        with self.lock:
            return self.ephemeris.positions(at.as_offset_seconds())

    def export_state(self, at: Epoch, bodies: list[str] | None = None) -> SolarSystemState:
        """System snapshot from spline evaluation (ui/windows/export.rs:222-256)."""
        out = []
        with self.lock:
            for name in bodies or self.names:
                b = self.ephemeris[name]
                sv = b.state_vector(at)
                if sv is None:
                    raise ValueError(f"{name} does not cover {at}")
                pos, vel = sv
                out.append(
                    scene_io.Body(
                        name=name,
                        mu=self.state.bodies[self.body_index[name]].mu,
                        position=pos,
                        velocity=vel,
                    )
                )
        return SolarSystemState(name=self.state.name, epoch=at, bodies=out)

    # -- ships / flight plans --------------------------------------------
    def spawn_scene_ships(self, propagate_now: bool = True) -> list[ShipEntry]:
        """Spawn every ship bundled with the scene (SpawnStage::Ships,
        load/mod.rs:488-621)."""
        return [self.spawn_ship(s, propagate_now=propagate_now) for s in self.scene.ships]

    def export_ship(self, name: str) -> str:
        """Ship JSON export (ui/windows/body.rs ship export)."""
        entry = self.ships[name]
        ship = entry.ship
        exported = Ship(
            name=ship.name,
            integrator=entry.plan.method,
            tolerance=entry.plan.params.tol_pos,
            start=ship.start,
            end=entry.plan.end,
            position=ship.position,
            velocity=ship.velocity,
            burns=[b.to_ship_burn() for b in entry.plan.burns.values() if b.is_active()],
        )
        return scene_io.ship_to_json(exported)

    def spawn_ship(self, ship: Ship, propagate_now: bool = True) -> ShipEntry:
        plan = FlightPlan(
            method=ship.integrator,
            params=ship_params(ship),
            end=ship.end,
            burns={},
        )
        for b in ship.burns:
            plan.add_burn(
                Burn(
                    start=b.start,
                    duration=b.duration,
                    acceleration=b.acceleration,
                    reference=b.reference,
                )
            )
        entry = ShipEntry(ship=ship, plan=plan)
        self.ships[ship.name] = entry
        if propagate_now:
            self.replan(ship.name)
        return entry

    def spawn_ship_relative(
        self,
        name: str,
        reference: str,
        position,
        velocity,
        at: Epoch,
        end: Epoch,
        integrator: str = "Verner87",
        tolerance: float = 1e-3,
        burns: list[ShipBurn] | None = None,
        propagate_now: bool = True,
    ) -> ShipEntry:
        """Spawn a ship from a state RELATIVE to a body (spawner UI,
        ui/windows/spawner.rs): the reference body's interpolated state at
        `at` is added to the given offsets."""
        sv = self.ephemeris[reference].state_vector(at)
        if sv is None:
            raise ValueError(f"{reference} does not cover {at}")
        bpos, bvel = sv
        ship = Ship(
            name=name,
            integrator=integrator,
            tolerance=tolerance,
            start=at,
            end=end,
            position=np.asarray(position, dtype=np.float64) + bpos,
            velocity=np.asarray(velocity, dtype=np.float64) + bvel,
            burns=burns or [],
        )
        return self.spawn_ship(ship, propagate_now=propagate_now)

    def _context_covers(self, t: float) -> bool:
        return (
            all(b.segment_count for b in self.ephemeris.bodies.values())
            and self.ephemeris.start.as_offset_seconds() <= t
            and t <= self.ephemeris.end.as_offset_seconds()
        )

    def replan(self, name: str, max_knots: int = KNOT_CAPACITY) -> HermiteTrajectory:
        """(Re)propagate a ship after flight-plan changes, restarting from the
        last unaffected event (apply_flight_plan, flight_plan.rs:325-361).

        The whole ephemeris is packed on the universe's device and the ship
        flies there; the event scanner mirrors that pack to the host once."""
        entry = self.ships[name]
        plan = entry.plan
        ship = entry.ship
        # context-validity guard (apply_flight_plan, flight_plan.rs:342-344):
        # don't propagate until the celestial context covers the start
        start_t = (
            entry.trajectory.start_s
            if entry.trajectory is not None and len(entry.trajectory.ts)
            else ship.start.as_offset_seconds()
        )
        if not self._context_covers(start_t):
            logger.info("replan(%s) deferred: context does not cover %s", name, start_t)
            if entry.trajectory is None:
                entry.trajectory = HermiteTrajectory(
                    ts=np.empty(0), pos=np.empty((0, 3)), vel=np.empty((0, 3))
                )
            return entry.trajectory
        with self.lock:
            packed = self.ephemeris.pack(self.device)
        timeline = plan.generate_timeline(self.body_index)

        if entry.trajectory is None or len(entry.trajectory.ts) == 0:
            t0 = ship.start.as_offset_seconds()
            sv = (np.asarray(ship.position), np.asarray(ship.velocity))
        else:
            t0 = plan.restart_epoch(
                entry.last_timeline,
                entry.last_method,
                entry.last_params,
                entry.trajectory,
                self.body_index,
            )
            got = entry.trajectory.get(t0)
            if got is None:
                # restart epoch is not a stored knot: full recompute
                t0 = ship.start.as_offset_seconds()
                sv = (np.asarray(ship.position), np.asarray(ship.velocity))
            else:
                sv = got

        piece, reason = propagate_resuming(
            plan.method,
            packed,
            timeline,
            t0,
            sv[0],
            sv[1],
            plan.end.as_offset_seconds(),
            plan.params,
            max_knots=max_knots,
        )
        full_restart = (
            entry.trajectory is None
            or len(entry.trajectory.ts) == 0
            or t0 <= entry.trajectory.start_s
        )
        if full_restart:
            entry.trajectory = piece
        else:
            entry.trajectory.join(piece)
        entry.last_timeline = timeline
        entry.last_method = plan.method
        entry.last_params = plan.params
        entry.last_reason = int(reason)

        if full_restart or len(entry.transitions) == 0:
            entry.transitions = events.SoiTransitions(
                events.soi_transitions(entry.trajectory, packed, self.soi.radii)
            )
            entry.apsides = events.Apsides(
                events.apsides(entry.trajectory, packed, entry.transitions)
            )
        else:
            # incremental maintenance (SoiTransitions/Apsides clear_after +
            # insert, dynamics/spacecraft.rs:331-361,427-446): events strictly
            # before the restart are preserved, only the recomputed span's
            # events are re-detected over the new piece
            entry.transitions.clear_after(t0)
            entry.transitions.extend(
                events.soi_transitions(piece, packed, self.soi.radii)
            )
            entry.apsides.clear_after(t0)
            entry.apsides.extend(
                events.apsides(piece, packed, entry.transitions)
            )
        return entry.trajectory

    # -- flight-plan editing (ui/windows/body.rs:655-864) -----------------
    #
    # The reference edits burns through DragValue widgets that mutate the
    # FlightPlan in place and fire FlightPlanChanged, which incrementally
    # replans from the divergence epoch (flight_plan.rs:310-361).  These
    # methods are that surface without the widgets: mutate, then replan.

    _UNSET = object()

    def add_burn(self, name: str, burn: Burn, replan: bool = True) -> str:
        """Append a burn to a ship's plan and (by default) replan."""
        bid = self.ships[name].plan.add_burn(burn)
        if replan:
            self.replan(name)
        return bid

    def remove_burn(self, name: str, burn_id: str, replan: bool = True) -> None:
        self.ships[name].plan.remove_burn(burn_id)
        if replan:
            self.replan(name)

    def edit_burn(
        self,
        name: str,
        burn_id: str,
        *,
        start: Epoch | None = None,
        duration: Duration | None = None,
        acceleration=None,
        reference=_UNSET,
        enabled: bool | None = None,
        replan: bool = True,
    ) -> Burn:
        """Edit burn fields in place (body.rs:706-846 drag semantics).

        Only the passed fields change; the replan restarts from the last
        timeline event common to the old and new plans, so edits to a late
        burn keep every knot before it (flight_plan.rs:264-303).
        """
        burn = self.ships[name].plan.burns[burn_id]
        if start is not None:
            burn.start = start
        if duration is not None:
            burn.duration = duration
        if acceleration is not None:
            burn.acceleration = np.asarray(acceleration, dtype=np.float64)
        if reference is not self._UNSET:
            burn.reference = reference
        if enabled is not None:
            burn.enabled = enabled
        if replan:
            self.replan(name)
        return burn

    def set_plan_end(self, name: str, end: Epoch, replan: bool = True) -> None:
        """Extend/shorten a mission end epoch (body.rs:556-565)."""
        self.ships[name].plan.end = end
        if replan:
            self.replan(name)

    def ship_segments(self, name: str) -> list[analysis.PlotSegment]:
        entry = self.ships[name]
        tl = entry.last_timeline
        return analysis.segment_trajectory(
            entry.transitions,
            tl,
            self.names,
            soi_parent_of=lambda b, t: int(self.soi.parent[b]),
            start=entry.trajectory.start_s,
            end=entry.trajectory.end_s,
        )


# ---------------------------------------------------------------------------
# Interpolation-error audit (ui/windows/debug.rs:182-238)
# ---------------------------------------------------------------------------


def interpolation_error(
    ephemeris: Ephemeris,
    state: SolarSystemState,
    settings: EphemeridesSettings,
    span: Duration | None = None,
    method: str = "QuinlanTremaine12",
    stride: int = 5,
    device=None,
) -> dict[str, float]:
    """Max |re-integrated - spline(t)| per body, in metres.

    Re-integrates the system from the scene state at the same dt and compares
    positions at every `stride`-th step against the fitted splines - the
    in-app ephemerides-debug audit (capped at min(5 y, bounds) there).

    Runs on ``device`` (None = the card; ``"cpu"`` for the CPU): the
    startup is ``elm2_init``; the steps run in kernel 11-f64, one launch a
    ``CHUNK_STEPS`` chunk, where generation takes it (a CUDA device, at most
    256 bodies: :func:`.ephemeris._use_gen_kernel_f64`), else in the eager
    native-f64 ``elm2_step`` loop; the splines are evaluated at all sampled
    times in one batched :meth:`.ephemeris.PackedEphemeris.positions` call.
    """
    device = _device.resolve(device)
    t0 = state.epoch.as_offset_seconds()
    end = min(
        ephemeris.end.as_offset_seconds(),
        t0 + (span or Duration.from_years(5.0)).as_seconds(),
    )
    h = settings.dt.as_seconds()
    n_steps = max(int((end - t0) / h), 0)
    tab = get_method(method)
    if n_steps <= tab.order:
        return {n: 0.0 for n in ephemeris.names}

    f64 = torch.float64
    mu = torch.as_tensor(state.mus(), dtype=f64, device=device)

    def accel(t, y):
        return nbody.pairwise_accel(y, mu)

    carry = elm2_init(tab, accel, t0, torch.as_tensor(state.positions(), dtype=f64, device=device),
                      torch.as_tensor(state.velocities(), dtype=f64, device=device), h)
    steps = n_steps - tab.order
    # the step times as the reference's scan carries them (t + h a step)
    ts = np.empty(steps)
    t = carry.t
    for i in range(steps):
        t = t + h
        ts[i] = t
    keep = np.arange(0, steps, stride)
    if ephemeris_mod._use_gen_kernel_f64(state.n, device):
        rows = []
        for s0 in range(0, steps, CHUNK_STEPS):
            n = min(CHUNK_STEPS, steps - s0)
            emitted, carry = cuda_gen.elm2_gen_scan_f64(tab, h, carry, mu, n)
            sel = keep[(keep >= s0) & (keep < s0 + n)] - s0
            rows.append(emitted[torch.as_tensor(sel, device=device)])
        ys_s = torch.cat(rows)
    else:
        rows = []
        for i in range(steps):
            carry = elm2_step(tab, accel, h, carry, with_velocity=False)
            if i % stride == 0:
                rows.append(carry.ys[0])
        ys_s = torch.stack(rows)
    ts_s = ts[keep]

    packed = ephemeris.pack(device)
    spl = packed.positions(torch.as_tensor(ts_s, device=device))   # (M, N, 3)
    err_m = (torch.linalg.vector_norm(spl - ys_s, dim=-1) * 1e3).cpu().numpy()  # (M, N)

    # mask samples outside each body's coverage (packed eval clamps instead
    # of returning None, so apply the bounds host-side)
    starts = packed.starts.cpu().numpy()
    ends = starts + packed.intervals.cpu().numpy() * packed.nsegs.cpu().numpy()
    valid = (ts_s[:, None] >= starts[None, :]) & (ts_s[:, None] <= ends[None, :])
    err_m = np.where(valid, err_m, 0.0)
    return {n: float(err_m[:, i].max(initial=0.0)) for i, n in enumerate(ephemeris.names)}


class ExplorerSession:
    """The running-app loop, headless: clock + universe + auto-extension.

    Ties together SimulationClock ticking (simulation.rs:117-121), the
    auto-extender (auto_extend.rs:182-202, deduplicated against in-flight
    tasks :105-129) and flight-plan re-propagation when the celestial context
    grows (trigger_on_trajectory_updates, flight_plan.rs:364-393).
    """

    def __init__(self, universe: Universe, time_scale: float = 1.0):
        from .simulation import SimulationClock

        self.universe = universe
        self.clock = SimulationClock(
            current=universe.state.epoch, time_scale=time_scale
        )
        self._sync_bounds()
        self._extend_task: PredictionTask | None = None

    def _sync_bounds(self) -> None:
        bodies = [b for b in self.universe.ephemeris.bodies.values() if b.segment_count]
        if bodies:
            self.clock.sync_bounds(bodies)

    def tick(self, real_dt: float):
        """Advance one frame; returns {name: (pos, vel)} at the new epoch."""
        from .simulation import evaluate_scene

        self.clock.advance(real_dt)

        # finalise finished extensions FIRST: bounds grow, dependent ships
        # re-plan (trigger_on_trajectory_updates semantics)
        if self._extend_task is not None and not self._extend_task.in_progress:
            self._extend_task.join()
            self._extend_task = None
            self._sync_bounds()
            for name, entry in self.universe.ships.items():
                end = entry.plan.end.as_offset_seconds()
                has_traj = entry.trajectory is not None and len(entry.trajectory.ts) > 0
                covered = has_traj and entry.trajectory.end_s >= end - 1.0
                if not covered and self.universe.ephemeris.end.as_offset_seconds() > (
                    entry.trajectory.end_s if has_traj else -np.inf
                ):
                    self.universe.replan(name)

        # auto-extension, deduplicated against the in-flight task
        req = self.clock.auto_extend_span()
        if req is not None and self._extend_task is None:
            span, direction = req
            self._extend_task = self.universe.extend(span, direction, background=True)

        ships = {n: e.trajectory for n, e in self.universe.ships.items()}
        with self.universe.lock:
            return evaluate_scene(self.universe.ephemeris, ships, self.clock.current)
