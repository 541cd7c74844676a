"""Simulation clock, warp, and auto-extension.

Rebuilds the explorer's time-driving systems as a headless library:

* :class:`SimulationClock` - ``SimulationTime`` (simulation.rs:14-121):
  pausable scaled clock clamped to the intersection of trajectory bounds,
  with per-frame evaluation of every entity's state ("sync_position_to_time",
  simulation.rs:123-140).
* :class:`Warp` - "warp to epoch" (warp.rs:73-106): cubic ease-in-out
  animation of the current epoch over ~2 s of real time.
* :func:`auto_extend_span` - the auto-extender's look-ahead rule
  (auto_extend.rs:182-202): when the clock approaches the ephemeris bounds,
  request an extension of 5 s * time_scale with an equal buffer.

Port of ``ephemeris_explorer_tpu.simulation`` (numpy on the port's
ephemerides and trajectories, copied).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ftime import Duration, Epoch

AUTO_EXTEND_LOOKAHEAD_S = 5.0  # seconds of scaled time (auto_extend.rs:192-193)
WARP_DURATION_S = 2.0          # real seconds (warp.rs:84)


@dataclass
class SimulationClock:
    """SimulationTime (simulation.rs:14-121)."""

    current: Epoch
    start: Epoch = None          # bounds (intersection of trajectories)
    end: Epoch = None
    paused: bool = False
    time_scale: float = 1.0      # simulated seconds per real second

    def __post_init__(self):
        if self.start is None:
            self.start = Epoch.MIN
        if self.end is None:
            self.end = Epoch.MAX

    # -- bounds (sync_bounds, simulation.rs:109-115) ----------------------
    def sync_bounds(self, trajectories) -> None:
        """Clamp bounds to the intersection of all trajectory spans."""
        start, end = Epoch.MIN.as_offset_seconds(), Epoch.MAX.as_offset_seconds()
        for t in trajectories:
            start = max(start, t.start.as_offset_seconds() if hasattr(t, "start") else t.start_s)
            end = min(end, t.end.as_offset_seconds() if hasattr(t, "end") else t.end_s)
        self.start = Epoch.from_offset_seconds(start)
        self.end = Epoch.from_offset_seconds(end)
        self._clamp()

    def _clamp(self) -> None:
        c = self.current.as_offset_seconds()
        c = min(max(c, self.start.as_offset_seconds()), self.end.as_offset_seconds())
        self.current = Epoch.from_offset_seconds(c)

    # -- advancing (advance_simulation_time, simulation.rs:117-121) -------
    def advance(self, real_dt: float) -> Epoch:
        if not self.paused:
            self.current = self.current + Duration.from_seconds(real_dt * self.time_scale)
            self._clamp()
        return self.current

    def set_time(self, at: Epoch) -> None:
        self.current = at
        self._clamp()

    # -- auto-extension request (auto_extend.rs:182-202) ------------------
    def auto_extend_span(self) -> tuple[Duration, int] | None:
        """(span, direction) to request when the look-ahead leaves bounds."""
        if self.paused:
            return None
        look = AUTO_EXTEND_LOOKAHEAD_S * abs(self.time_scale)
        ahead = self.current.as_offset_seconds() + np.sign(self.time_scale) * look
        if self.time_scale >= 0 and ahead > self.end.as_offset_seconds():
            return Duration.from_seconds(2 * look), +1
        if self.time_scale < 0 and ahead < self.start.as_offset_seconds():
            return Duration.from_seconds(2 * look), -1
        return None


def cubic_ease_in_out(x: float) -> float:
    """warp.rs easing: smooth 0..1 ramp."""
    x = min(max(x, 0.0), 1.0)
    return 4 * x**3 if x < 0.5 else 1 - (-2 * x + 2) ** 3 / 2


@dataclass
class Warp:
    """Animated "warp to epoch" (warp.rs:73-106)."""

    clock: SimulationClock
    target: Epoch
    duration: float = WARP_DURATION_S
    _from: Epoch = field(init=False)
    _elapsed: float = field(init=False, default=0.0)

    def __post_init__(self):
        self._from = self.clock.current
        self.clock.paused = True

    @property
    def done(self) -> bool:
        return self._elapsed >= self.duration

    def tick(self, real_dt: float) -> Epoch:
        self._elapsed += real_dt
        f = cubic_ease_in_out(self._elapsed / self.duration)
        a = self._from.as_offset_seconds()
        b = self.target.as_offset_seconds()
        self.clock.set_time(Epoch.from_offset_seconds(a + (b - a) * f))
        if self.done:
            self.clock.paused = False
        return self.clock.current


def evaluate_scene(ephemeris, ships: dict, at: Epoch):
    """Per-frame state evaluation (sync_position_to_time, simulation.rs:123-140).

    Returns {name: (position, velocity)} for every body and ship whose
    trajectory covers `at` (entities outside their span are omitted, the
    headless analogue of ouf_of_bounds.rs:28-53 hiding them).
    """
    out = {}
    for name in ephemeris.names:
        sv = ephemeris[name].state_vector(at)
        if sv is not None:
            out[name] = sv
    for name, traj in ships.items():
        sv = traj.state_vector(at) if traj is not None else None
        if sv is not None:
            out[name] = sv
    return out
