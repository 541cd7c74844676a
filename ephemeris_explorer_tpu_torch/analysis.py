"""Mission analysis: SOI assignment, hierarchy, plot segmentation, closest
approach.

Rebuilds ``ephemeris_explorer/src/analysis.rs`` and the SOI-assignment logic
of ``load/mod.rs:283-307`` as pure functions over the engine's data.

Port of ``ephemeris_explorer_tpu.analysis`` (numpy, copied), on the port's
:class:`.ephemeris.Ephemeris` and spacecraft timelines.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from .ephemeris import Ephemeris
from .io.scene import SolarSystemState
from .spacecraft import EPOCH_MAX, EPOCH_MIN, Timeline


def soi_radius(a: float, m: float, m_parent: float) -> float:
    """r = a * (m / M)^(2/5)  (SphereOfInfluence::approximate,
    dynamics/spacecraft.rs:33-39)."""
    return a * (m / m_parent) ** (2.0 / 5.0)


@dataclass
class SoiInfo:
    radii: np.ndarray    # (N,) km; inf for the root body
    depth: np.ndarray    # (N,) nesting depth (0 = root)
    parent: np.ndarray   # (N,) index of the SOI parent (-1 = none)


def assign_soi(state: SolarSystemState) -> SoiInfo:
    """Load-time SOI assignment (load/mod.rs:283-307).

    Bodies are processed by decreasing mu; each body's SOI parent is the
    already-processed body whose *assigned* SOI contains it and yields the
    smallest SOI radius; bodies with no container get an infinite SOI.
    """
    n = state.n
    order = sorted(range(n), key=lambda i: -state.bodies[i].mu)
    radii = np.full(n, np.inf)
    depth = np.zeros(n, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    done: list[int] = []
    for i in order:
        b = state.bodies[i]
        best = None
        for j in done:
            d = float(np.linalg.norm(b.position - state.bodies[j].position))
            if d < radii[j]:
                r = soi_radius(d, b.mu, state.bodies[j].mu)
                if best is None or r < best[0]:
                    best = (r, j)
        if best is not None:
            radii[i] = best[0]
            parent[i] = best[1]
            depth[i] = depth[best[1]] + 1
        done.append(i)
    return SoiInfo(radii=radii, depth=depth, parent=parent)


def hierarchy_at(
    eph: Ephemeris, soi: SoiInfo, t: float
) -> dict[int, int]:
    """body -> primary mapping at time t (sphere_of_influence_to_hierarchy).

    A body's primary is the smallest SOI (among other bodies) containing its
    position at t; bodies outside every SOI map to -1.
    """
    pos = eph.positions(t)
    if pos is None:
        return {}
    out: dict[int, int] = {}
    for i in range(len(pos)):
        d2 = np.sum((pos - pos[i]) ** 2, axis=-1)
        r2 = soi.radii**2
        inside = (d2 < r2) & (np.arange(len(pos)) != i)
        if inside.any():
            cands = np.nonzero(inside)[0]
            out[i] = int(cands[np.argmin(d2[cands])])
        else:
            out[i] = -1
    return out


class SegmentKind(Enum):
    """Plot segment taxonomy (analysis.rs:279-296)."""

    FLYBY = "Flyby"
    CAPTURE = "Capture"
    ESCAPE = "Escape"
    TRANSIT = "Transit"
    ORBIT = "Orbit"


@dataclass
class PlotSegment:
    start: float
    end: float
    body: int           # SOI body the segment is relative to
    kind: SegmentKind
    burn: bool          # overlaps a burn timeline segment
    name: str


def segment_trajectory(
    transitions: list[tuple[float, int]],
    timeline: Timeline | None,
    names: list[str],
    soi_parent_of,
    start: float = EPOCH_MIN,
    end: float = EPOCH_MAX,
) -> list[PlotSegment]:
    """Split a trajectory into named analysis segments.

    Mirrors setup_segment_plotting (analysis.rs:166-296): one segment per SOI
    span, subdivided by burn/coast timeline boundaries; each named
    Capture/Escape/Flyby/Transit/Orbit [+ " Burn"] relative to the SOI body.

    ``soi_parent_of(body, t)`` returns the SOI body of `body` at time t (or
    -1); used to classify from-parent / to-parent crossings.
    """
    out: list[PlotSegment] = []
    if timeline is not None:
        tl_starts = np.asarray(timeline.starts)
        tl_ends = np.asarray(timeline.ends)
        tl_burn = np.asarray(np.any(np.asarray(timeline.accels) != 0.0, axis=-1))
    for i, (t_in, b) in enumerate(transitions):
        nxt = transitions[i + 1] if i + 1 < len(transitions) else None
        if t_in > end or (nxt is not None and nxt[0] < start):
            continue
        prev = transitions[i - 1] if i > 0 else None
        b_parent = soi_parent_of(b, t_in)
        seg_start = max(t_in, start)
        seg_end = min(nxt[0], end) if nxt is not None else end

        is_from_parent = prev is not None and prev[1] == b_parent
        is_to_parent = nxt is not None and nxt[1] == b_parent
        if is_from_parent and is_to_parent:
            kind = SegmentKind.FLYBY
        elif is_from_parent:
            kind = SegmentKind.CAPTURE
        elif is_to_parent:
            kind = SegmentKind.ESCAPE
        elif prev is not None or nxt is not None:
            kind = SegmentKind.TRANSIT
        else:
            kind = SegmentKind.ORBIT

        # subdivide by timeline burn/coast boundaries (segments_between)
        if timeline is None:
            pieces = [(seg_start, seg_end, False)]
        else:
            pieces = []
            for s, e, burn in zip(tl_starts, tl_ends, tl_burn):
                s2, e2 = max(s, seg_start), min(e, seg_end)
                if s2 < e2:
                    pieces.append((s2, e2, bool(burn)))
        body_name = names[b] if 0 <= b < len(names) else "Unknown"
        for s, e, burn in pieces:
            suffix = " Burn" if burn else ""
            out.append(
                PlotSegment(
                    start=s,
                    end=e,
                    body=b,
                    kind=kind,
                    burn=burn,
                    name=f"{body_name} {kind.value}{suffix}",
                )
            )
    return out


def closest_separation(
    eval_a,
    eval_b,
    left: float,
    right: float,
    precision: float = 1.0,
    max_iterations: int = 100,
):
    """Ternary-search closest approach between two trajectories.

    Mirrors RelativeTrajectory::closest_separation_between
    (trajectory.rs:208-248): returns the epoch (seconds) of minimum
    separation, or None when the window is empty.
    """
    if right <= left:
        return None

    def distance(t):
        a = eval_a(t)
        b = eval_b(t)
        if a is None or b is None:
            return np.inf
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))

    i = 0
    while True:
        i += 1
        third = (right - left) / 3.0
        m1 = left + third
        m2 = right - third
        d = distance(m1) - distance(m2)
        if abs(d) < precision or i > max_iterations:
            return m1 + (m2 - m1) / 2.0
        if d > 0:
            left = m1
        else:
            right = m2


@dataclass
class RelativeTrajectory:
    """Difference of two trajectories (trajectory.rs:187-335).

    Bounds are the intersection; evaluation subtracts the reference's state.
    Works with any pair of objects exposing position/state_vector/start_s/
    end_s (BodyEphemeris, HermiteTrajectory).
    """

    trajectory: object
    reference: object | None = None

    @property
    def start_s(self) -> float:
        if self.reference is None:
            return self.trajectory.start_s
        return max(self.trajectory.start_s, self.reference.start_s)

    @property
    def end_s(self) -> float:
        if self.reference is None:
            return self.trajectory.end_s
        return min(self.trajectory.end_s, self.reference.end_s)

    def contains(self, t: float) -> bool:
        return self.start_s <= t <= self.end_s

    def position(self, t):
        p = self.trajectory.position(t)
        if p is None:
            return None
        if self.reference is None:
            return p
        q = self.reference.position(t)
        if q is None:
            return None
        return np.asarray(p) - np.asarray(q)

    def state_vector(self, t):
        a = self.trajectory.state_vector(t)
        if a is None:
            return None
        if self.reference is None:
            return a
        b = self.reference.state_vector(t)
        if b is None:
            return None
        return np.asarray(a[0]) - np.asarray(b[0]), np.asarray(a[1]) - np.asarray(b[1])

    def closest_separation(
        self, precision: float = 1.0, max_iterations: int = 100,
        left: float | None = None, right: float | None = None,
    ):
        """Ternary-search closest approach (trajectory.rs:208-267)."""
        lo = self.start_s if left is None else max(left, self.start_s)
        hi = self.end_s if right is None else min(right, self.end_s)
        if self.reference is None:
            return None
        return closest_separation(
            self.trajectory.position, self.reference.position, lo, hi,
            precision=precision, max_iterations=max_iterations,
        )
