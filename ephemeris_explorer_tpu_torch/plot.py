"""Trajectory plotting support: adaptive polylines and ray picking.

Rebuilds the explorer's plot machinery (``ui/world/plot.rs``) as pure
functions: Principia-derived "PlotMethod3" adaptive time stepping bounded by
on-screen angular error (plot.rs:89-150), linear polyline evaluation
(plot.rs:152-175), and segment-vs-ray picking distances (plot.rs:176-225).

The per-entity parallel plot computation (``par_iter_mut``,
plot.rs:273-356) maps to :func:`plot_many` - plain Python over entities here,
with each polyline's evaluations hitting the vectorised spline path.

Port of ``ephemeris_explorer_tpu.plot`` (numpy, copied).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def angular_distance_tan2(camera_position, p1, p2) -> float:
    """tan^2 of the angle subtended at the camera (plot.rs:429-436)."""
    v1 = np.asarray(p1, dtype=np.float64) - camera_position
    v2 = np.asarray(p2, dtype=np.float64) - camera_position
    v1 = v1 / np.linalg.norm(v1)
    v2 = v2 / np.linalg.norm(v2)
    wedge = np.cross(v1, v2)
    d = float(np.dot(v1, v2))
    return float(np.dot(wedge, wedge)) / (d * d)


@dataclass
class PlotPoints:
    """Adaptive polyline: (times (P,), points (P, 3))."""

    times: np.ndarray
    points: np.ndarray

    @classmethod
    def build(
        cls,
        eval_sv,                  # t_seconds -> (pos, vel) | None
        t_min: float,
        t_max: float,
        camera_position,
        tan2_angular_resolution: float,
        max_points: int = 10_000,
    ) -> "PlotPoints":
        """Principia PlotMethod3 (plot.rs:92-150): velocity-extrapolation
        angular-error-bounded time stepping."""
        if max_points == 0:
            return cls(np.empty(0), np.empty((0, 3)))
        cam = np.asarray(camera_position, dtype=np.float64)
        target = tan2_angular_resolution**2

        prev_t = t_min
        prev = eval_sv(prev_t)
        if prev is None:
            raise ValueError(f"trajectory does not cover {prev_t}")
        delta = t_max - prev_t
        est_error = None

        ts = [prev_t]
        pts = [np.asarray(prev[0], dtype=np.float64)]
        while prev_t < t_max and len(ts) < max_points:
            while True:
                if est_error is not None and est_error > 0.0:
                    delta = delta * 0.9 * (target / est_error) ** 0.25
                t = min(prev_t + delta, t_max)
                delta = t - prev_t
                extrapolated = prev[0] + prev[1] * delta
                cur = eval_sv(t)
                if cur is None:
                    raise ValueError(f"trajectory does not cover {t}")
                error = angular_distance_tan2(cam, extrapolated, cur[0]) / 16.0
                if error <= target:
                    break
                est_error = error
            prev_t, prev, est_error = t, cur, error
            ts.append(t)
            pts.append(np.asarray(cur[0], dtype=np.float64))
        return cls(np.asarray(ts), np.stack(pts))

    # -- evaluation (plot.rs:152-175) -------------------------------------
    def contains(self, t: float) -> bool:
        return len(self.times) > 0 and self.times[0] <= t <= self.times[-1]

    def evaluate(self, t: float) -> np.ndarray | None:
        if not self.contains(t):
            return None
        i = int(np.searchsorted(self.times, t))
        if i < len(self.times) and self.times[i] == t:
            return self.points[i]
        t1, t2 = self.times[i - 1], self.times[i]
        f = (t - t1) / (t2 - t1)
        return self.points[i - 1] * (1 - f) + self.points[i] * f

    # -- picking (plot.rs:176-225) ----------------------------------------
    def ray_distances(self, origin, direction, max_ray: float = np.inf):
        """Per-segment closest approach to a ray: [(time, separation, t_ray)].

        Vectorised version of the reference's segment iterator.
        """
        if len(self.times) < 2:
            return []
        o = np.asarray(origin, dtype=np.float64)
        v = np.asarray(direction, dtype=np.float64)
        p1 = self.points[:-1]
        p2 = self.points[1:]
        u = p2 - p1
        w = p1 - o
        a = np.einsum("ij,ij->i", u, u)
        b = u @ v
        c = float(v @ v)
        d = np.einsum("ij,ij->i", u, w)
        e = w @ v
        denom = a * c - b * b
        par = denom < 1e-7
        with np.errstate(divide="ignore", invalid="ignore"):
            t_seg = np.where(par, 0.0, (b * e - c * d) / denom)
            t_ray = np.where(par, np.where(b > c, d / b, e / c), (a * e - b * d) / denom)
        keep = (t_ray <= max_ray) & (t_seg >= 0.0) & (t_seg <= 1.0)
        out = []
        for i in np.nonzero(keep)[0]:
            ps = p1[i] + u[i] * t_seg[i]
            pr = o + v * t_ray[i]
            sep = float(np.linalg.norm(pr - ps))
            t_evt = self.times[i] + (self.times[i + 1] - self.times[i]) * t_seg[i]
            out.append((float(t_evt), sep, float(t_ray[i])))
        return out


def plot_many(entities, t_min, t_max, camera_position, tan2_res, max_points=10_000):
    """Compute polylines for several trajectories (plot.rs:273-356).

    `entities`: {name: eval_sv}; returns {name: PlotPoints}.
    """
    return {
        name: PlotPoints.build(ev, t_min, t_max, camera_position, tan2_res, max_points)
        for name, ev in entities.items()
    }
