"""IAU-style body orientation (rotation.rs:13-26).

A body's spin axis is given by right ascension / declination; its rotation
angle advances linearly from a reference epoch.  Quaternions are returned as
(w, x, y, z) numpy arrays.

Port of ``ephemeris_explorer_tpu.rotation`` (numpy, copied).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ftime import Epoch


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


@dataclass(frozen=True)
class Rotating:
    """rotation.rs Rotating component: all angles in radians, rate rad/day."""

    right_ascension: float
    declination: float
    reference_epoch: Epoch
    reference_rotation: float
    rotation_rate: float

    @property
    def axis(self) -> np.ndarray:
        ra, dec = self.right_ascension, self.declination
        return np.array(
            [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)]
        )

    def at(self, epoch: Epoch) -> np.ndarray:
        """Orientation quaternion at `epoch` (rotation.rs:14-25)."""
        dt_days = (epoch - self.reference_epoch).as_days()
        angle = self.reference_rotation + dt_days * self.rotation_rate
        return quat_from_axis_angle(self.axis, angle)
