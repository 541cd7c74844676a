"""Scene I/O: the reference's three JSON formats, byte-compatible.

* ``state.json``     - {name?, epoch, bodies:[{name, mu, position, velocity}]}
  (loader: ephemeris_explorer/src/load/solar_system/loaders.rs:223-264;
  units km, km/s, km^3/s^2 - DISTANCE_SCALE = 1.0)
* ``ephemeris.json`` - {dt: "10 minutes", settings: {<body>: {degree, count}}}
  (loaders.rs:299-335); sample_period = dt * count (load/mod.rs:325) and each
  polynomial segment spans sample_period * 8 (DIV = 8, trajectory.rs:337)
* ``ships/*.json``   - {name, integrator, tolerance, start, end, position,
  velocity, burns:[{start, duration, acceleration, reference?}]}
  (load/solar_system/mod.rs:208-250)

Epoch strings parse/serialise via :mod:`..ftime` ("YYYY-MM-DD HH:MM:SS[.mmm]").
State export mirrors ui/windows/export.rs:222-256.

A copy of ``ephemeris_explorer_tpu.io.scene`` (host code, no JAX); the body
visuals build on the port's :mod:`..rotation`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..ftime import Duration, Epoch

DIV = 8  # samples-per-segment divisor (reference trajectory.rs:337)


@dataclass
class Body:
    name: str
    mu: float                 # km^3/s^2
    position: np.ndarray      # (3,) km
    velocity: np.ndarray      # (3,) km/s


@dataclass
class SolarSystemState:
    name: str
    epoch: Epoch
    bodies: list[Body]        # insertion-ordered, like the reference IndexMap

    @property
    def n(self) -> int:
        return len(self.bodies)

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(name)

    def positions(self) -> np.ndarray:
        return np.stack([b.position for b in self.bodies])

    def velocities(self) -> np.ndarray:
        return np.stack([b.velocity for b in self.bodies])

    def mus(self) -> np.ndarray:
        return np.array([b.mu for b in self.bodies])


@dataclass
class InterpolationParameters:
    degree: int
    count: int


@dataclass
class EphemeridesSettings:
    dt: Duration
    settings: dict[str, InterpolationParameters]

    def sample_period(self, name: str) -> Duration:
        # load/mod.rs:325
        return self.dt * self.settings[name].count

    def interval(self, name: str) -> Duration:
        # segment interval = sample_period * DIV (load/mod.rs:352)
        return self.sample_period(name) * DIV


@dataclass
class ShipBurn:
    start: Epoch
    duration: Duration
    acceleration: np.ndarray          # (3,) km/s^2 in burn frame
    reference: str | None = None      # body name; None => Inertial frame

    @property
    def end(self) -> Epoch:
        return self.start + self.duration

    def delta_v(self) -> float:
        # flight_plan.rs:97-99
        return float(np.linalg.norm(self.acceleration)) * self.duration.as_seconds()


@dataclass
class Ship:
    name: str
    integrator: str                  # IntegrationMethod variant name
    tolerance: float                 # AbsTol (km and km/s)
    start: Epoch
    end: Epoch
    position: np.ndarray
    velocity: np.ndarray
    burns: list[ShipBurn] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_state(path: str | Path | dict) -> SolarSystemState:
    data = path if isinstance(path, dict) else json.loads(Path(path).read_text())
    bodies = [
        Body(
            name=b["name"],
            mu=float(b["mu"]),
            position=np.asarray(b["position"], dtype=np.float64),
            velocity=np.asarray(b["velocity"], dtype=np.float64),
        )
        for b in data["bodies"]
    ]
    return SolarSystemState(
        name=data.get("name") or "Solar System",
        epoch=Epoch.parse(data["epoch"]),
        bodies=bodies,
    )


def load_ephemerides_settings(path: str | Path | dict) -> EphemeridesSettings:
    data = path if isinstance(path, dict) else json.loads(Path(path).read_text())
    return EphemeridesSettings(
        dt=Duration.parse(data["dt"]),
        settings={
            name: InterpolationParameters(degree=int(s["degree"]), count=int(s["count"]))
            for name, s in data["settings"].items()
        },
    )


_SHIP_NAME_MAX = 24


def load_ship(path: str | Path | dict) -> Ship:
    data = path if isinstance(path, dict) else json.loads(Path(path).read_text())
    # name sanitisation mirrors ShipLoader (loaders.rs:370-376)
    name = "".join(c for c in data["name"] if c.isalnum() or c == " ")[:_SHIP_NAME_MAX]
    return Ship(
        name=name,
        integrator=data["integrator"],
        tolerance=float(data["tolerance"]),
        start=Epoch.parse(data["start"]),
        end=Epoch.parse(data["end"]),
        position=np.asarray(data["position"], dtype=np.float64),
        velocity=np.asarray(data["velocity"], dtype=np.float64),
        burns=[
            ShipBurn(
                start=Epoch.parse(b["start"]),
                duration=Duration.parse(b["duration"]),
                acceleration=np.asarray(b["acceleration"], dtype=np.float64),
                reference=b.get("reference"),
            )
            for b in data.get("burns", [])
        ],
    )


@dataclass
class Scene:
    """A full scene directory: state + ephemerides settings + ships.

    Mirrors LoadSolarSystem::try_from_dir (load/mod.rs:132-149).
    """

    state: SolarSystemState
    settings: EphemeridesSettings | None
    ships: list[Ship]
    errors: list[str] = field(default_factory=list)


def load_scene(directory: str | Path, collect_errors: bool = False) -> Scene:
    """Load a scene directory.

    With ``collect_errors=True``, per-ship loading failures are aggregated
    into ``Scene.errors`` instead of aborting, the way the app surfaces
    loading problems in its errors window (load/mod.rs:205-244) rather than
    crashing.
    """
    directory = Path(directory)
    state = load_state(directory / "state.json")
    settings_path = directory / "ephemeris.json"
    settings = load_ephemerides_settings(settings_path) if settings_path.exists() else None
    ships = []
    errors: list[str] = []
    ships_dir = directory / "ships"
    if ships_dir.is_dir():
        for p in sorted(ships_dir.glob("*.json")):
            try:
                ships.append(load_ship(p))
            except Exception as e:  # noqa: BLE001
                if not collect_errors:
                    raise
                errors.append(f"{p.name}: {e}")
    return Scene(state=state, settings=settings, ships=ships, errors=errors)


# ---------------------------------------------------------------------------
# Export (ui/windows/export.rs:222-256 format)
# ---------------------------------------------------------------------------


def state_to_json(state: SolarSystemState) -> str:
    data = {
        "name": state.name,
        "epoch": str(state.epoch),
        "bodies": [
            {
                "name": b.name,
                "mu": b.mu,
                "position": list(map(float, b.position)),
                "velocity": list(map(float, b.velocity)),
            }
            for b in state.bodies
        ],
    }
    return json.dumps(data, indent=2)


def save_state(state: SolarSystemState, path: str | Path) -> None:
    Path(path).write_text(state_to_json(state))


def ship_to_json(ship: Ship) -> str:
    data = {
        "name": ship.name,
        "integrator": ship.integrator,
        "tolerance": ship.tolerance,
        "start": str(ship.start),
        "end": str(ship.end),
        "position": list(map(float, ship.position)),
        "velocity": list(map(float, ship.velocity)),
        "burns": [
            {
                "start": str(b.start),
                "duration": str(b.duration),
                "acceleration": list(map(float, b.acceleration)),
                **({"reference": b.reference} if b.reference is not None else {}),
            }
            for b in ship.burns
        ],
    }
    return json.dumps(data, indent=2)


# ---------------------------------------------------------------------------
# Body visuals (physical subset of *.visuals.toml)
# ---------------------------------------------------------------------------


@dataclass
class BodyVisuals:
    """The engine-relevant subset of a body's visuals TOML.

    The loader mirrors BodyVisualsLoader's [physical] section
    (load/solar_system/loaders.rs:46-96): triaxial radii [km] and IAU-style
    spin parameters (radians / radians-per-day), plus the orbit-plot
    reference/color as plain data.  Material/texture fields are rendering
    concerns and ignored here.
    """

    radii: np.ndarray                        # (3,) km
    right_ascension: float = 0.0
    declination: float = 0.0
    rotation_reference_epoch: Epoch = None
    rotation_reference: float = 0.0
    rotation_rate: float = 0.0               # rad/day
    orbit_reference: str | None = None
    orbit_color: str | None = None

    def __post_init__(self):
        if self.rotation_reference_epoch is None:
            self.rotation_reference_epoch = Epoch.parse("2000-01-01 12:00:00")

    @property
    def mean_radius(self) -> float:
        return float(np.mean(self.radii))

    def rotating(self):
        from ..rotation import Rotating

        return Rotating(
            right_ascension=self.right_ascension,
            declination=self.declination,
            reference_epoch=self.rotation_reference_epoch,
            reference_rotation=self.rotation_reference,
            rotation_rate=self.rotation_rate,
        )


def load_visuals(path: str | Path) -> BodyVisuals:
    import tomllib

    data = tomllib.loads(Path(path).read_text())
    phys = data.get("physical", {})
    orbit = data.get("orbit", {})
    radii = np.asarray(phys.get("radii", [100.0, 100.0, 100.0]), dtype=np.float64)
    epoch = phys.get("rotation_reference_epoch")
    return BodyVisuals(
        radii=radii,
        right_ascension=float(phys.get("right_ascension", 0.0)),
        declination=float(phys.get("declination", 0.0)),
        rotation_reference_epoch=Epoch.parse(epoch) if epoch else None,
        rotation_reference=float(phys.get("rotation_reference", 0.0)),
        rotation_rate=float(phys.get("rotation_rate", 0.0)),
        orbit_reference=orbit.get("reference"),
        orbit_color=orbit.get("color"),
    )


def load_visuals_dir(directory: str | Path) -> dict[str, BodyVisuals]:
    """name (lowercase stem) -> BodyVisuals for every *.visuals.toml."""
    out = {}
    for p in sorted(Path(directory).glob("*.visuals.toml")):
        out[p.name.replace(".visuals.toml", "")] = load_visuals(p)
    return out
