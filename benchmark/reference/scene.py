"""The scene files as plain data: epochs, durations, bodies, settings, a ship.

Reads the upstream project's JSON formats (``state.json``, ``ephemeris.json``
and a ship file) on its own.  An epoch is the count of seconds since
1958-01-01 00:00:00 on the proleptic Gregorian calendar, with no leap
seconds, as the upstream ``ftime`` crate counts it.
"""

from __future__ import annotations

import datetime as _dt
import json
import re
from pathlib import Path

import numpy as np

_EPOCH0 = _dt.datetime(1958, 1, 1)
_UNIT_S = {}
for _names, _s in [
    (("y", "yr", "yrs", "year", "years"), 365.25 * 86400.0),
    (("d", "day", "days"), 86400.0),
    (("h", "hr", "hrs", "hour", "hours"), 3600.0),
    (("m", "min", "mins", "minute", "minutes"), 60.0),
    (("s", "sec", "secs", "second", "seconds"), 1.0),
    (("ms", "msec", "msecs", "millisecond", "milliseconds"), 1e-3),
]:
    for _n in _names:
        _UNIT_S[_n] = _s


def epoch_s(text: str) -> float:
    """'YYYY-MM-DD HH:MM:SS[.fff]' as seconds since 1958-01-01."""
    fmt = "%Y-%m-%d %H:%M:%S.%f" if "." in text else "%Y-%m-%d %H:%M:%S"
    return (_dt.datetime.strptime(text.strip(), fmt) - _EPOCH0).total_seconds()


def duration_s(text: str) -> float:
    """'5 min 15 s', '10 minutes', '1 d 2 h' as seconds."""
    parts = re.findall(r"(-?[0-9.]+)\s*([a-z]+)", text.strip().lower())
    if not parts:
        raise ValueError(f"not a duration: {text!r}")
    return sum(float(v) * _UNIT_S[u] for v, u in parts)


def load_state(path: Path) -> dict:
    """{'epoch_s', 'names', 'mu' (N,), 'pos' (N, 3), 'vel' (N, 3)}."""
    d = json.loads(Path(path).read_text())
    bodies = d["bodies"]
    return {
        "epoch_s": epoch_s(d["epoch"]),
        "names": [b["name"] for b in bodies],
        "mu": np.array([float(b["mu"]) for b in bodies]),
        "pos": np.array([b["position"] for b in bodies], dtype=np.float64),
        "vel": np.array([b["velocity"] for b in bodies], dtype=np.float64),
    }


def load_settings(path: Path, names: list[str]) -> dict:
    """{'dt_s', 'count' (N,) int, 'degree' (N,) int} in the order of ``names``."""
    d = json.loads(Path(path).read_text())
    s = d["settings"]
    return {
        "dt_s": duration_s(d["dt"]),
        "count": np.array([int(s[n]["count"]) for n in names]),
        "degree": np.array([int(s[n]["degree"]) for n in names]),
    }


def load_ship(path: Path) -> dict:
    """{'name', 'method', 'tol', 'start_s', 'end_s', 'pos', 'vel', 'burns'},
    each burn {'start_s', 'end_s', 'accel' (3,), 'reference' (a body name or
    None)}."""
    d = json.loads(Path(path).read_text())
    burns = []
    for b in d.get("burns", []):
        start = epoch_s(b["start"])
        burns.append({"start_s": start, "end_s": start + duration_s(b["duration"]),
                      "accel": np.asarray(b["acceleration"], dtype=np.float64),
                      "reference": b.get("reference")})
    return {
        "name": d["name"], "method": d["integrator"], "tol": float(d["tolerance"]),
        "start_s": epoch_s(d["start"]), "end_s": epoch_s(d["end"]),
        "pos": np.asarray(d["position"], dtype=np.float64),
        "vel": np.asarray(d["velocity"], dtype=np.float64),
        "burns": burns,
    }
