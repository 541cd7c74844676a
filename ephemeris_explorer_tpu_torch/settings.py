"""Persistent application settings (settings.toml).

Rebuilds the reference's ``PersistentSettingsPlugin``
(``ephemeris_explorer/src/settings.rs:59-189``): settings live in a
``settings.toml`` under the OS config directory, load tolerantly (missing or
malformed file falls back to defaults), and write back automatically on
every change.  The file layout matches the reference's ``[user]`` /
``[window]`` tables so a UI front could share it; keys this engine does not
consume (bloom, fov, labels, ...) round-trip unmodified.

Compute-relevant keys:

* ``user.system_path``   - scene directory to load (settings.rs:57)
* ``user.time_scale``    - simulation clock multiplier
* ``user.method``        - celestial integrator (QuinlanTremaine12, ...)
* ``user.precision``     - engine state precision ("auto"/"f64"/"extended")
* ``user.auto_extend``   - whether the session auto-extends coverage

Port of ``ephemeris_explorer_tpu.settings`` (host code, copied).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

DEFAULT_SYSTEM_PATH = "systems/full_solar_system_2433282.5"
APP_DIR = "Ephemeris Explorer"  # same config subdir as the reference


def config_dir() -> Path:
    """OS config dir (dirs::config_dir analogue; honors XDG_CONFIG_HOME)."""
    xdg = os.environ.get("XDG_CONFIG_HOME")
    if xdg:
        return Path(xdg)
    return Path.home() / ".config"


def default_settings_path() -> Path:
    return config_dir() / APP_DIR / "settings.toml"


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def _dump_toml(tables: dict[str, dict[str, Any]]) -> str:
    out = []
    for table, kv in tables.items():
        out.append(f"[{table}]")
        for k, v in kv.items():
            out.append(f"{k} = {_toml_value(v)}")
        out.append("")
    return "\n".join(out)


@dataclass
class AppSettings:
    """settings.rs:31-55 AppSettings, compute-relevant subset + passthrough."""

    system_path: str = DEFAULT_SYSTEM_PATH
    time_scale: float = 1.0
    method: str = "QuinlanTremaine12"
    precision: str = "auto"
    auto_extend: bool = True
    # unconsumed [user]/[window] keys preserved across load/save
    user_extra: dict[str, Any] = field(default_factory=dict)
    window: dict[str, Any] = field(default_factory=dict)
    path: Path | None = None
    autosave: bool = True

    _OWN_KEYS = ("system_path", "time_scale", "method", "precision", "auto_extend")

    # -- load (settings.rs Default impl: tolerant, defaults on failure) ----
    @classmethod
    def load(cls, path: str | Path | None = None, autosave: bool = True) -> "AppSettings":
        p = Path(path) if path is not None else default_settings_path()
        s = cls(path=p, autosave=autosave)
        try:
            data = tomllib.loads(p.read_text())
        except (OSError, tomllib.TOMLDecodeError):
            return s
        user = dict(data.get("user", {}))
        for k in cls._OWN_KEYS:
            if k in user:
                setattr(s, k, user.pop(k))
        s.user_extra = user
        s.window = dict(data.get("window", {}))
        return s

    # -- write-on-change (AppSettings::write, settings.rs:166-189) ---------
    def set(self, key: str, value: Any) -> None:
        if key in self._OWN_KEYS:
            setattr(self, key, value)
        else:
            self.user_extra[key] = value
        if self.autosave:
            self.save()

    def save(self, path: str | Path | None = None) -> Path:
        p = Path(path) if path is not None else (self.path or default_settings_path())
        user: dict[str, Any] = {k: getattr(self, k) for k in self._OWN_KEYS}
        user.update(self.user_extra)
        tables: dict[str, dict[str, Any]] = {"user": user}
        if self.window:
            tables["window"] = self.window
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(_dump_toml(tables))
        self.path = p
        return p
