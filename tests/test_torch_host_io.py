"""The port's host leftovers against the JAX package's: settings.toml, the
Horizons client's offline path, the NAIF id and DE440 GM tables, rotations
and the body-visuals loader.

These are copies of host code (no JAX in either package), so every check
against the JAX package is exact equality.  The Horizons cases run from
recorded responses written into ``tmp_path``; nothing here opens a network
connection.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu import Duration as JDuration
from ephemeris_explorer_tpu import Epoch as JEpoch
from ephemeris_explorer_tpu import rotation as jrotation
from ephemeris_explorer_tpu import settings as jsettings
from ephemeris_explorer_tpu.io import horizons as jhorizons
from ephemeris_explorer_tpu.io import naif_ids as jnaif
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu_torch import Duration, Epoch, rotation
from ephemeris_explorer_tpu_torch.io import horizons, scene
from ephemeris_explorer_tpu_torch.io.naif_ids import NAIF_IDS, NAIF_NAMES
from ephemeris_explorer_tpu_torch.settings import (
    DEFAULT_SYSTEM_PATH,
    AppSettings,
    default_settings_path,
)

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"
PKG = Path(__file__).resolve().parent.parent / "ephemeris_explorer_tpu_torch"


# ---------------------------------------------------------------------------
# settings.toml (test_settings.py)
# ---------------------------------------------------------------------------


def test_defaults_when_missing(tmp_path):
    s = AppSettings.load(tmp_path / "nope" / "settings.toml")
    assert s.system_path == DEFAULT_SYSTEM_PATH == jsettings.DEFAULT_SYSTEM_PATH
    assert s.time_scale == 1.0
    assert s.method == "QuinlanTremaine12"


def test_roundtrip_and_write_on_change(tmp_path):
    p = tmp_path / "settings.toml"
    s = AppSettings.load(p)
    s.set("time_scale", 1000.0)       # auto-writes
    s.set("system_path", "systems/sun_earth_moon_2433282.5")
    assert p.exists()

    s2 = AppSettings.load(p)
    assert s2.time_scale == 1000.0
    assert s2.system_path == "systems/sun_earth_moon_2433282.5"
    assert s2.auto_extend is True
    # the JAX package writes the same file for the same changes
    jp = tmp_path / "jax.toml"
    js = jsettings.AppSettings.load(jp)
    js.set("time_scale", 1000.0)
    js.set("system_path", "systems/sun_earth_moon_2433282.5")
    assert p.read_text() == jp.read_text()


def test_unknown_keys_preserved(tmp_path):
    """UI-only keys (bloom, fov, window geometry) round-trip unmodified so
    the file can be shared with a rendering front (settings.rs:31-48)."""
    text = (
        "[user]\n"
        'system_path = "systems/full_solar_system_2433282.5"\n'
        "bloom_intensity = 0.15\n"
        "fov = 45.0\n"
        "show_labels = true\n"
        "[window]\n"
        "size = [1280.0, 720.0]\n"
        "position = [0, 0]\n"
    )
    p, jp = tmp_path / "settings.toml", tmp_path / "jax.toml"
    p.write_text(text)
    jp.write_text(text)
    s = AppSettings.load(p)
    assert s.user_extra["bloom_intensity"] == 0.15
    assert s.window["size"] == [1280.0, 720.0]
    s.set("time_scale", 50.0)
    s2 = AppSettings.load(p)
    assert s2.user_extra["fov"] == 45.0
    assert s2.user_extra["show_labels"] is True
    assert s2.window["position"] == [0, 0]
    assert s2.time_scale == 50.0
    jsettings.AppSettings.load(jp).set("time_scale", 50.0)
    assert p.read_text() == jp.read_text()


def test_malformed_file_falls_back(tmp_path):
    p = tmp_path / "settings.toml"
    p.write_text("not [valid toml ===")
    s = AppSettings.load(p)
    assert s.system_path == DEFAULT_SYSTEM_PATH


def test_default_path_is_config_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert default_settings_path() == tmp_path / "Ephemeris Explorer" / "settings.toml"
    assert default_settings_path() == jsettings.default_settings_path()


# ---------------------------------------------------------------------------
# Horizons, offline (test_horizons.py)
# ---------------------------------------------------------------------------

_MONTH_ABBR = {v: k for k, v in horizons._HORIZONS_MONTHS.items()}


def _horizons_date(tt: Epoch) -> str:
    """Format a TT epoch the way Horizons prints the calendar column:
    'A.D. 1950-Jan-01 00:00:32.1840'."""
    s = str(tt)  # "1950-01-01 00:00:32.184"
    return f"A.D. {s[:5]}{_MONTH_ABBR[s[5:7]]}{s[7:]}0"


def _fake_response(rows) -> str:
    """A format-faithful Horizons text response (header + $$SOE CSV block).

    The vector DATA comes from the bundled real snapshot; only the framing
    text is reconstructed, matching what lib.rs:100-121 consumes.
    """
    lines = [
        "API VERSION: 1.2",
        "API SOURCE: NASA/JPL Horizons API",
        "*" * 79,
        "Ephemeris / API_USER",
        "Center body name: Solar System Barycenter (0)     {source: DE441}",
        "Output units    : KM-S",
        "Output type     : GEOMETRIC cartesian states",
        "Output format   : 2 (position and velocity)",
        "Reference frame : ICRF",
        "*" * 79,
        "JDTDB, Calendar Date (TDB), X, Y, Z, VX, VY, VZ,",
        "*" * 24,
        "$$SOE",
    ]
    for tt, pos, vel in rows:
        jd = tt.to_jd()
        nums = ", ".join(f"{v: .16E}" for v in (*pos, *vel))
        lines.append(f"{jd:.9f}, {_horizons_date(tt)}, {nums},")
    lines += ["$$EOE", "*" * 79]
    return "\n".join(lines) + "\n"


def test_fetch_cache_roundtrip(tmp_path):
    """fetch_body end-to-end offline: request URL -> cache key -> response
    parse -> TT->TAI epoch conversion -> Body with DE440 mu.  The recorded
    response carries the REAL vectors of the bundled 1950-01-01 snapshot, so
    the parsed output must reproduce systems/sun_earth_moon_2433282.5
    byte-for-byte through write_state_json, as the JAX package's does."""
    bundled = scene.load_state(SYSTEMS / "sun_earth_moon_2433282.5" / "state.json")
    start = bundled.epoch
    end = start + Duration.from_seconds(1.0)
    step = Duration.from_seconds(60.0)
    tt = horizons.to_tt(start)

    for b in bundled.bodies:
        url = horizons.request_url(NAIF_IDS[b.name], start, end, step)
        p = horizons.cache_path_for(tmp_path, url)
        p.write_text(_fake_response([(tt, b.position, b.velocity)]))
        # the same request, the same cache key in both packages
        jstart = JEpoch.from_offset_seconds(start.as_offset_seconds())
        jurl = jhorizons.request_url(NAIF_IDS[b.name], jstart, jstart + JDuration(1.0),
                                     JDuration(60.0))
        assert url == jurl and p == jhorizons.cache_path_for(tmp_path, jurl)

    # offline fetch must hit the cache and parse
    rows = horizons.fetch_body("Earth", start, end, step, cache_dir=tmp_path, offline=True)
    assert len(rows) == 1
    epoch, body = rows[0]
    assert abs(epoch.as_offset_seconds() - start.as_offset_seconds()) < 1e-9
    i = bundled.body_index("Earth")
    np.testing.assert_allclose(body.position, bundled.bodies[i].position, rtol=1e-15)
    np.testing.assert_allclose(body.velocity, bundled.bodies[i].velocity, rtol=1e-15)
    assert abs(body.mu - 398600.435507) < 1e-3  # DE440 Earth GM, not the file's

    # the CLI path writes a state.json whose bodies match the bundled scene
    out_dir = tmp_path / "port"
    out_dir.mkdir()
    out = horizons.write_state_json(
        [b.name for b in bundled.bodies], start,
        out_dir=out_dir, cache_dir=tmp_path, offline=True,
    )
    assert out.name == "solar_system_2433282.5.json"
    got = json.loads(out.read_text())
    want = json.loads((SYSTEMS / "sun_earth_moon_2433282.5" / "state.json").read_text())
    # reference Epoch Display always writes .mmm (epoch.rs:244-246); the
    # bundled file's bare "00:00:00" predates that, so compare parsed epochs
    assert Epoch.parse(got["epoch"]) == Epoch.parse(want["epoch"])
    for gb, wb in zip(got["bodies"], want["bodies"]):
        assert gb["name"] == wb["name"]
        np.testing.assert_allclose(gb["position"], wb["position"], rtol=1e-15)
        np.testing.assert_allclose(gb["velocity"], wb["velocity"], rtol=1e-15)
    jout_dir = tmp_path / "jax"
    jout_dir.mkdir()
    jout = jhorizons.write_state_json(
        [b.name for b in bundled.bodies], JEpoch.from_offset_seconds(start.as_offset_seconds()),
        out_dir=jout_dir, cache_dir=tmp_path, offline=True,
    )
    assert out.read_text() == jout.read_text()


@pytest.mark.parametrize("offline", [True, False])
def test_fetch_offline_without_cache_raises(tmp_path, offline):
    """A request with no recorded response raises: the port never fetches,
    whatever ``offline`` says."""
    with pytest.raises(RuntimeError, match="offline"):
        horizons.fetch_body(
            "Earth",
            Epoch.parse("1950-01-01 00:00:00"),
            Epoch.parse("1950-01-02 00:00:00"),
            Duration.from_hours(12.0),
            cache_dir=tmp_path,
            offline=offline,
        )


def test_gm_table():
    gm = horizons.gravitational_parameters()
    assert len(gm) > 50
    # DE440 values, km^3/s^2
    assert abs(gm[399] - 398600.435507) < 1e-3        # Earth
    assert abs(gm[10] - 1.32712440041e11) < 1e3       # Sun
    assert abs(gm[301] - 4902.800118) < 1e-3          # Moon
    # the port reads its own copy of the table, equal to the JAX package's
    assert horizons._GM_FILE == PKG / "io" / "gm_de440.tpc"
    assert horizons._GM_FILE.read_bytes() == jhorizons._GM_FILE.read_bytes()
    assert gm == jhorizons.gravitational_parameters()


def test_naif_ids():
    assert NAIF_IDS["Sun"] == 10
    assert NAIF_IDS["Earth"] == 399
    assert NAIF_IDS["Moon"] == 301
    assert NAIF_IDS["JupiterBarycenter"] == 5
    assert len(NAIF_IDS) >= 300
    assert NAIF_IDS == jnaif.NAIF_IDS and NAIF_NAMES == jnaif.NAIF_NAMES


def test_tt_tai_roundtrip():
    e = Epoch.parse("1950-01-01 00:00:00")
    assert abs(horizons.from_tt(horizons.to_tt(e)).as_offset_seconds() - e.as_offset_seconds()) < 1e-9
    assert abs(horizons.to_tt(e).as_offset_seconds() - e.as_offset_seconds() - 32.184) < 1e-6


def test_csv_line_parse():
    # JDTDB 2433282.5 (TT) = 1950-01-01 TT -> TAI is 32.184 s earlier
    line = "2433282.500000000, A.D. 1950-Jan-01 00:00:00.0000, 1.0e5, 2.0e5, 3.0e5, 1.5, -2.5, 0.25,"
    epoch, pos, vel = horizons._parse_csv_line(line)
    assert abs(epoch.as_offset_seconds() - (Epoch.parse("1950-01-01 00:00:00").as_offset_seconds() - 32.184)) < 1e-6
    np.testing.assert_array_equal(pos, [1.0e5, 2.0e5, 3.0e5])
    np.testing.assert_array_equal(vel, [1.5, -2.5, 0.25])
    jepoch, jpos, jvel = jhorizons._parse_csv_line(line)
    assert epoch.as_offset_seconds() == jepoch.as_offset_seconds()
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(vel, jvel)


# ---------------------------------------------------------------------------
# Rotations and body visuals (test_api.py::test_rotation,
# test_ephemeris.py::test_visuals_loading)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ra, dec, rate, days", [
    (0.0, np.pi / 2, np.pi, 1.0),
    (1.2, -0.4, 6.3003876824, 0.37),
    (4.0, 0.9, -2.5, 12.5),
])
def test_rotation_matches_jax(ra, dec, rate, days):
    """Axes, quaternions and rotated vectors equal the JAX package's."""
    rot = rotation.Rotating(ra, dec, Epoch.ZERO, 0.3, rate)
    jrot = jrotation.Rotating(ra, dec, JEpoch.ZERO, 0.3, rate)
    np.testing.assert_array_equal(rot.axis, jrot.axis)
    q = rot.at(Epoch.ZERO + Duration.from_days(days))
    jq = jrot.at(JEpoch.ZERO + JDuration.from_days(days))
    np.testing.assert_array_equal(q, jq)
    v = np.array([1.0, -2.0, 0.5])
    np.testing.assert_array_equal(rotation.quat_rotate(q, v), jrotation.quat_rotate(jq, v))
    assert abs(np.linalg.norm(q) - 1.0) < 1e-15


def test_visuals_loading():
    vis = scene.load_visuals_dir(SYSTEMS / "visuals")
    assert "earth" in vis and "moon" in vis
    earth = vis["earth"]
    assert abs(earth.radii[0] - 6378.1366) < 1e-6
    assert abs(earth.rotation_rate - 6.3003876824) < 1e-6
    assert earth.orbit_reference == "Sun"
    rot = earth.rotating()
    assert isinstance(rot, rotation.Rotating)
    q = rot.at(earth.rotation_reference_epoch)
    assert np.isfinite(q).all()
    # every visuals file loads to the JAX package's values
    jvis = jscene.load_visuals_dir(SYSTEMS / "visuals")
    assert sorted(vis) == sorted(jvis)
    for name, v in vis.items():
        jv = jvis[name]
        np.testing.assert_array_equal(v.radii, jv.radii)
        assert (v.right_ascension, v.declination, v.rotation_reference, v.rotation_rate,
                v.orbit_reference, v.orbit_color, v.mean_radius) == (
            jv.right_ascension, jv.declination, jv.rotation_reference, jv.rotation_rate,
            jv.orbit_reference, jv.orbit_color, jv.mean_radius)
        assert (v.rotation_reference_epoch.as_offset_seconds()
                == jv.rotation_reference_epoch.as_offset_seconds())
        t = v.rotation_reference_epoch + Duration.from_days(3.25)
        jt = jv.rotation_reference_epoch + JDuration.from_days(3.25)
        np.testing.assert_array_equal(v.rotating().at(t), jv.rotating().at(jt))
