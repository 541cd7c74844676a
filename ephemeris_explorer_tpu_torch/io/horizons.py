"""JPL Horizons client + DE440 GM table + state.json generation.

Rebuilds the reference's ``horizons_solar_system`` crate and the
``solar_system_json`` CLI:

* :func:`gravitational_parameters` parses the bundled ``gm_de440.tpc``
  (public JPL data; mu in km^3/s^2) exactly like ``data.rs:4-31``;
* :func:`fetch_body` / :func:`fetch_solar_system` read Horizons API
  responses (EPHEM_TYPE=VECTORS, CENTER=500@0 SSB, ICRF frame, KM-S units,
  TT times converted to TAI via the fixed 32.184 s offset,
  ``lib.rs:36-44, 68-121``) from a local on-disk cache keyed by the request
  (mirroring the test suite's bincode fixture cache,
  ``ephemeris/tests/common/mod.rs``);
* :func:`write_state_json` emits a ``solar_system_<JD>.json`` scene like the
  ``solar_system_json`` CLI (``main.rs:62-83``).

Port of ``ephemeris_explorer_tpu.io.horizons``, its offline path only: the
request URL, the cache key, the CSV parsing, the TT/TAI conversion and
``write_state_json`` are copied, and the port never opens a network
connection.  A request whose response is not in the cache raises, whatever
``offline`` says; record the response under ``cache_dir`` (the file
:func:`cache_path_for` names) to use it.
"""

from __future__ import annotations

import hashlib
import urllib.parse
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..ftime import Duration, Epoch
from .naif_ids import NAIF_IDS, NAIF_NAMES
from .scene import Body, SolarSystemState, state_to_json

# TT = TAI + 32.184 s (lib.rs:36-44)
TT_MINUS_TAI = 32.184

HORIZONS_URL = "https://ssd.jpl.nasa.gov/api/horizons.api"

_GM_FILE = Path(__file__).with_name("gm_de440.tpc")


@lru_cache(maxsize=1)
def gravitational_parameters() -> dict[int, float]:
    """NAIF id -> mu [km^3/s^2] from the bundled DE440 text kernel."""
    out: dict[int, float] = {}
    for line in _GM_FILE.read_text().splitlines():
        b = line.find("BODY")
        gm = line.find("_GM")
        po = line.find("(")
        pc = line.find(")")
        if b < 0 or gm < 0 or po < 0 or pc < 0:
            continue
        try:
            naif = int(line[b + 4 : gm])
            val = float(line[po + 1 : pc].strip().replace("D", "E"))
        except ValueError:
            continue
        out[naif] = val
    return out


def to_tt(epoch: Epoch) -> Epoch:
    return Epoch.from_offset_seconds(epoch.as_offset_seconds() + TT_MINUS_TAI)


def from_tt(epoch: Epoch) -> Epoch:
    return Epoch.from_offset_seconds(epoch.as_offset_seconds() - TT_MINUS_TAI)


def _to_iso(epoch: Epoch) -> str:
    s = str(epoch)  # "YYYY-MM-DD HH:MM:SS.mmm"
    return s.replace(" ", "T")


_HORIZONS_MONTHS = {
    "Jan": "01", "Feb": "02", "Mar": "03", "Apr": "04", "May": "05",
    "Jun": "06", "Jul": "07", "Aug": "08", "Sep": "09", "Oct": "10",
    "Nov": "11", "Dec": "12",
}


def _from_horizons_date(date_str: str) -> Epoch:
    """Parse 'A.D. 1950-Jan-01 00:00:00.0000' (lib.rs from_horizons_date).

    The calendar-date column honors TIME_TYPE=TT; the first (JDTDB) column
    is in the TDB timescale and would carry a periodic ~1.7 ms TDB-TT error,
    so the reference — and we — parse this column instead.
    """
    _, _, rest = date_str.partition(" ")
    i = rest.find("-") + 1
    mon = rest[i : i + 3]
    return Epoch.parse(rest[: i] + _HORIZONS_MONTHS[mon] + rest[i + 3 :])


def _parse_csv_line(line: str):
    """One $$SOE CSV row: JDTDB, date(TT), x, y, z, vx, vy, vz, ..."""
    parts = [p.strip() for p in line.split(",")]
    epoch = Epoch.from_offset_seconds(
        _from_horizons_date(parts[1]).as_offset_seconds() - TT_MINUS_TAI
    )
    vec = [float(v) for v in parts[2:8]]
    return epoch, np.array(vec[:3]), np.array(vec[3:6])


def request_url(naif_id: int, start: Epoch, end: Epoch, step: Duration) -> str:
    """The exact Horizons API request (lib.rs:75-98): VECTORS, SSB center,
    ICRF frame, KM-S units, TT times."""
    params = {
        "format": "text",
        "MAKE_EPHEM": "YES",
        "COMMAND": str(naif_id),
        "EPHEM_TYPE": "VECTORS",
        "OBJ_DATA": "NO",
        "CENTER": "500@0",
        "TIME_TYPE": "TT",
        "START_TIME": _to_iso(to_tt(start)),
        "STOP_TIME": _to_iso(to_tt(end)),
        "STEP_SIZE": str(step).replace(" ", ""),
        "REF_SYSTEM": "ICRF",
        "REF_PLANE": "FRAME",
        "VEC_TABLE": "2",
        "OUT_UNITS": "KM-S",
        "VEC_CORR": "NONE",
        "CSV_FORMAT": "YES",
    }
    return HORIZONS_URL + "?" + urllib.parse.urlencode(params)


def cache_path_for(cache_dir: str | Path, url: str) -> Path:
    """On-disk cache location for a request (the bincode-cache analogue of
    ephemeris/tests/common/mod.rs:10-92, keyed by the request hash)."""
    key = hashlib.sha256(url.encode()).hexdigest()[:24]
    return Path(cache_dir) / f"horizons_{key}.txt"


def parse_response(text: str, naif_id: int, name: str):
    """Parse a Horizons text response into [(epoch, Body)] (lib.rs:100-121)."""
    i = text.find("$$SOE")
    j = text.find("$$EOE")
    if i < 0 or j < 0:
        raise ValueError(f"Horizons response missing SOE/EOE: {text[:400]}")
    mu = gravitational_parameters()[naif_id]
    out = []
    for line in text[i + 6 : j - 1].splitlines():
        epoch, pos, vel = _parse_csv_line(line)
        out.append((epoch, Body(name=name, mu=mu, position=pos, velocity=vel)))
    return out


def fetch_body(
    naif_id: int | str,
    start: Epoch,
    end: Epoch,
    step: Duration,
    cache_dir: str | Path | None = None,
    offline: bool = False,
):
    """[(epoch, Body)] vectors of a recorded Horizons response (lib.rs:68-121).

    ``offline`` is the reference's switch for fetching on a cache miss; the
    port does not fetch, so a miss raises either way."""
    if isinstance(naif_id, str):
        name = naif_id
        naif_id = NAIF_IDS[naif_id]
    else:
        name = NAIF_NAMES.get(naif_id, str(naif_id))

    url = request_url(naif_id, start, end, step)

    cache_path = cache_path_for(cache_dir, url) if cache_dir is not None else None
    if cache_path is None or not cache_path.exists():
        raise RuntimeError(
            f"offline and no cache for {name} ({url}): the port reads recorded "
            f"Horizons responses only (cache_dir={cache_dir})"
        )
    return parse_response(cache_path.read_text(), naif_id, name)


def fetch_solar_system(
    objects,
    start: Epoch,
    end: Epoch,
    step: Duration,
    cache_dir=None,
    offline: bool = False,
) -> list[SolarSystemState]:
    """One SolarSystemState per sampled epoch (lib.rs:124-145)."""
    systems: list[SolarSystemState] = []
    for obj in objects:
        rows = fetch_body(obj, start, end, step, cache_dir=cache_dir, offline=offline)
        for i, (epoch, body) in enumerate(rows):
            if i < len(systems):
                systems[i].bodies.append(body)
            else:
                systems.append(
                    SolarSystemState(name="Solar System", epoch=epoch, bodies=[body])
                )
    return systems


def write_state_json(
    objects,
    epoch: Epoch,
    out_dir: str | Path = ".",
    cache_dir=None,
    offline: bool = False,
) -> Path:
    """The solar_system_json CLI (main.rs:62-83): fetch one instant, write
    ``solar_system_<JD>.json``."""
    systems = fetch_solar_system(
        objects, epoch, epoch + Duration.from_seconds(1.0), Duration.from_seconds(60.0),
        cache_dir=cache_dir, offline=offline,
    )
    state = systems[0]
    jd = state.epoch.to_jd()
    path = Path(out_dir) / f"solar_system_{jd}.json"
    path.write_text(state_to_json(state))
    return path


def _cli(argv=None) -> int:
    """solar_system_json CLI equivalent (solar_system_json/src/main.rs:62-83).

    Usage: python -m ephemeris_explorer_tpu_torch.io.horizons "1950-01-01 00:00:00" \
               Sun Mercury Venus Earth Moon Mars --cache DIR [--out DIR]
    """
    import argparse

    p = argparse.ArgumentParser(description=_cli.__doc__)
    p.add_argument("epoch", help='TAI epoch "YYYY-MM-DD HH:MM:SS"')
    p.add_argument("bodies", nargs="+", help="NAIF body names (see naif_ids.py)")
    p.add_argument("--out", default=".")
    p.add_argument("--cache", required=True, help="directory of recorded responses")
    args = p.parse_args(argv)
    path = write_state_json(
        args.bodies, Epoch.parse(args.epoch), out_dir=args.out, cache_dir=args.cache,
        offline=True,
    )
    print(path)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_cli())
