"""Finding a cell, its configuration, its traffic, its limits and its metrics
by the names that ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, one traffic mix, one program
entry or one metric is a file of its own: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``entries/<entry>.py`` (the mix names it),
``limits/<cell>.json`` and ``metrics/<metric>.py``.  A new cell, mix, entry
or metric is a new file and a new entry, never an edit of one that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]      # the benchmark's folder
ROOT = BENCH.parent                              # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def find_cell(name: str, bench: dict, overrides: dict | None = None) -> dict:
    """The cell ``name``: its entry in ``workloads`` with the configuration,
    traffic and limits it names, loaded (``overrides`` replaces keys of
    them, for tests at small sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    overrides = overrides or {}
    config = _merge(json.loads((ROOT / cfg_entry["file"]).read_text()), overrides.get("config"))
    traffic = _merge(json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                     overrides.get("traffic"))
    limits = _merge(json.loads((BENCH / "limits" / f"{name}.json").read_text()),
                    overrides.get("limits"))
    return {"name": name, "chips": w["chips"], "config_name": w["config"], "config": config,
            "traffic_name": w["traffic"], "traffic": traffic, "limits": limits}


def applies(metric: dict, cell: str, end_to_end: list[dict]) -> bool:
    """Whether ``cell`` reports ``metric``: a metric with ``workloads`` in
    those cells; an end-to-end one without it everywhere; a per-layer one
    without it wherever its ``moves`` metric is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in end_to_end if m["name"] == metric["moves"])
    return applies(moved, cell, end_to_end)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if applies(m, cell, bench["end_to_end"])]


def _load(folder: str, name: str):
    """``<folder>/<name>.py``, loaded from its path (a name may hold dots)."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The metric ``name``'s reader, ``metrics/<name>.py`` (its ``read``)."""
    return _load("metrics", name)


def entry(name: str):
    """The program entry ``name`` that a mix drives: the class ``Entry`` of
    ``entries/<name>.py``."""
    return _load("entries", name).Entry
