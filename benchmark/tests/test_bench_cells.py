"""BENCHMARK.json: the contract's shape, and every name finds its file."""

import json
import re
from pathlib import Path

import pytest

from harness import cells

BENCH = cells.BENCH
ROOT = cells.ROOT
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"] and DOC["command"][1] == "benchmark/run.py"
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in DOC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in DOC["end_to_end"])


def test_every_name_finds_its_files():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in DOC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        entry = cells.find_cell(w["name"], DOC)["traffic"]["entry"]
        assert (BENCH / "entries" / f"{entry}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] in (1, 4)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert callable(cells.reader(m["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in cells.metrics_of(DOC, cell, False)]
    per = cells.metrics_of(DOC, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e                       # a metric moves one its cell reports
    found = cells.find_cell(cell, DOC)
    entry = cells.entry(found["traffic"]["entry"])
    assert all(callable(getattr(entry, f)) for f in ("setup", "request", "sizes", "close",
                                                     "judge"))


def test_layers_are_named_alike():
    by_prefix = {}
    for m in DOC["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0].split("_roofline")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.find_cell("no.such.cell", DOC)


@pytest.mark.parametrize("kind", ["entry", "reader"])
def test_unknown_file_raises(kind):
    with pytest.raises(KeyError):
        getattr(cells, kind)("no_such_name")


def test_overrides_replace_keys():
    cell = cells.find_cell("cluster4096.ensemble16_f64", DOC, {"config": {"bodies": 8}})
    assert cell["config"]["bodies"] == 8 and cell["traffic"]["members"] == 16
