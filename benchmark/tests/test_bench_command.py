"""The command as the check runs it: no result without the card or without
the program, and one JSON result line on the card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cwd: Path, cell: str, seconds: str = "1") -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 3), "--seconds", seconds, "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    out = _run(ROOT, cell, "2")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["device"]["platform"] == "gpu"
