"""Kernel 14's compile-time tableaux, on the CPU.

``csrc/fleet_tableaux.cuh`` holds each adaptive tableau that kernel 14 is
instanced for as hex-float literals (written by
``tools/gen_fleet_tableaux.py``).  Here the header's literals are held bit
for bit to the exact fractions of ``integrators/tableaux.py``;
``cuda_fleet.plan`` is held to pick each tableau's own instance, and to
refuse a tableau that no instance matches.  The kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``cuda``).
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu_torch.integrators import ADAPTIVE_METHODS, get
from ephemeris_explorer_tpu_torch.integrators.adaptive import AdaptiveParams
from ephemeris_explorer_tpu_torch.integrators.tableaux import METHODS
from ephemeris_explorer_tpu_torch.ops import cuda_fleet

ROOT = Path(__file__).resolve().parent.parent
HEADER = ROOT / "ephemeris_explorer_tpu_torch" / "csrc" / "fleet_tableaux.cuh"
HEX = r"-?0x[0-9a-f]+(?:\.[0-9a-f]*)?p[-+]?\d+"


def _bits(xs) -> np.ndarray:
    return np.asarray([float(x) for x in xs], dtype=np.float64).view(np.uint64)


def _header(name: str) -> dict:
    """The header's struct ``name``: its stage count and Nystrom flag, and
    each array's literals as bits (a matrix row by row, padded with zeros)."""
    body = re.search(r"struct " + name + r" \{\n(.*?)\n\};", HEADER.read_text(), re.S).group(1)
    s = int(re.search(r"kStages = (\d+);", body).group(1))
    out = {"stages": s, "nystrom": re.search(r"kNystrom = (\w+);", body).group(1) == "true"}
    for key, init in re.findall(r"double (\w+)\[[^=]*= (\{.*?\});", body, re.S):
        rows = re.findall(r"\{([^{}]*)\}", init[1:-1]) if key in ("kA", "kAV") else [init]
        vals = [[float.fromhex(x) for x in re.findall(HEX, row)] for row in rows]
        out[key] = (np.stack([_bits(v + [0] * (s - len(v))) for v in vals])
                    if key in ("kA", "kAV") else _bits(vals[0]))
    return out


def _exact(name: str) -> dict:
    """The tableau's coefficients from its exact fractions, by the header's
    array names."""
    spec = METHODS[name]
    s = len(spec["c"])
    nystrom = spec["kind"] == "erkng"
    keys = (("kA", "ap"), ("kAV", "av"), ("kB", "bp"), ("kBV", "bv"), ("kE", "ep"),
            ("kEV", "ev")) if nystrom else (("kA", "a"), ("kB", "b"), ("kE", "e"))
    out = {"stages": s, "nystrom": nystrom, "kC": _bits(spec["c"])}
    for key, src in keys:
        if key in ("kA", "kAV"):
            out[key] = np.stack([_bits(list(row) + [0] * (s - len(row))) for row in spec[src]])
        else:
            out[key] = _bits(spec[src])
    return out


def test_instances_are_the_served_tableaux():
    """The wrapper's numbering is the header's EET_FLEET_TABLEAUX order, one
    instance for each adaptive tableau."""
    macro = re.search(r"#define EET_FLEET_TABLEAUX\(X\) (.*)", HEADER.read_text()).group(1)
    assert re.findall(r"X\((\w+)\)", macro) == list(ADAPTIVE_METHODS)
    assert [name for name, *_ in cuda_fleet.instances()] == list(ADAPTIVE_METHODS)


@pytest.mark.parametrize("name", ADAPTIVE_METHODS)
def test_header_is_bitwise_the_exact_tableau(name):
    """Every array of the header's struct, each literal the f64 nearest its
    exact fraction, and no array more or fewer."""
    got, want = _header(name), _exact(name)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key], value), key


def test_header_is_what_the_generator_writes():
    sys.path.insert(0, str(ROOT / "tools"))
    from gen_fleet_tableaux import OUT, header

    assert OUT == HEADER and OUT.read_text() == header()


@pytest.mark.parametrize("name", ADAPTIVE_METHODS)
def test_plan_picks_the_tableaus_own_instance(name):
    """Each served tableau takes its own instance; the other launch
    arguments as before."""
    tab = get(name)
    p = cuda_fleet.plan(tab, AdaptiveParams(), True, False)
    assert cuda_fleet.instances()[p.instance][0] == name
    assert p.fsal == tab.fsal and p.burns and not p.frames
    assert p.prm[7] == -1.0 / tab.lower_order


@pytest.mark.parametrize("field", ["a", "b", "e", "c"])
def test_one_ulp_off_is_refused(field):
    """A copy of Verner87 with one coefficient one ulp away matches no
    instance, and plan refuses it; the registry's Verner87 still matches."""
    v87 = get("Verner87")
    arr = getattr(v87, field).copy()
    idx = (7, 3) if field == "a" else (5,)
    arr[idx] = np.nextafter(arr[idx], np.inf)
    off = dataclasses.replace(v87, **{field: arr})
    with pytest.raises(ValueError, match="no instance"):
        cuda_fleet.plan(off, AdaptiveParams(), True, True)
    assert cuda_fleet.instance_of(v87) == list(ADAPTIVE_METHODS).index("Verner87")
