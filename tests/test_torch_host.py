"""The port's host layer against the JAX package: scenes, time, tableaux.

These modules are copies of host code (no JAX in either), so every check
here is exact equality.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu import ftime as jftime
from ephemeris_explorer_tpu.integrators import methods as jmethods
from ephemeris_explorer_tpu.io import scene as jscene
from ephemeris_explorer_tpu_torch import ftime as tftime
from ephemeris_explorer_tpu_torch import interop
from ephemeris_explorer_tpu_torch.integrators import methods as tmethods
from ephemeris_explorer_tpu_torch.io import scene as tscene

REPO = Path(__file__).resolve().parent.parent
SCENES = sorted(p.name for p in (REPO / "systems").iterdir() if (p / "state.json").exists())


@pytest.mark.parametrize("name", SCENES)
def test_load_scene_equal(name):
    """load_scene gives equal states, settings and ships on every bundled scene."""
    j = jscene.load_scene(REPO / "systems" / name)
    t = tscene.load_scene(REPO / "systems" / name)
    assert t.state.name == j.state.name
    assert str(t.state.epoch) == str(j.state.epoch)
    assert t.state.epoch.as_offset_seconds() == j.state.epoch.as_offset_seconds()
    assert [b.name for b in t.state.bodies] == [b.name for b in j.state.bodies]
    np.testing.assert_array_equal(t.state.positions(), j.state.positions())
    np.testing.assert_array_equal(t.state.velocities(), j.state.velocities())
    np.testing.assert_array_equal(t.state.mus(), j.state.mus())
    assert t.settings.dt.as_seconds() == j.settings.dt.as_seconds()
    assert {k: (v.degree, v.count) for k, v in t.settings.settings.items()} == {
        k: (v.degree, v.count) for k, v in j.settings.settings.items()
    }
    assert [s.name for s in t.ships] == [s.name for s in j.ships]
    # the exported JSON is byte-identical, and interop carries the JAX state over
    assert tscene.state_to_json(t.state) == jscene.state_to_json(j.state)
    assert tscene.state_to_json(interop.state_from(j.state)) == jscene.state_to_json(j.state)


@pytest.mark.parametrize("name", sorted(jmethods.REGISTRY))
def test_tableaux_equal(name):
    """Every named method's coefficients are equal (QT12 and its BlanesMoan6B
    starter are the ones the slice runs)."""
    j, t = jmethods.get(name), tmethods.get(name)
    assert type(t).__name__ == type(j).__name__
    for field, jv in vars(j).items():
        tv = getattr(t, field)
        if isinstance(jv, np.ndarray):
            np.testing.assert_array_equal(tv, jv, err_msg=f"{name}.{field}")
        else:
            assert tv == jv, (name, field)


@pytest.mark.parametrize(
    "text", ["1950-01-01 00:00:00.000", "2000-01-01 12:00:00", "2026-10-16 08:22:53.125"]
)
def test_epoch_parse_format_equal(text):
    j, t = jftime.Epoch.parse(text), tftime.Epoch.parse(text)
    assert t.as_offset_seconds() == j.as_offset_seconds()
    assert str(t) == str(j)


@pytest.mark.parametrize("text", ["10 minutes", "6 hour", "1 y 2 d 3 h 4 m 5 s 6 ms"])
def test_duration_parse_format_equal(text):
    j, t = jftime.Duration.parse(text), tftime.Duration.parse(text)
    assert t.as_seconds() == j.as_seconds()
    assert str(t) == str(j)


def test_import_leaves_jax_out():
    """Importing the port (and its generation path) never imports JAX."""
    code = (
        "import sys\n"
        "import ephemeris_explorer_tpu_torch\n"
        "import ephemeris_explorer_tpu_torch.ephemeris, ephemeris_explorer_tpu_torch.interop\n"
        "import ephemeris_explorer_tpu_torch.ops.cuda_nbody, ephemeris_explorer_tpu_torch.ops.cuda_elm2\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m.split('.')[0] == 'ephemeris_explorer_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
