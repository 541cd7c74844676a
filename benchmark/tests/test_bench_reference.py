"""Each cell's plain reference against the port's CPU route at a tiny size,
through the harness's own run: so that the reference itself is checked."""

import pytest

import run

SEED = 2**31 + 77
ENSEMBLE = {"config": {"bodies": 64}, "traffic": {"members": 2, "steps_per_request": 4}}
EDIT = {"config": {"flight_days": 1.0}}
SWEEP = {"config": {"flight_days": 0.5}, "traffic": {"ships_per_request": 4, "factor_grid": 4}}


def test_ensemble_reference_agrees_with_the_port():
    result, checks = run.run_cell("cluster4096.ensemble16_f64", SEED, 0.2, False,
                                  device="cpu", overrides=ENSEMBLE)
    assert result["correct"], result["checks"]
    values = {c.name: c.value for c in checks}
    assert max(values.values()) < 1e-12
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert result["metrics"]["body_steps_per_s"]["value"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,over", [("full_solar_system.mars_edit", EDIT),
                                       ("full_solar_system.mars_sweep256", SWEEP)])
def test_ship_reference_agrees_with_the_port(cell, over):
    result, checks = run.run_cell(cell, SEED, 0.1, False, device="cpu", overrides=over)
    assert result["correct"], result["checks"]
    values = {c.name: c.value for c in checks}
    # the port's CPU route sums the multistep rings in the reference's order
    # and its force in another: a day's fit leaves centimetres at most
    assert values["eph_gap_km"] < 0.1
    assert values["step_gap"] < 0.01
    assert values["knot_gap"] == 0.0          # the same steps as the reference's flight
    assert values["unreached"] == 0.0
