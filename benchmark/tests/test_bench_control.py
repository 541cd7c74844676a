"""The comparison that decides ``correct`` fails its control and the faults
a cell can have, at a size a test run holds.

The control is the plain reference in f32 (the precision below the
configurations' f64) in the program's place.  The faults break the port's
timed path underneath the harness, which then drives the rest of a run on
the CPU: a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced; and for the ships a step
controller that accepts steps above the tolerance (its error norm read a
tenth of what it is).  No cell spans chips, so the exchange between chips
has no fault to plant.
"""

import pytest

import run
from ephemeris_explorer_tpu_torch import spacecraft
from ephemeris_explorer_tpu_torch.parallel import sharding

SEED = 2**31 + 901
ENSEMBLE = {"config": {"bodies": 64}, "traffic": {"members": 4, "steps_per_request": 4}}
EDIT = {"config": {"flight_days": 1.0}}
SWEEP = {"config": {"flight_days": 0.5}, "traffic": {"ships_per_request": 4, "factor_grid": 4}}
CELLS = [("cluster4096.ensemble16_f64", ENSEMBLE), ("full_solar_system.mars_edit", EDIT),
         ("full_solar_system.mars_sweep256", SWEEP)]


@pytest.mark.parametrize("cell,over", CELLS)
def test_control_fails(cell, over):
    result, checks = run.run_cell(cell, SEED, 0.1, False, device="cpu", overrides=over,
                                  control=True)
    assert result["correct"]
    limits = {c.name: c.limit for c in checks}
    failed = [k for k, v in result["control"].items() if not v <= limits[k]]
    assert failed, result["control"]


def _ensemble_fault(monkeypatch, fault):
    make = sharding.make_fused_ensemble_scan

    def broken(*a, **kw):
        scan = make(*a, **kw)

        def run_(carry):
            new = scan(carry)
            if fault == "unchanged":
                return carry
            ys = new.ys.clone()
            if fault == "half":
                ys[:, ys.shape[1] // 2:] = carry.ys[:, ys.shape[1] // 2:]
            else:                                        # "altered"
                ys[0, 0] += 1.0
            return new._replace(ys=ys)

        return run_

    monkeypatch.setattr(sharding, "make_fused_ensemble_scan", broken)


def _ship_fault(monkeypatch, fault):
    plain = spacecraft.propagate_batch_plain

    def broken(*a, **kw):
        r = plain(*a, **kw)
        if fault == "unchanged":
            r.pos[:] = r.pos[:, :1].clone()
        elif fault == "half":
            r.count[r.count.shape[0] // 2:] = 1
        else:                                            # "altered"
            r.pos[:, 3] += 1.0
        return r

    monkeypatch.setattr(spacecraft, "propagate_batch_plain", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell,over", CELLS)
def test_fault_makes_the_run_incorrect(monkeypatch, cell, over, fault):
    if fault == "half" and cell.endswith("mars_edit"):
        pytest.skip("a one-ship request has no half of a batch")
    if "ensemble" in cell:
        _ensemble_fault(monkeypatch, fault)
    else:
        _ship_fault(monkeypatch, fault)
    result, _ = run.run_cell(cell, SEED, 0.1, False, device="cpu", overrides=over)
    assert not result["correct"], result["checks"]



@pytest.mark.parametrize("cell,over", CELLS[1:])
def test_loose_step_controller_makes_the_run_incorrect(monkeypatch, cell, over):
    norm = spacecraft._err_norm
    monkeypatch.setattr(spacecraft, "_err_norm", lambda *a: 0.1 * norm(*a))
    result, checks = run.run_cell(cell, SEED, 0.1, False, device="cpu", overrides=over)
    assert not result["correct"], result["checks"]
    failed = [c.name for c in checks if not c.ok]
    assert "knot_gap" in failed, result["checks"]
