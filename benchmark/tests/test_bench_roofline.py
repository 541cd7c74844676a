"""The roofline counts at small shapes, against hand counts."""

import pytest

from harness import readers, roofline
from reference import flight, nbody


def test_pair_force_count():
    ops, nbytes = roofline.accel_ensemble(2, 3)
    assert ops == 2 * 3 * 2 * 19                       # 6 pairs a member
    assert nbytes == (2 * 2 * 3 * 3 + 3) * 8           # positions in and out, mu


def test_update_count_skips_zero_coefficients():
    ops, nbytes = roofline.elm2_update([1.0, 0.0, 2.0], [0.0, 3.0, 0.0], 10)
    # two products and an add, one product, then a product and an add
    assert ops == 10 * (3 + 1 + 2)
    assert nbytes == 10 * (2 + 1 + 1) * 8


def test_qt12_update_count():
    ops, nbytes = roofline.elm2_update(nbody.C_Y, nbody.C_DY, 1)
    assert (sum(c != 0 for c in nbody.C_Y), sum(c != 0 for c in nbody.C_DY)) == (7, 11)
    assert ops == 13 + 21 + 2 and nbytes == 19 * 8


def test_ship_step_count():
    # one stage, no coefficients, one body of degree 2: segment 6, Horner 12,
    # pair 19; the error norm 12
    assert roofline.ship_step_ops(1, 0, 0, 0, [2]) == 6 + 12 + 19 + 12
    assert flight.STAGES == 13


def test_share_is_bound_over_time():
    ops = roofline.PEAK_F64 * 1e-3                    # 1 ms of work at peak
    assert roofline.share_pct(ops, 0.0, 2e-3) == pytest.approx(50.0)
    big = roofline.PEAK_BYTES * 4e-3                  # 4 ms of bytes: bound by memory
    assert roofline.share_pct(ops, big, 8e-3) == pytest.approx(50.0)
    assert roofline.share_pct(0.0, 0.0, 1.0) is None
    assert roofline.share_pct(ops, 0.0, 0.0) is None


def test_kernel_share_reads_the_trace():
    ctx = {"sizes": {"members": 1, "bodies": 2, "c_y": [1.0], "c_dy": [1.0]},
           "trace": {"kernels": {"accel_f64(double const*)": [1e-9, 4]}}}
    ops, nbytes = 4 * 2 * 19, 4 * (2 * 2 * 3 + 2) * 8   # four launches
    assert readers.accel_ensemble_roofline(ctx) == pytest.approx(
        100.0 * roofline.bound_s(ops, nbytes) / 1e-9)
    assert readers.elm2_update_roofline(ctx) is None   # its kernel did not run
    assert readers.accel_ensemble_roofline({**ctx, "trace": None}) is None
