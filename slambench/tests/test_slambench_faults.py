"""`correct` comes out false where it should: for the control (the
reference computed in TF32 in the program's place) and for each fault
the cells can have (slambench/faults.py), planted under the timed path
of a small CPU run and, on the card, of a run at the cell's size."""

import pytest

from slambench import faults, harness
from slambench.tests.small import SEED, run_small, small_cell

# the splat cell and the hybrid's every-frame cell, on their own limits
CELLS = ["kinect1cm_splat.orbit", "room2cm_hybrid.orbit"]
BENCH_CELLS = ["kinect1cm_splat.orbit"]


def _failing(out, numbers):
    return [k for k, v in numbers.items() if v > out["checks"][k]["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    out = run_small(name, control=True)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert _failing(out, out["control"]), out["control"]


@pytest.mark.parametrize("fault", sorted(faults.STEP_FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault):
    """Each fault of the step fails a run with no tracking loss (the
    recovery's fault is slambench/tests/test_slambench_lost_track.py's)."""
    with faults.planted(fault):
        out = run_small(name)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_control_fails_at_cell_size(cuda_device, name):
    """On the card, at the cell's own size, three seeds, a short window:
    the program passes and the control fails."""
    cell = harness.load_cell(name)
    for seed in (SEED, SEED + 7, SEED + 11):
        out = harness.run_cell(cell, seed, 5.0, False, device=cuda_device,
                               control=True, log=lambda m: None)
        assert out["correct"], out["checks"]
        assert _failing(out, out["control"]), out["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half_frame", "moved_pose"])
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_fault_fails_at_cell_size(cuda_device, name, fault):
    """On the card, at the cell's own size, three seeds, a short window:
    half of each frame left out, or each pose moved 1 mm, fails."""
    cell = harness.load_cell(name)
    for seed in (SEED + 3, SEED + 5, SEED + 13):
        with faults.planted(fault):
            out = harness.run_cell(cell, seed, 5.0, False,
                                   device=cuda_device, log=lambda m: None)
        assert out["correct"] is False, out["checks"]


def test_small_cell_is_small():
    assert small_cell().slam["width"] == 160
