"""Each cell's control (the reference in the precision below the
configuration's, in the program's place) comes out as not correct, at a
size a test run holds; on a card, a short run of each cell is correct."""

import pytest

from bench_port.control import control_numbers
from bench_port.run import run_cell

SMALL = {"data": {"graphs": 120, "held_out": 2}}
CV_SMALL = {"n_iter": 2, "n_splits": 4}


def _mix(cell):
    return CV_SMALL if cell.endswith(".cv") else None


@pytest.mark.parametrize("cell", ["wl_nci1.fit", "sp_nci1.fit",
                                  "wl_nci1.cv"])
def test_control_fails_on_the_cpu(cell):
    for seed in (1, 2 ** 32 + 7, 3):
        nums = control_numbers(cell, seed, "cpu", config_override=SMALL,
                               mix_override=_mix(cell))
        assert any(v > lim for v, lim in nums.values()), (seed, nums)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wl_nci1.fit", "sp_nci1.fit",
                                  "wl_nci1.cv"])
def test_cell_runs_correct_and_control_fails_on_the_card(cuda, cell):
    res, _ = run_cell(cell, 2 ** 31 + 3, 1.0, 1, device="cuda",
                      config_override=SMALL, mix_override=_mix(cell))
    assert res["correct"] and res["device"]["busy_s"] > 0
    nums = control_numbers(cell, 5, "cuda", config_override=SMALL,
                           mix_override=_mix(cell))
    assert any(v > lim for v, lim in nums.values())
