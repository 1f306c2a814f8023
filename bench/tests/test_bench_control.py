"""The control and the planted faults fail each cell's limits at the cell's
own size, on the card (``-m cuda``; skipped without one), while the sound
run beside them passes: the float8 reference in the program's place, half
of each training batch left out, the smallest leaves never updated, a
served token altered.  One seed a cell, a short window; ``bench/
controls.py`` reads more."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from yardstick import cell as cell_lib
from yardstick import compare

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 99


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_cells_limits(name, cuda_device):
    import controls

    cell = cell_lib.load(name, ROOT / "BENCHMARK.json")
    readings = controls.readings(cell, SEED, cuda_device, seconds=3.0)
    assert readings.pop("correct"), readings["sound"]
    readings.pop("sound")
    readings.pop("leaves", None)
    for what, numbers in readings.items():
        ok, checks = compare.judge(numbers, cell.limits)
        assert not ok, (what, checks)
