"""A run with its timed path broken underneath comes out not correct: the
cell's own limits judge each planted fault (`navbench/faults.py`), at a
size the CPU holds, with the look for a card skipped."""
from __future__ import annotations

import pytest

from navbench_cells import spec as cell_spec
from navbench import faults, harness


def correct(spec, cell):
    cell.release()
    return harness.compare(cell.judge(), spec["limits"]["limits"])[0]


@pytest.mark.parametrize("fault", [None, *faults.FAULTS])
def test_solve(fault, cpu):
    spec = cell_spec("nmpc.solve.b2048")
    drv = harness.load_module("drivers", "nmpc_solve")
    cell = drv.Cell(spec["config"], dict(spec["traffic"], batch=4), 21, cpu)
    if fault:
        faults.plant(cell, fault)
    cell.window(0.0)
    assert correct(spec, cell) is (fault is None)


@pytest.mark.parametrize("fault", [None, *faults.FAULTS])
def test_predict(fault, cpu):
    spec = harness.cell("swta.predict.s64")
    drv = harness.load_module("drivers", "swta_predict")
    traffic = dict(spec["traffic"], lanes=2, checked_calls=2)
    cell = drv.Cell(spec["config"], traffic, 22, cpu)
    if fault:
        faults.plant(cell, fault)
    cell._call(keep=True)
    cell._call(keep=True)
    assert correct(spec, cell) is (fault is None)


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_train(fault, cpu):
    spec = cell_spec("swta.train.b20")
    drv = harness.load_module("drivers", "swta_train")
    traffic = dict(spec["traffic"], videos=1, pedestrians=2, frames=12,
                   batch=4)
    with faults.training(fault):
        cell = drv.Cell(spec["config"], traffic, 23, cpu)
    assert correct(spec, cell) is False
