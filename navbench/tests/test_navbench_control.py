"""The control, the reference computed a precision below the one the
configuration states and put in the program's place, comes out not
correct under each cell's limits.  The solve's control (bfloat16) runs on
the CPU; the SWTA cells' (TF32) only on a card."""
from __future__ import annotations

import pytest

from navbench_cells import spec as cell_spec
from navbench import harness


def control_correct(workload, traffic, seed, device, calls=0):
    spec = cell_spec(workload)
    drv = harness.load_module("drivers", spec["traffic"]["driver"])
    cell = drv.Cell(spec["config"], dict(spec["traffic"], **traffic), seed,
                    device)
    for _ in range(calls):
        cell._call(keep=True)
    if workload.startswith("nmpc"):
        cell.window(0.0)
    cell.release()
    return harness.compare(cell.judge(control=True),
                           spec["limits"]["limits"])[0]


def test_solve_control(cpu):
    assert not control_correct("nmpc.solve.b2048", {"batch": 4}, 31, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 42, 43])
def test_predict_control(seed, cuda_device):
    assert not control_correct("swta.predict.s64",
                               {"lanes": 8, "checked_calls": 1}, seed,
                               cuda_device, calls=1)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [51, 52, 53])
def test_train_control(seed, cuda_device):
    assert not control_correct("swta.train.b20", {}, seed, cuda_device)
