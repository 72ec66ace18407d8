"""The port's per-episode harness where it needs no JAX: its device default,
and the card against the port's own CPU run.

This file imports no JAX, so that its `cuda`-marked test runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_harness_card.py -m cuda -q
"""
import os

import numpy as np
import pytest
import torch

from dyobav_tpu_torch.configs import SolverConfiguration
from dyobav_tpu_torch.sim.harness import MainBase

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "data", "warehouse_sim_original",
                                    "mymap.pgm")),
    reason="warehouse data not imported")

# A small budget: 3 warm iterations, 9 at the cold profile.
SMALL = SolverConfiguration(max_inner_iters=3, max_outer_iters=1,
                            inner_iters_later=1, newton_substeps=1,
                            cold_profile=(6, 2, 3, 1, 10.0))


def test_harness_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    base = MainBase(max_run_time_step=1, scenario_index=1, seed=1)
    robot, _ = base._prepare_agents()
    with pytest.raises(RuntimeError, match="CUDA"):
        base._prepare_interfaces(robot, "cvmp", "mpc")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _steps(device, n):
    base = MainBase(max_run_time_step=n, evaluation=True, seed=1,
                    scenario_index=1, solver_config=SMALL, device=device)
    robot, humans = base._prepare_agents()
    intf, pred = base._prepare_interfaces(robot, "cvmp", "mpc")
    for _ in range(n):
        base.run_one_step(robot, humans, intf, pred)
    tracker = intf.traj_tracker
    return (np.array(tracker.past_actions),
            [s == "Converged" for s in tracker.solver_status_timelist],
            tracker.escalation_count)


@pytest.mark.cuda
def test_tracker_card_matches_cpu(cuda_device):
    """Two harness steps (the cold first solve, then a warm one) of scenario
    1: the card's actions within 1e-3 of the port's CPU run's, the same
    convergence flags and escalations."""
    card, cpu = _steps(cuda_device, 2), _steps("cpu", 2)
    assert card[0].shape == (2, 2)
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=1e-3)
    assert card[1:] == cpu[1:]
