"""tests/test_torch_fleet_lockstep.py's second run: one robot and a crossing
pedestrian, the port's fleet in lockstep with the JAX fleet at the shipped
budget in float32 (`lockstep`), the stagger set to 0.
"""
import numpy as np
import torch

from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch.sim import scenarios as ts
from test_torch_fleet import crossing_human, stack
from test_torch_fleet_lockstep import jax_batch, lockstep

torch.set_num_threads(1)


def test_crossing_human_lockstep_matches_jax():
    rt = lockstep("one robot, crossing pedestrian",
                  jax_batch([crossing_human(js)]),
                  stack([crossing_human(ts)]), 1, 4, human_stagger=0.0)
    assert np.isfinite(rt["min_clearance"]).all()
    assert np.isinf(rt["min_inter_robot"]).all()
