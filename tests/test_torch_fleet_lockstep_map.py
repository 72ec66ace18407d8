"""tests/test_torch_fleet_lockstep.py's third run: two random map scenarios of
three robots and one pedestrian (static polygons, the map's routes), the
port's fleet in lockstep with the JAX fleet at the shipped budget in
float32 (`lockstep`), the stagger set to 0.
"""
import os

import numpy as np
import pytest
import torch

from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts
from test_torch_fleet_lockstep import DATA, lockstep

torch.set_num_threads(1)


@pytest.mark.skipif(not os.path.exists(os.path.join(DATA, "mymap.pgm")),
                    reason="warehouse data not imported")
def test_map_fleet_lockstep_matches_jax():
    jbase = jh.MainBase(evaluation=True, seed=0)
    tbase = th.MainBase(evaluation=True, seed=0)
    rt = lockstep(
        "map, 3 robots, 1 pedestrian",
        js.random_fleet_scenarios(jbase, 2, n_robots=3, n_humans=1, seed=0),
        ts.random_fleet_scenarios(tbase, 2, n_robots=3, n_humans=1, seed=0),
        3, 3, human_stagger=0.0)
    assert np.isfinite(rt["min_static_clearance"]).all()
    assert np.isfinite(rt["min_inter_robot"]).all()
