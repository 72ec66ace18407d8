"""The port's decentralized fleet (`dyobav_tpu_torch.sim.fleet`) in lockstep
with the JAX package's (`dyobav_tpu.sim.fleet.build_fleet_sim`), on the
CPU, at the shipped `SolverConfiguration()` (the JAX side with
`linear_solver="cholesky"`, which the port follows,
tests/test_torch_engine.py): a weak cold profile would make the candidate
pick's ties coin flips (ROADMAP.md, section C).

Three runs: the head-on corridor at lateral offsets 0.2 and 0.35 as one
batch (two robots, no pedestrian), one robot with a crossing pedestrian,
and two random map scenarios of three robots and one pedestrian (static
polygons, the map's routes).  The packages draw the pedestrian stagger
from different random streams, so the runs with a pedestrian set it to 0.
Each JAX run goes in a second thread while the port's runs, so that its
compile overlaps the port's CPU run.
"""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.sim import fleet as jf
from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.sim import fleet as tf
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts
from test_torch_fleet import crossing_human, head_on, stack

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")

SCFG = jcfg.SolverConfiguration(linear_solver="cholesky")
TSCFG = config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(SCFG))
CFG, ROBOT = jcfg.MpcConfiguration(), jcfg.CircularRobotSpecification()
TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()


def jax_batch(scenarios):
    return jf.FleetScenario(*[jnp.stack(x) for x in zip(*scenarios)])


def lockstep(label, sc_j, sc_t, n_robots, n_steps, human_stagger=0.5):
    """Run both fleets on the same scenarios and hold the port to JAX's."""
    B = int(sc_t.robot_starts.shape[0])
    kw = dict(n_robots=n_robots, n_steps=n_steps,
              human_stagger=human_stagger)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(lambda: jf.build_fleet_sim(CFG, ROBOT, SCFG, **kw)(
            sc_j, jnp.arange(B)))
        res_t = tf.build_fleet_sim(TCFG, TROBOT, TSCFG, device="cpu", **kw)(
            sc_t, np.arange(B))
        res_j = fut.result()
    rj = {f: np.asarray(getattr(res_j, f)) for f in jf.FleetResult._fields}
    rt = {f: getattr(res_t, f).numpy() for f in tf.FleetResult._fields}
    assert list(rt) == list(rj)
    for f in rj:
        assert rt[f].shape == rj[f].shape, f
    dev = np.abs(rt["final_states"][..., :2]
                 - rj["final_states"][..., :2]).max(axis=-1)     # (B, R)
    print(f"{label}: final position deviation per robot {dev.tolist()} m; "
          f"min_inter_robot port {rt['min_inter_robot'].tolist()} JAX "
          f"{rj['min_inter_robot'].tolist()}; fails "
          f"{rt['solver_fail_steps'].tolist()}; overflow "
          f"{rt['escalation_overflow_steps'].tolist()}")
    np.testing.assert_allclose(rt["final_states"], rj["final_states"],
                               rtol=0, atol=1e-3, err_msg="final_states")
    for f in ("success", "done", "collided", "steps_used", "solver_fail_steps",
              "escalation_overflow_steps"):
        np.testing.assert_array_equal(rt[f], rj[f], err_msg=f)
    for f in ("min_inter_robot", "min_clearance", "min_static_clearance",
              "deviation_mean", "deviation_max", "smoothness"):
        np.testing.assert_allclose(rt[f], rj[f], rtol=0, atol=1e-3,
                                   err_msg=f)
    return rt


def test_head_on_lockstep_matches_jax():
    rt = lockstep("head-on (0.2, 0.35)",
                  jax_batch([head_on(js, 0.2), head_on(js, 0.35)]),
                  stack([head_on(ts, 0.2), head_on(ts, 0.35)]), 2, 4)
    assert np.isinf(rt["min_clearance"]).all()          # no pedestrian
    # The robots drove towards each other.
    assert (rt["final_states"][:, 0, 0] > 0.2).all()
    assert (rt["final_states"][:, 1, 0] < 7.8).all()


def test_crossing_human_lockstep_matches_jax():
    rt = lockstep("one robot, crossing pedestrian",
                  jax_batch([crossing_human(js)]),
                  stack([crossing_human(ts)]), 1, 4, human_stagger=0.0)
    assert np.isfinite(rt["min_clearance"]).all()
    assert np.isinf(rt["min_inter_robot"]).all()


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
