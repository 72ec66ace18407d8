"""The port's decentralized fleet (`dyobav_tpu_torch.sim.fleet`) in lockstep
with the JAX package's (`dyobav_tpu.sim.fleet.build_fleet_sim`), on the
CPU, at the shipped `SolverConfiguration()` (the JAX side with
`linear_solver="cholesky"`, which the port follows,
tests/test_torch_engine.py): a weak cold profile would make the candidate
pick's ties coin flips (ROADMAP.md, section C).

Three runs: the head-on corridor at lateral offsets 0.2 and 0.35 as one
batch (two robots, no pedestrian) here, one robot with a crossing
pedestrian (tests/test_torch_fleet_lockstep_human.py) and two random map
scenarios of three robots and one pedestrian (static polygons, the map's
routes; tests/test_torch_fleet_lockstep_map.py), files of their own so
that the suite's workers run them side by side.  The packages draw the
pedestrian stagger from different random streams, so the runs with a
pedestrian set it to 0.  Each JAX run goes in a second thread while the
port's runs, so that its compile overlaps the port's CPU run.

`jax_prefixes` and `window` serve the windows of tests/test_torch_fleet.py
and tests/test_torch_fleet_agents.py, which hold tests/test_fleet.py's bars
where they are decided: from the poses of tests/test_fleet.py's own JAX
run a few steps before the robots pass (or a pedestrian crosses) and
before the goals, robots at rest on straight references to the same
goals, both packages in lockstep for WINDOW steps in float64 (JAX under
`jax.enable_x64`), within WINDOW_TOL.  Float64, because at the pass the
solves that stop short of the tolerance carry float32 rounding into the
iterates, and two float32 runs part by 1-2 cm within 6 steps.
"""
import contextlib
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.sim import batch as jbatch
from dyobav_tpu.sim import fleet as jf
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.sim import fleet as tf
from dyobav_tpu_torch.sim import scenarios as ts
from test_fleet import FAST as JAX_FAST
from test_torch_fleet import BASE_SPEED, crossing_human, head_on, stack

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")

SCFG = jcfg.SolverConfiguration(linear_solver="cholesky")
TSCFG = config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(SCFG))
CFG, ROBOT = jcfg.MpcConfiguration(), jcfg.CircularRobotSpecification()
TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
# The windows: WINDOW steps in float64, robots and distances within
# WINDOW_TOL m (they agree to 3e-8).
WINDOW, WINDOW_TOL = 6, 1e-6


def jax_batch(scenarios):
    return jf.FleetScenario(*[jnp.stack(x) for x in zip(*scenarios)])


@contextlib.contextmanager
def x64():
    """JAX in float64 (`jax.enable_x64`, local to the calling thread).  There
    `ref_window_select` would slice the reference at an int32 start beside
    a literal 0, which becomes int64, and `lax.dynamic_slice` refuses the
    pair (the step program's cold start, the fleet's steps): while the
    block runs, it is handed the index as JAX's default integer (int64
    here) and gives the next index back in the caller's dtype, so that a
    scan's carry keeps its type.  The values are the same."""
    select = jbatch.ref_window_select

    def at_default_int(ref_traj, ref_len, ref_idx, *args):
        window, idx = select(ref_traj, ref_len, jnp.asarray(ref_idx, int),
                             *args)
        return window, idx.astype(jnp.asarray(ref_idx).dtype)

    jbatch.ref_window_select = jf.ref_window_select = at_default_int
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jbatch.ref_window_select = jf.ref_window_select = select


@functools.lru_cache(maxsize=None)
def jax_fleet(n_robots, n_steps, human_stagger, float64=False):
    """JAX's fleet at the shipped budget, built once per worker process, so
    that runs of one shape share its compile; float64: call it under
    `x64()`."""
    with x64() if float64 else contextlib.nullcontext():
        return jf.build_fleet_sim(
            CFG, ROBOT, SCFG, n_robots=n_robots, n_steps=n_steps,
            human_stagger=human_stagger,
            dtype=jnp.float64 if float64 else jnp.float32)


def jax_prefixes(sc_j, n_robots, steps, copies=1, human_stagger=0.5):
    """tests/test_fleet.py's JAX run, `copies` lanes of `sc_j` at its FAST
    budget (float32 and LU, as that test solves), for each n_steps in
    `steps`: lane 0's FleetResult as numpy, one dict per entry.  Each run
    compiles in a thread of its own."""
    def prefix(n):
        run = jf.build_fleet_sim(CFG, ROBOT, JAX_FAST, n_robots=n_robots,
                                 n_steps=n, human_stagger=human_stagger)
        res = run(jax_batch([sc_j] * copies), jnp.arange(copies))
        return {f: np.asarray(getattr(res, f))[0]
                for f in jf.FleetResult._fields}

    with ThreadPoolExecutor(len(steps)) as pool:
        return list(pool.map(prefix, steps))


def window(label, lanes, human_stagger=0.5):
    """Both fleets, one lane per (starts, goals, human_starts, human_goals)
    of `lanes` (starts: JAX's poses after a prefix; robots at rest on
    straight references, `synthetic_fleet_scenario`), WINDOW steps in
    lockstep in float64.  Returns the port's results (`lockstep`)."""
    sc_j, sc_t = [], []
    for starts, goals, humans, human_goals in lanes:
        kw = dict(base_speed=BASE_SPEED, ts=TCFG.ts, human_starts=humans,
                  human_goals=human_goals)
        sc_j.append(js.synthetic_fleet_scenario(starts, goals, **kw))
        sc_t.append(ts.synthetic_fleet_scenario(starts, goals, **kw))
    return lockstep(label, jax_batch(sc_j), stack(sc_t), len(lanes[0][0]),
                    WINDOW, human_stagger, float64=True, atol=WINDOW_TOL)


def pedestrian_after(n_steps):
    """JAX's pedestrian of `crossing_human` after n_steps without stagger
    (`dyobav_tpu.sim.batch.human_waypoint_step`, as its fleet steps it)."""
    sc = crossing_human(js)
    humans, wp = jnp.asarray(sc.human_starts), jnp.zeros((1,), jnp.int32)
    key = jax.random.PRNGKey(0)
    for _ in range(n_steps):
        humans, wp, key = jbatch.human_waypoint_step(
            humans, wp, jnp.asarray(sc.human_paths),
            jnp.asarray(sc.human_path_len), key, 1.5, 0.0, CFG.ts)
    return np.asarray(humans)


def lockstep(label, sc_j, sc_t, n_robots, n_steps, human_stagger=0.5,
             float64=False, atol=1e-3):
    """Run both fleets on the same scenarios and hold the port to JAX's:
    robots and distances within `atol` m, flags and counts equal."""
    B = int(sc_t.robot_starts.shape[0])
    kw = dict(n_robots=n_robots, n_steps=n_steps,
              human_stagger=human_stagger)

    def run_jax():
        with x64() if float64 else contextlib.nullcontext():
            res = jax_fleet(**kw, float64=float64)(sc_j, jnp.arange(B))
            return {f: np.asarray(getattr(res, f))
                    for f in jf.FleetResult._fields}

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_jax)
        res_t = tf.build_fleet_sim(
            TCFG, TROBOT, TSCFG, device="cpu",
            dtype=torch.float64 if float64 else torch.float32, **kw)(
            sc_t, np.arange(B))
        rj = fut.result()
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
                               rtol=0, atol=atol, err_msg="final_states")
    for f in ("success", "done", "collided", "steps_used", "solver_fail_steps",
              "escalation_overflow_steps"):
        np.testing.assert_array_equal(rt[f], rj[f], err_msg=f)
    for f in ("min_inter_robot", "min_clearance", "min_static_clearance",
              "deviation_mean", "deviation_max", "smoothness"):
        np.testing.assert_allclose(rt[f], rj[f], rtol=0, atol=atol,
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
