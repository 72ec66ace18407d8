"""The port's closed-loop batched simulation (`dyobav_tpu_torch.sim.batch`,
`.sim.sweep`) against the JAX package's, on the CPU.

Both sims get the same scenarios (`random_scenarios(base, 4, seed=3)`, which
the two packages build identically), the same pedestrian `stagger_stream`
(made with numpy from a seed: the packages' own random streams differ) and
the same small solver budget.  The JAX side is built with
`linear_solver="cholesky"`: off the TPU its default solves with LU, while
the port follows the TPU kernel's clamped Cholesky, and those two agree
only under the Cholesky setting (tests/test_torch_engine.py).

Each JAX sim is one long CPU compile, so there are two of them: multistart
on (here) and off (tests/test_torch_batch_sim_ladder.py, a file of its own
so that the two can run side by side).  One multistart decision on its own
is in tests/test_torch_multistart.py, the sweep script in
tests/test_torch_sweep.py.
"""
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.sim import batch as jb
from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.sim import batch as tb
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts

# One intra-op thread: the solver's operators are tiny at these sizes, and
# the suite's parallel workers would otherwise oversubscribe the cores.
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")

# tests/test_batch_sim.py's FAST budget, under Cholesky semantics.
FAST = jcfg.SolverConfiguration(
    max_inner_iters=8, max_outer_iters=2, inner_iters_later=4,
    escalation_ladder=((4, 2, 2, 1, 10.0),), escalation_slots=(4,),
    linear_solver="cholesky")
# The closed loop runs a smaller cold budget than the default (12, 6, 5, 1):
# the cold pre-solve and every distressed re-solve pay it on both sides.
LOOP = dataclasses.replace(FAST, cold_profile=(6, 2, 3, 1, 10.0))
CFG, ROBOT = jcfg.MpcConfiguration(), jcfg.CircularRobotSpecification()
TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
B, STEPS = 4, 6


def _port_cfg(scfg):
    return config_from_dict(tcfg.SolverConfiguration,
                            dataclasses.asdict(scfg))


def _np(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@functools.lru_cache(maxsize=None)
def world():
    jbase = jh.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0)
    tbase = th.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0)
    rng = np.random.default_rng(11)
    stream = (rng.choice([-1.0, 1.0], (B, STEPS, 1))
              * rng.integers(0, 11, (B, STEPS, 1)) / 10.0 * 0.5
              ).astype(np.float32)
    return (js.random_scenarios(jbase, B, seed=3),
            ts.random_scenarios(tbase, B, seed=3), stream)


def check_closed_loop(multistart: bool):
    """Run both sims for STEPS steps and compare them; shared with
    tests/test_torch_batch_sim_ladder.py (multistart off), which is a file
    of its own so that the two long JAX compiles can run side by side."""
    sc_j, sc_t, stream = world()
    # JAX's sim in a second thread, so that its compile overlaps the port's
    # run.
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(lambda: jb.build_batch_sim(
            CFG, ROBOT, LOOP, n_steps=STEPS, multistart=multistart,
            record_traj=True, stagger_stream=stream)(sc_j, jnp.arange(B)))
        res_t, (traj_t, hum_t) = tb.build_batch_sim(
            TCFG, TROBOT, _port_cfg(LOOP), n_steps=STEPS,
            multistart=multistart, record_traj=True, stagger_stream=stream,
            device="cpu")(sc_t, np.arange(B))
        res_j, (traj_j, hum_j) = jax_run.result()
    traj_j, traj_t = np.asarray(traj_j), traj_t.numpy()
    assert traj_t.shape == traj_j.shape == (STEPS, B, 3)
    assert hum_t.shape == np.asarray(hum_j).shape == (STEPS, B, 1, 2)

    # Robot positions within 1e-3 m at every step.  One lane may be
    # excused: a knife-edge argmin between two candidates (or LM rungs)
    # that differ in the last bits can send the two sims down different
    # basins; say which lane, where and by how much.
    dev = np.abs(traj_t[:, :, :2] - traj_j[:, :, :2]).max(axis=2)  # (T, B)
    far = np.flatnonzero(dev.max(axis=0) > 1e-3)
    for lane in far:
        step = int(np.argmax(dev[:, lane] > 1e-3))
        print(f"multistart={multistart}: lane {lane} excused: leaves the "
              f"JAX trajectory at step {step} by {dev[step, lane]:.3e} m "
              f"(max {dev[:, lane].max():.3e} m)")
    print(f"multistart={multistart}: max robot deviation per lane "
          f"{dev.max(axis=0)}")
    assert len(far) <= 1, dev.max(axis=0)
    held = np.setdiff1d(np.arange(B), far)

    # Pedestrians follow the shared stagger stream: 1e-5 m.
    np.testing.assert_allclose(hum_t.numpy()[:, held],
                               np.asarray(hum_j)[:, held], rtol=0, atol=1e-5)
    rj, rt = _np(res_j), _np(res_t)
    for f in ("success", "collided", "collided_static", "steps_used",
              "escalation_overflow_steps"):
        np.testing.assert_array_equal(rt[f][held], rj[f][held], err_msg=f)
    for f in ("min_clearance", "final_state", "min_static_clearance",
              "deviation_mean", "deviation_max"):
        np.testing.assert_allclose(rt[f][held], rj[f][held], rtol=0,
                                   atol=2e-3, err_msg=f)
    assert rt["smoothness"].shape == (B, 2)
    assert np.isfinite(rt["smoothness"]).all()
    # The robots moved (the comparison is not of two parked sims).
    start = np.asarray(sc_t.robot_start)[:, :2]
    assert (np.linalg.norm(traj_t[-1, :, :2] - start, axis=1) > 0.5).all()


def test_closed_loop_multistart_matches_jax():
    check_closed_loop(True)


def test_sim_defaults_to_cuda_and_unported_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.build_batch_sim(TCFG, TROBOT)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.build_step_program(TCFG, TROBOT)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.make_wta_predictor(None, np.zeros((4, 5)), None, 20)
    with pytest.warns(UserWarning, match="no effect"):
        tb.build_batch_sim(TCFG, TROBOT, escalate=False, device="cpu")
