"""The port's MPC tracker (`trackers/mpc_tracker.py`) and its interface
(`interfaces/mpc_interface.py`) against the JAX package's, on the CPU.

Both sides build the tracker of scenario 1's robot on the real warehouse map
at a small budget (3 warm iterations, 9 at the cold profile), the JAX side
with `linear_solver="cholesky"`: off the TPU its default solves with LU,
while the port follows the TPU kernel's clamped Cholesky
(tests/test_torch_engine.py).  The host-side helpers and the flat parameter
vector must be equal; the solve agrees within 1e-4 in the first action.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.interfaces import mpc_interface as jmi
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.interfaces import mpc_interface as tmi
from dyobav_tpu_torch.ops import engine
from dyobav_tpu_torch.sim import harness as th

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")

SMALL = jcfg.SolverConfiguration(
    max_inner_iters=3, max_outer_iters=1, inner_iters_later=1,
    newton_substeps=1, cold_profile=(6, 2, 3, 1, 10.0),
    linear_solver="cholesky")


def _recording(bundle, log):
    """`bundle` whose solve_batch logs its (Z, U0) as numpy."""
    def solve_batch(Z, U0):
        log.append((np.asarray(Z), np.asarray(U0)))
        return bundle.solve_batch(Z, U0)

    return bundle._replace(solve_batch=solve_batch)


@functools.lru_cache(maxsize=None)
def world():
    """(JAX MainBase, port MainBase, JAX interface, port interface), both
    prepared on scenario 1's robot and route, each bundle logging its
    solves (a list per side)."""
    jbase = jh.MainBase(scenario_index=1, seed=1)
    tbase = th.MainBase(scenario_index=1, seed=1, device="cpu")
    out = [jbase, tbase]
    for base, mi, scfg, kw in (
            (jbase, jmi, SMALL, {}),
            (tbase, tmi, config_from_dict(tcfg.SolverConfiguration,
                                          dataclasses.asdict(SMALL)),
             {"device": "cpu"})):
        robot, _ = base._prepare_agents()
        intf = mi.MpcInterface(base.config_mpc, robot.state, base.geo_map,
                               robot_config=base.config_robot,
                               solver_config=scfg, **kw)
        intf.update_global_path(robot.path)
        tr = intf.traj_tracker
        tr.solve_log = []
        tr.bundle = _recording(tr.bundle, tr.solve_log)
        tr.cold_bundle = _recording(tr.cold_bundle, tr.solve_log)
        out.append(intf)
    return tuple(out)


def test_tracker_helpers_equal_jax():
    _, _, jintf, tintf = world()
    jt, tt = jintf.traj_tracker, tintf.traj_tracker
    assert tt.ref_traj == jt.ref_traj and len(tt.ref_traj) > 50
    rng = np.random.default_rng(0)
    for idx in (0, 3, 17, len(tt.ref_traj) - 8, len(tt.ref_traj) - 1):
        for _ in range(3):
            state = np.array(tt.ref_traj[idx]) + rng.normal(0, 0.3, 3)
            for steps, horizon in ((1, 20), (2, 20), (1, 7)):
                r_t, i_t = tt.get_ref_states(idx, tt.ref_traj, state, steps,
                                             horizon)
                r_j, i_j = jt.get_ref_states(idx, jt.ref_traj, state, steps,
                                             horizon)
                assert i_t == i_j and r_t.shape == (horizon, 3)
                np.testing.assert_array_equal(r_t, r_j)
    for mode in ("safe", "work", "super", "aligning"):
        tt.set_work_mode(mode)
        jt.set_work_mode(mode)
        assert (tt.base_speed, tt.tuning_params) == (jt.base_speed,
                                                     jt.tuning_params)
    with pytest.raises(ValueError, match="no mode"):
        tt.set_work_mode("sprint")
    tt.set_work_mode("work")
    jt.set_work_mode("work")
    last_u = np.array([0.6, -0.1])
    np.testing.assert_array_equal(tt._initial_guesses(last_u),
                                  jt._initial_guesses(last_u))
    saved = tt._last_u, jt._last_u
    try:
        tt._last_u = jt._last_u = rng.normal(size=40).astype(np.float32)
        g = tt._initial_guesses(last_u)
        assert g.shape == (5, 40) and g.dtype == np.float32
        np.testing.assert_array_equal(g, jt._initial_guesses(last_u))
    finally:
        tt._last_u, jt._last_u = saved
    goal = np.array(tt.ref_path[-1])
    for state, action in (([1.0, 12.0, 0.0], [0.3, 0.0]),
                          ([1.0, 12.0, 0.0], [0.5, 0.0]),
                          ([1.0, 10.0, 0.0], [0.1, 0.0])):
        assert (tt.check_termination_condition(np.array(state), action, goal)
                == jt.check_termination_condition(np.array(state), action,
                                                  goal))
    tt.idle = jt.idle = False


def test_constraints_equal_jax():
    """The static half-spaces of the closest obstacles and the flattened
    ellipses, at robot states across the map."""
    _, _, jintf, tintf = world()
    rng = np.random.default_rng(1)
    states = np.concatenate([rng.uniform([-15, -15], [18, 14], (12, 2)),
                             np.zeros((12, 1))], axis=1)
    saved = tintf.state, jintf.state
    try:
        for s in states:
            tintf.state, jintf.state = s, s
            c_t, obs_t = tintf.get_stc_constraints()
            c_j, obs_j = jintf.get_stc_constraints()
            assert obs_t == obs_j and len(obs_t) == tintf.config_mpc.Nstcobs
            assert len(c_t) == len(c_j) and c_t == c_j
    finally:
        tintf.state, jintf.state = saved
    N = tintf.config_mpc.N_hor
    dyn = [[[float(i), 0.5 * t, 0.3, 0.4, 0, 1] for t in range(N + 1)]
           for i in range(3)]
    assert tintf.get_dyn_constraints(dyn) == jintf.get_dyn_constraints(dyn)
    assert tintf.get_dyn_constraints(None) == jintf.get_dyn_constraints(None)


def test_run_step_matches_jax():
    """One step from the cold start with a pedestrian ellipse ahead: the
    flat parameter vector of every candidate bit-equal, the first action
    within 1e-4, equal convergence and escalations, one host copy per
    solve."""
    _, _, jintf, tintf = world()
    N = tintf.config_mpc.N_hor
    dyn = [[[1.3, -0.4 + 0.05 * t, 0.4, 0.4, 0, 1] for t in range(N + 1)]]
    syncs = engine.to_host.syncs
    out_t = tintf.run_step("work", dyn)
    syncs = engine.to_host.syncs - syncs
    out_j = jintf.run_step("work", dyn)
    jt, tt = jintf.traj_tracker, tintf.traj_tracker
    assert len(tt.solve_log) == len(jt.solve_log) >= 1
    for (z_t, u_t), (z_j, u_j) in zip(tt.solve_log, jt.solve_log):
        assert z_t.shape == (5, tintf.config_mpc.n_params)
        np.testing.assert_array_equal(z_t, z_j)
        np.testing.assert_array_equal(u_t, u_j)
    actions_t, pred_t, cost_t, obs_t, refs_t = out_t
    actions_j, pred_j, cost_j, obs_j, refs_j = out_j
    np.testing.assert_allclose(actions_t[0], actions_j[0], rtol=0, atol=1e-4)
    assert len(pred_t) == N and pred_t[0].shape == (3,)
    np.testing.assert_allclose(np.array(pred_t), np.array(pred_j), rtol=0,
                               atol=1e-3)
    assert obs_t == obs_j
    np.testing.assert_array_equal(refs_t, refs_j)
    assert cost_t == pytest.approx(cost_j, rel=1e-4)
    assert ([s == "Converged" for s in tt.solver_status_timelist]
            == [s == "Converged" for s in jt.solver_status_timelist])
    assert tt.escalation_count == jt.escalation_count
    assert syncs == len(tt.solve_log)
    np.testing.assert_allclose(tt.state, jt.state, rtol=0, atol=1e-4)


def test_single_start_step():
    """`use_multistart=False` solves the first candidate alone (the warm
    guess, or at the cold start the constant base-speed profile) in one
    host copy, with the multistart's parameter vector."""
    _, tbase, _, tintf = world()
    robot, _ = tbase._prepare_agents()
    intf = tmi.MpcInterface(tbase.config_mpc, robot.state, tbase.geo_map,
                            robot_config=tbase.config_robot,
                            solver_config=tintf.traj_tracker.solver_config,
                            use_multistart=False, device="cpu")
    intf.update_global_path(robot.path)
    tr = intf.traj_tracker
    tr.solve_log = []
    tr.bundle = _recording(tr.bundle, tr.solve_log)
    tr.cold_bundle = _recording(tr.cold_bundle, tr.solve_log)
    syncs = engine.to_host.syncs
    actions, pred, cost, _, _ = intf.run_step("work", None)
    assert engine.to_host.syncs - syncs == len(tr.solve_log) >= 1
    z, u0 = tr.solve_log[0]
    assert z.shape == (1, tbase.config_mpc.n_params)
    np.testing.assert_array_equal(
        u0[0], np.tile([tr.base_speed, 0.0], 20).astype(np.float32))
    assert np.isfinite(actions[0]).all() and np.isfinite(cost)
    assert len(pred) == tbase.config_mpc.N_hor and tr.escalation_count == 0
