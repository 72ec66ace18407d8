"""The port's per-episode harness (`sim/harness.MainBase`) in lockstep with
the JAX package's, on the CPU: a 4-step evaluation episode of scenario 1,
seed 1, mpc + cvmp, through `MainBase.run`, and a 2-step one with the
Kalman predictor (mpc + kfmp), which shares this module's JAX compiles.

Both sides run the shipped `SolverConfiguration()`, the JAX side with
`linear_solver="cholesky"` (its LU off the TPU is not what the port
follows, tests/test_torch_engine.py).  The pedestrian's stagger comes from
`random.Random(seed)` on both sides, so pedestrians must agree to float64
rounding.  The robot is held within 1e-3 m at every step.

The tracker's decision rule picks the lowest score among its 5 candidates
and escalates when that is not the warm candidate; candidates that reach
one optimum tie to float32 rounding, so the pick between them is a coin
flip between any two implementations.  With the shipped cold profile the
escalated re-solve lands on the same optimum, and the episodes agree; with
a cold profile as small as (6, 2, 3, 1) it does not always, and the robots
part by a few mm after such a tie (ROADMAP.md, section C).

The JAX side runs in a second thread while the port's runs, so that its
compile overlaps the port's CPU run.
"""
import ast
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.sim import harness as th
from test_torch_harness_baselines import lockstep as baseline_lockstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")

SCFG = jcfg.SolverConfiguration(linear_solver="cholesky")
TSCFG = config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(SCFG))
STEPS = 4


def _bases(**kw):
    return (jh.MainBase(solver_config=SCFG, **kw),
            th.MainBase(solver_config=TSCFG, device="cpu", **kw))


def _episode(base, predictor):
    """One evaluation episode through `MainBase.run`, recording per step the
    robot and pedestrian states, the convergence flag, the escalations, the
    predictor's output and the step's return."""
    rec = []
    step = base.run_one_step

    def recorded(robot, humans, intf, pred=None, verbose=False):
        mu, std = base.run_baseline_prediction(pred, humans)
        out = step(robot, humans, intf, pred, verbose)
        tracker = intf.traj_tracker
        rec.append(dict(robot=robot.state.copy(),
                        humans=np.array([h.state for h in humans]),
                        converged=tracker.solver_status_timelist[-1]
                        == "Converged",
                        escalations=tracker.escalation_count,
                        mu=np.array(mu), std=np.array(std), out=out))
        return out

    base.run_one_step = recorded
    base.run("MPC", "CVMP")
    return rec, base


@functools.lru_cache(maxsize=None)
def lockstep():
    jbase, tbase = _bases(max_num_run=1, max_run_time_step=STEPS,
                          evaluation=True, seed=1, scenario_index=1)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_episode, jbase, "cvmp")
        out_t = _episode(tbase, "cvmp")
        out_j = fut.result()
    return out_j, out_t


def test_cvmp_lockstep_matches_jax():
    (rec_j, _), (rec_t, _) = lockstep()
    assert len(rec_j) == len(rec_t) == STEPS
    dev = [float(np.abs(t["robot"][:2] - j["robot"][:2]).max())
           for j, t in zip(rec_j, rec_t)]
    print(f"robot deviation per step {dev}")
    for k, (j, t) in enumerate(zip(rec_j, rec_t)):
        assert dev[k] <= 1e-3, (k, dev)
        assert abs(t["robot"][2] - j["robot"][2]) <= 1e-3, k
        np.testing.assert_allclose(t["humans"], j["humans"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(t["mu"], j["mu"], rtol=0, atol=1e-9)
        np.testing.assert_array_equal(t["std"], j["std"])
        assert (t["converged"], t["escalations"]) == (j["converged"],
                                                      j["escalations"]), k
        # eval-mode arity: (collision, complete, solve_time, clearance)
        assert t["out"][:2] == j["out"][:2] == (False, False)
        assert t["out"][3] == pytest.approx(j["out"][3], abs=1e-3)
    # The robot drove toward its goal, and the pedestrian walked.
    assert rec_t[-1]["robot"][1] - rec_t[0]["robot"][1] > 0.2
    assert np.linalg.norm(rec_t[-1]["humans"][0, :2]
                          - rec_t[0]["humans"][0, :2]) > 0.5


def test_mpc_kfmp_lockstep_matches_jax():
    """The Kalman predictor's numpy predictions agree to 1e-9 (its
    covariance carries over between steps on both sides), the robot within
    1e-3 m at every step, flags, escalations and the summary equal."""
    steps = 2
    (jbase, rec_j, pred_j), (tbase, rec_t, pred_t) = baseline_lockstep(
        "mpc", "kfmp", jax_kw=dict(solver_config=SCFG),
        port_kw=dict(solver_config=TSCFG), max_num_run=1,
        max_run_time_step=steps, evaluation=True, seed=1, scenario_index=1)
    dev = [float(np.abs(t["robot"][:2] - j["robot"][:2]).max())
           for j, t in zip(rec_j, rec_t)]
    print(f"mpc+kfmp robot deviation per step {dev}")
    assert len(rec_t) == len(rec_j) == steps
    for k, (j, t) in enumerate(zip(rec_j, rec_t)):
        assert dev[k] <= 1e-3, (k, dev)
        np.testing.assert_allclose(t["humans"], j["humans"], rtol=0,
                                   atol=1e-9)
        assert t["out"][:2] == j["out"][:2] == (False, False)
    assert len(pred_t) == len(pred_j) == steps
    for a, b in zip(pred_t, pred_j):
        assert a.shape == (tbase.config_mpc.N_hor, 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    s_j, s_t = jbase.results_summary(), tbase.results_summary()
    assert set(s_t) == set(s_j) and "converged_rate" in s_t
    assert s_t["outcomes"] == s_j["outcomes"]
    assert s_t["converged_rate"] == s_j["converged_rate"]
    robot = tbase.episode[0]
    assert robot.state[1] - robot.past_traj[0][1] > 0.1


def test_no_predictor_step_matches_jax():
    """Without a predictor the pedestrians enter as fixed ellipses; the
    demo-mode return carries the reference's 8 fields."""
    jbase, tbase = _bases(max_run_time_step=1, seed=3, scenario_index=1)
    outs = []
    for base in (jbase, tbase):
        robot, humans = base._prepare_agents()
        intf, pred = base._prepare_interfaces(robot, None, "mpc")
        assert pred is None
        outs.append((base.run_one_step(robot, humans, intf), robot.state))
    (out_j, robot_j), (out_t, robot_t) = outs
    assert len(out_t) == len(out_j) == 8
    action, pred_states, cost, mu, std, hypos, obs, others = out_t
    np.testing.assert_allclose(action, out_j[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(robot_t, robot_j, rtol=0, atol=1e-4)
    assert len(pred_states) == tbase.config_mpc.N_hor
    assert mu is std is hypos is None
    assert obs == out_j[6] and len(obs) == tbase.config_mpc.Nstcobs
    np.testing.assert_array_equal(others[0], out_j[7][0])
    assert cost == pytest.approx(out_j[2], rel=1e-4)


def _summary_keys():
    """The keys `dyobav_tpu.sim.harness.MainBase.results_summary` can
    return, read from its source."""
    src = open(os.path.join(REPO, "dyobav_tpu", "sim", "harness.py")).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef)
              and n.name == "results_summary")
    return {n.value for n in ast.walk(fn)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.endswith(("_s", "_rate", "_mean", "_std", "_max",
                                  "outcomes"))}


def test_eval_run_summary_matches_jax():
    """The lockstep episode's summary: the JAX package's keys, outcome and
    rates."""
    (_, jbase), (_, tbase) = lockstep()
    s_j, s_t = jbase.results_summary(), tbase.results_summary()
    keys = _summary_keys()
    assert {"solve_time_mean_s", "converged_rate", "deviation_max",
            "outcomes"} <= keys
    assert set(s_t) == set(s_j) and set(s_t) <= keys
    assert s_t["outcomes"] == s_j["outcomes"] == [
        {"outcome": "timeout", "steps": STEPS,
         "escalations": s_j["outcomes"][0]["escalations"],
         "bad_statuses": s_j["outcomes"][0]["bad_statuses"]}]
    assert (s_t["success_rate"], s_t["converged_rate"]) == (
        s_j["success_rate"], s_j["converged_rate"])
    assert len(tbase.solve_time_list) == len(tbase.predict_time_list) == STEPS
    robot = tbase.episode[0]
    assert len(robot.past_traj) == STEPS + 1
    tbase.print_results()
