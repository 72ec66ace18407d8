"""The paper's baselines through the port's per-episode harness
(`sim/harness.MainBase.run`), in lockstep with the JAX package's, on the
CPU: the DWA tracker with the constant-velocity (cvmp) and the Kalman
(kfmp) predictors over whole evaluation episodes, and with the SWTA
predictor (mmp) over 10 steps.

Both sides run the same float32 DWA search on the same host-built grid,
and the pedestrians' stagger comes from `random.Random(seed)` on both
sides, so the robots must agree within 1e-4 m at every step (measured: 0.0
over these episodes) and the episodes must end alike.  With mmp both
sides run the trained net from `Model/wsd_1t20_full_torch.pt`, loaded as
tests/test_torch_harness_mmp.py loads it; the clustered predictions agree
within 1e-4 m, and the DWA picks the same cell at every step.  The JAX
side runs in a second thread while the port's runs.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.models import port as jport
from dyobav_tpu.models import wta_net as jw
from dyobav_tpu.predictors import mmp as jmmp
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch.models.wta_net import load_checkpoint
from dyobav_tpu_torch.ops import engine as tengine
from dyobav_tpu_torch.predictors import mmp as tmmp
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.trackers import dwa_tracker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "data", "warehouse_sim_original",
                                    "mymap.pgm")),
    reason="warehouse data not imported")
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")


class JaxNet:
    """The JAX net behind the one method of `NetworkManager` that the JAX
    `MmpInterface` calls, `inference` (tests/test_torch_harness_mmp.py)."""

    def __init__(self, variables):
        self.variables = variables
        self.apply = jax.jit(
            lambda v, im: jw.ConvMultiHypoNet().apply(v, im, train=False))

    def inference(self, images):
        return np.asarray(self.apply(self.variables,
                                     jnp.asarray(images, jnp.float32)))


def record_episode(base, tracker, predictor, make_predictor=None):
    """One evaluation episode through `MainBase.run`, recording per step the
    robot and pedestrian states, the tracker's action and cost, and each
    prediction the predictor returned (with `make_predictor`, that
    predictor in place of the harness's own, and the clustered predictions
    of the SWTA path)."""
    rec, preds = [], []
    step, prepare = base.run_one_step, base._prepare_interfaces
    wta = base.run_wta_prediction

    def clustered(*args):
        out = wta(*args)
        preds.append(out[:2])
        return out

    def prepared(robot, predictor_type, tracker_type):
        if make_predictor is not None:
            intf, _ = prepare(robot, None, tracker_type)
            base.run_wta_prediction = clustered
            return intf, make_predictor()
        intf, pred = prepare(robot, predictor_type, tracker_type)
        if pred is not None:
            predict = pred.get_motion_prediction

            def recorded_prediction(*args, **kw):
                out = predict(*args, **kw)
                preds.append(np.array(out[0]))
                return out

            pred.get_motion_prediction = recorded_prediction
        return intf, pred

    def recorded(robot, humans, intf, pred=None, verbose=False):
        out = step(robot, humans, intf, pred, verbose)
        tracker_ = intf.traj_tracker
        rec.append(dict(robot=robot.state.copy(),
                        humans=np.array([h.state for h in humans]),
                        action=np.array(tracker_.past_actions[-1]),
                        cost=tracker_.cost_timelist[-1], out=out))
        return out

    base._prepare_interfaces = prepared
    base.run_one_step = recorded
    base.run(tracker, predictor)
    return rec, preds


def lockstep(tracker, predictor, jax_kw=None, port_kw=None, makers=(),
             **kw):
    jbase = jh.MainBase(**kw, **(jax_kw or {}))
    tbase = th.MainBase(device="cpu", **kw, **(port_kw or {}))
    make_j, make_t = makers or (None, None)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(record_episode, jbase, tracker, predictor, make_j)
        out_t = record_episode(tbase, tracker, predictor, make_t)
        out_j = fut.result()
    return (jbase, *out_j), (tbase, *out_t)


@pytest.mark.parametrize("scenario, predictor", [(0, "cvmp"), (1, "kfmp")])
def test_dwa_episode_matches_jax(scenario, predictor):
    (jbase, rec_j, pred_j), (tbase, rec_t, pred_t) = lockstep(
        "dwa", predictor, max_num_run=1, max_run_time_step=120,
        evaluation=True, seed=1, scenario_index=scenario)
    dev = [float(np.abs(t["robot"][:2] - j["robot"][:2]).max())
           for j, t in zip(rec_j, rec_t)]
    print(f"dwa+{predictor} scenario {scenario}: {len(rec_t)} steps, robot "
          f"deviation max {max(dev):.3e} m")
    assert len(rec_t) == len(rec_j) >= 10
    for k, (j, t) in enumerate(zip(rec_j, rec_t)):
        assert dev[k] <= 1e-4, (k, dev[k])
        np.testing.assert_allclose(t["humans"], j["humans"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(t["action"], j["action"], rtol=0,
                                   atol=1e-6)
        assert t["cost"] == pytest.approx(j["cost"], rel=1e-5, abs=1e-6), k
        assert t["out"][:2] == j["out"][:2], k
    assert len(pred_t) == len(pred_j) == len(rec_t)
    for a, b in zip(pred_t, pred_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # The DWA neither escalates nor reports solver statuses: no
    # converged_rate in the summary.
    s_j, s_t = jbase.results_summary(), tbase.results_summary()
    assert set(s_t) == set(s_j) and "converged_rate" not in s_t
    assert s_t["outcomes"] == s_j["outcomes"]
    assert s_t["outcomes"][0]["escalations"] == 0
    assert s_t["success_rate"] == s_j["success_rate"]
    for key in ("clearance_mean", "clearance_dyn_mean", "deviation_mean"):
        if key in s_j:
            assert s_t[key] == pytest.approx(s_j[key], abs=1e-4), key


@pytest.mark.skipif(not os.path.exists(PT),
                    reason="trained checkpoint absent")
def test_dwa_mmp_lockstep_matches_jax():
    """dwa + mmp, the one (tracker, predictor) pair of the reference's six
    that no other test runs: scenario 0 for 10 steps, the same net on both
    sides.  The pedestrians agree within 1e-9 m, the clustered predictions
    (as many Gaussians a horizon step) within 1e-4 m, and the DWA picks
    the same cell, so the robots agree within 1e-4 m."""
    def jax_net():
        variables = jax.tree_util.tree_map(jnp.asarray,
                                           jport.load_torch_checkpoint(PT))
        return jmmp.MmpInterface(network_manager=JaxNet(variables))

    def port_net():
        return tmmp.MmpInterface(net=load_checkpoint(PT, "cpu"),
                                 device="cpu")

    (jbase, rec_j, pred_j), (tbase, rec_t, pred_t) = lockstep(
        "dwa", "mmp", makers=(jax_net, port_net), max_num_run=1,
        max_run_time_step=10, evaluation=True, seed=1, scenario_index=0)
    dev = [float(np.abs(t["robot"][:2] - j["robot"][:2]).max())
           for j, t in zip(rec_j, rec_t)]
    print(f"dwa+mmp scenario 0: {len(rec_t)} steps, robot deviation max "
          f"{max(dev):.3e} m")
    assert len(rec_t) == len(rec_j) == len(pred_t) == len(pred_j) == 10
    for k, (j, t) in enumerate(zip(rec_j, rec_t)):
        np.testing.assert_allclose(t["humans"], j["humans"], rtol=0,
                                   atol=1e-9)
        (mu_t, std_t), (mu_j, std_j) = pred_t[k], pred_j[k]
        assert [len(m) for m in mu_t] == [len(m) for m in mu_j], k
        assert sum(len(m) for m in mu_t[1:]) > 0
        for a, b in zip(mu_t + std_t, mu_j + std_j):
            np.testing.assert_allclose(np.array(a, float).reshape(-1, 2),
                                       np.array(b, float).reshape(-1, 2),
                                       rtol=0, atol=1e-4, err_msg=f"step {k}")
        # The same cell of the DWA's grid, so the same action and robot.
        np.testing.assert_allclose(t["action"], j["action"], rtol=0,
                                   atol=1e-6, err_msg=f"step {k}")
        assert dev[k] <= 1e-4, (k, dev[k])
        assert t["cost"] == pytest.approx(j["cost"], rel=1e-4, abs=1e-5), k
        assert t["out"][:2] == j["out"][:2], k
    s_j, s_t = jbase.results_summary(), tbase.results_summary()
    assert s_t["outcomes"] == s_j["outcomes"]


def test_dwa_no_predictor_step_and_one_host_copy():
    """Without a predictor the DWA takes the pedestrians' flat positions;
    the demo-mode return carries the reference's 8 fields, with the DWA's
    trajectories under `others`.  A step brings its result back in one
    host copy."""
    outs = []
    for base in (jh.MainBase(max_run_time_step=1, seed=3, scenario_index=1),
                 th.MainBase(max_run_time_step=1, seed=3, scenario_index=1,
                             device="cpu")):
        robot, humans = base._prepare_agents()
        intf, pred = base._prepare_interfaces(robot, None, "dwa")
        assert pred is None
        syncs = tengine.to_host.syncs
        outs.append((base.run_one_step(robot, humans, intf), robot.state))
        host_copies = tengine.to_host.syncs - syncs
    assert host_copies == 1
    (out_j, robot_j), (out_t, robot_t) = outs
    assert len(out_t) == len(out_j) == 8
    action, pred_states, cost, mu, std, hypos, obs, others = out_t
    np.testing.assert_array_equal(action, out_j[0])
    np.testing.assert_allclose(robot_t, robot_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pred_states, out_j[1], rtol=0, atol=1e-5)
    assert mu is std is hypos is obs is None
    all_traj, ok_traj, ok_cost = others
    assert len(all_traj) == len(out_j[7][0]) and len(ok_traj) == len(
        out_j[7][1])
    np.testing.assert_allclose(ok_cost, out_j[7][2], rtol=1e-5, atol=1e-6)
    assert cost == pytest.approx(out_j[2], rel=1e-5)


def test_dwa_tracker_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    base = th.MainBase(max_run_time_step=1)
    robot, _ = base._prepare_agents()
    with pytest.raises(RuntimeError, match="CUDA"):
        base._prepare_interfaces(robot, "kfmp", "dwa")
    with pytest.raises(RuntimeError, match="CUDA"):
        dwa_tracker.TrajectoryTracker(base.config_dwa, base.config_robot)
