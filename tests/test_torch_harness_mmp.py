"""The port's per-episode harness with the SWTA predictor (mpc + mmp) in
lockstep with the JAX package's, on the CPU: 2 demo-mode steps of
scenario 0, seed 0.

Both predictors run the trained net from `Model/wsd_1t20_full_torch.pt`:
the port strictly loaded, the JAX package through its own converter, as
tests/test_torch_wta_predictor.py loads them, and are handed to
`run_one_step` directly.  The solver is the shipped
`SolverConfiguration()`, the JAX side with `linear_solver="cholesky"`
(tests/test_torch_harness.py says why).  The clustered predictions must
agree within 1e-4 m, the robot within 1e-3 m.  The JAX side runs in a
second thread while the port's runs, so that its compile overlaps the
port's CPU run.
"""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.models import port as jport
from dyobav_tpu.models import wta_net as jw
from dyobav_tpu.predictors import mmp as jmmp
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.models.wta_net import load_checkpoint
from dyobav_tpu_torch.predictors import mmp as tmmp
from dyobav_tpu_torch.sim import harness as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")
DATA = os.path.join(REPO, "data", "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not (os.path.exists(PT) and os.path.exists(os.path.join(DATA,
                                                            "label.png"))),
    reason="trained checkpoint or map data absent")

SCFG = jcfg.SolverConfiguration(linear_solver="cholesky")
STEPS = 2


class JaxNet:
    """The JAX net behind the one method of `NetworkManager` that the JAX
    `MmpInterface` calls, `inference`."""

    def __init__(self, variables):
        self.variables = variables
        self.apply = jax.jit(
            lambda v, im: jw.ConvMultiHypoNet().apply(v, im, train=False))

    def inference(self, images):
        return np.asarray(self.apply(self.variables,
                                     jnp.asarray(images, jnp.float32)))


def _episode(base, predictor):
    robot, humans = base._prepare_agents()
    intf, _ = base._prepare_interfaces(robot, None, "mpc")
    rec = []
    for _ in range(STEPS):
        (action, pred_states, cost, mu, std, clusters, obs,
         others) = base.run_one_step(robot, humans, intf, predictor)
        rec.append(dict(robot=robot.state.copy(), mu=mu, std=std,
                        humans=np.array([h.state for h in humans]),
                        clusters=[len(c) for c in clusters],
                        converged=intf.traj_tracker.solver_status_timelist[-1]
                        == "Converged",
                        escalations=intf.traj_tracker.escalation_count))
    return rec


def _jax_side():
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       jport.load_torch_checkpoint(PT))
    base = jh.MainBase(max_run_time_step=STEPS, seed=0, scenario_index=0,
                       solver_config=SCFG)
    return _episode(base, jmmp.MmpInterface(
        network_manager=JaxNet(variables)))


def test_mmp_lockstep_matches_jax():
    tbase = th.MainBase(max_run_time_step=STEPS, seed=0, scenario_index=0,
                        solver_config=config_from_dict(
                            tcfg.SolverConfiguration,
                            dataclasses.asdict(SCFG)),
                        device="cpu")
    pred = tmmp.MmpInterface(net=load_checkpoint(PT, "cpu"), device="cpu")
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_jax_side)
        rec_t = _episode(tbase, pred)
        rec_j = fut.result()
    N = tbase.config_mpc.N_hor
    for k, (j, t) in enumerate(zip(rec_j, rec_t)):
        print(f"step {k}: robot deviation "
              f"{np.abs(t['robot'][:2] - j['robot'][:2]).max():.3e} m")
        np.testing.assert_allclose(t["humans"], j["humans"], rtol=0,
                                   atol=1e-9)
        # One entry per horizon step and the current one; as many clusters
        # (Gaussians) per step on both sides.
        assert len(t["mu"]) == len(j["mu"]) == N + 1
        assert t["clusters"] == j["clusters"] and sum(t["clusters"]) > 0
        for a, b in zip(t["mu"] + t["std"], j["mu"] + j["std"]):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=0,
                                       atol=1e-4, err_msg=f"step {k}")
        dev = float(np.abs(t["robot"][:2] - j["robot"][:2]).max())
        assert dev <= 1e-3, (k, dev)
        assert (t["converged"], t["escalations"]) == (j["converged"],
                                                      j["escalations"]), k
    # The predicted pedestrian lies near the walker: the first horizon
    # step's nearest Gaussian within 1 m of its position.
    walker = rec_t[0]["mu"][0][0]
    nearest = min(np.hypot(m[0] - walker[0], m[1] - walker[1])
                  for m in rec_t[0]["mu"][1])
    assert nearest < 1.0
