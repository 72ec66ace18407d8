"""The port's SWTA predictor (`dyobav_tpu_torch.predictors.mmp`,
`dyobav_tpu_torch.sim.batch.make_wta_predictor`) and the closed-loop sim
that it drives, against the JAX package's, on the CPU.

Both packages run the trained net from `Model/wsd_1t20_full_torch.pt`: the
port strictly loaded, the JAX package through its own converter
(`dyobav_tpu.models.port.load_torch_checkpoint`; these are the orbax
checkpoint's weights bit for bit, tests/test_torch_wta_net.py).  The closed
loop follows tests/test_wta_batch_sim.py (its small solver budget, under
Cholesky semantics as in tests/test_torch_batch_sim.py) with a shared
pedestrian `stagger_stream`; the JAX sim runs in a second thread while the
port's runs, so that its compile overlaps the port's CPU run.
"""
import dataclasses
import functools
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
from dyobav_tpu.sim import batch as jb
from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.models.wta_net import load_checkpoint
from dyobav_tpu_torch.predictors import mmp as tmmp
from dyobav_tpu_torch.sim import batch as tb
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")
DATA = os.path.join(REPO, "data", "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not (os.path.exists(PT) and os.path.exists(os.path.join(DATA,
                                                            "label.png"))),
    reason="trained checkpoint or map data absent")

# tests/test_wta_batch_sim.py's budget, under Cholesky semantics.
SCFG = jcfg.SolverConfiguration(
    max_inner_iters=6, max_outer_iters=2, inner_iters_later=3,
    escalation_ladder=((4, 2, 2, 1, 10.0),), escalation_slots=(4,),
    linear_solver="cholesky")
B, STEPS = 2, 2


class JaxNet:
    """The JAX net behind the one method of `NetworkManager` that
    `dyobav_tpu.predictors.mmp.MmpInterface` calls, `inference`, without the
    manager's optimizer state (whose build alone takes 20 s on the CPU)."""

    def __init__(self, variables):
        self.variables = variables
        self.apply = jax.jit(
            lambda v, im: jw.ConvMultiHypoNet().apply(v, im, train=False))

    def inference(self, images):
        return np.asarray(self.apply(self.variables,
                                     jnp.asarray(images, jnp.float32)))


@functools.lru_cache(maxsize=None)
def world():
    """(JAX MainBase, port MainBase, JAX net, port net), once per module."""
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       jport.load_torch_checkpoint(PT))
    return (jh.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0),
            th.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0),
            JaxNet(variables), load_checkpoint(PT, "cpu"))


def _predictors():
    jbase, tbase, jnet, net = world()
    tables = tmmp.ObstacleSnapper(255.0 - tbase.ref_map).tables()
    pred_j = jb.make_wta_predictor(
        jnet.apply, jnet.variables, jbase.ref_map, jbase.ct2real,
        n_hor=jbase.config_mpc.N_hor, snap_nearest=tables,
        scale2nn=jbase.sim_config.scale2nn)
    pred_t = tb.make_wta_predictor(
        net, tbase.ref_map, tbase.ct2real, n_hor=tbase.config_mpc.N_hor,
        snap_tables=tables, scale2nn=tbase.sim_config.scale2nn,
        device="cpu")
    return pred_j, pred_t


def _hist():
    """(B, 5, 1, 2) world-frame pedestrian histories: one walking up the
    aisle of tests/test_wta_batch_sim.py, one turning near a shelf."""
    up = [[1.0, 9.3 - 0.3 * (4 - i)] for i in range(5)]
    turn = [[-4.0 + 0.25 * i, -6.0 + 0.1 * i * i] for i in range(5)]
    return np.array([up, turn], np.float32)[:, :, None, :]


def test_obstacle_snapper_matches_jax():
    _, tbase, _, _ = world()
    occ = 255.0 - tbase.ref_map
    ts_, js_ = tmmp.ObstacleSnapper(occ), jmmp.ObstacleSnapper(occ)
    np.testing.assert_array_equal(ts_.tables(), js_.tables())
    assert ts_.occupied.any() and not ts_.occupied.all()
    pts = np.random.default_rng(0).uniform([-20, -20], [350, 310], (500, 2))
    snapped = ts_.snap(pts)
    np.testing.assert_array_equal(snapped, js_.snap(pts))
    moved = np.any(snapped != pts, axis=1)
    assert moved.any() and (~moved).any()


def test_mmp_interface_matches_jax():
    _, tbase, jnet, net = world()
    traj = [(160.0, 50.0), (160.0, 53.0), (160.0, 56.0)]
    port = tmmp.MmpInterface(net=net, device="cpu").get_motion_prediction(
        traj, tbase.ref_map, pred_offset=20)
    ref = jmmp.MmpInterface(network_manager=jnet).get_motion_prediction(
        traj, tbase.ref_map, pred_offset=20)
    assert len(port) == len(ref) == 20
    for t in range(20):
        assert port[t].shape == (20, 2)
        np.testing.assert_allclose(port[t], ref[t], rtol=0, atol=1e-3)
    # tests/test_mmp_e2e.py's quality gate: offset 1 stays near the walker.
    assert np.linalg.norm(port[0].mean(0) - [160.0, 56.0]) < 60.0


def test_wta_predictor_matches_jax_vmap():
    pred_j, pred_t = _predictors()
    hist = _hist()
    mu_j, std_j, alpha_j = (np.asarray(x) for x in
                            jax.vmap(pred_j)(jnp.asarray(hist)))
    mu_t, std_t, alpha_t = (x.numpy() for x in pred_t(torch.from_numpy(hist)))
    assert mu_t.shape == mu_j.shape == (B, 20, 8, 2)
    assert alpha_t.shape == (B, 20, 8)
    np.testing.assert_array_equal(alpha_t, alpha_j)
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(std_t, std_j, rtol=0, atol=1e-3)
    assert (alpha_t[:, 0].sum(-1) >= 1).all()


def test_wta_closed_loop_matches_jax():
    jbase, tbase, _, _ = world()
    pred_j, pred_t = _predictors()
    sc_j = js.random_scenarios(jbase, B, seed=3)
    sc_t = ts.random_scenarios(tbase, B, seed=3)
    rng = np.random.default_rng(5)
    stream = (rng.choice([-1.0, 1.0], (B, STEPS, 1))
              * rng.integers(0, 11, (B, STEPS, 1)) / 10.0 * 0.5
              ).astype(np.float32)
    run_j = jb.build_batch_sim(
        jbase.config_mpc, jbase.config_robot, SCFG, n_steps=STEPS,
        predictor=pred_j, record_traj=True, stagger_stream=stream)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(lambda: jax.tree_util.tree_map(
            np.asarray, run_j(sc_j, jnp.arange(B))))
        res_t, (traj_t, _) = tb.build_batch_sim(
            tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification(),
            config_from_dict(tcfg.SolverConfiguration,
                             dataclasses.asdict(SCFG)),
            n_steps=STEPS, predictor=pred_t, record_traj=True,
            stagger_stream=stream, device="cpu")(sc_t, np.arange(B))
        res_j, (traj_j, _) = fut.result()
    traj_j, traj_t = np.asarray(traj_j), traj_t.numpy()
    assert traj_t.shape == traj_j.shape == (STEPS, B, 3)
    dev = np.abs(traj_t[:, :, :2] - traj_j[:, :, :2]).max(axis=(0, 2))
    print(f"max robot deviation per lane {dev}")
    assert (dev <= 1e-3).all(), dev
    for f in ("success", "collided", "collided_static", "steps_used",
              "solver_fail_steps", "escalation_overflow_steps"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    # The robots moved (from rest, at most 1 m/s^2 for 0.4 s).
    start = np.asarray(sc_t.robot_start)[:, :2]
    assert (np.linalg.norm(traj_t[-1, :, :2] - start, axis=1) > 0.05).all()
