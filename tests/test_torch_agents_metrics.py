"""The port's host-side pieces of the per-episode harness against the JAX
package's, on the CPU: the motion models, the simulation agents
(`motion/agents.py`), the constant-velocity predictor (`predictors/cvmp.py`)
and the evaluation metrics (`sim/metrics.py`).

All of them are numpy on both sides; the agents draw their stagger from a
`random.Random` of one seed, the standard library's stream, so their
trajectories must be equal, not close.
"""
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.motion import agents as jag
from dyobav_tpu.motion import models as jmod
from dyobav_tpu.predictors import cvmp as jcv
from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import metrics as jmet
from dyobav_tpu_torch.motion import agents as tag
from dyobav_tpu_torch.motion import models as tmod
from dyobav_tpu_torch.predictors import cvmp as tcv
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import metrics as tmet

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")


@pytest.fixture(scope="module")
def bases():
    return jh.MainBase(seed=0), th.MainBase(seed=0)


def test_motion_models_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        s, a3 = rng.normal(size=3), rng.normal(size=3)
        a2 = a3[:2]
        for jm, tm, a in ((jmod.UnicycleModel(0.2), tmod.UnicycleModel(0.2),
                           a2),
                          (jmod.UnicycleModel(0.2, rk4=False),
                           tmod.UnicycleModel(0.2, rk4=False), a2),
                          (jmod.OmnidirectionalModel(0.2),
                           tmod.OmnidirectionalModel(0.2), a3)):
            assert (tm.state_dim, tm.action_dim) == (jm.state_dim,
                                                     jm.action_dim)
            # Host states take the numpy twins on both sides: equal.
            np.testing.assert_array_equal(tm(s, a), jm(s, a))
            # Tensor states take the torch functions, JAX arrays the jnp
            # ones: both in float32.
            t = tm(torch.tensor(s, dtype=torch.float32),
                   torch.tensor(a, dtype=torch.float32)).numpy()
            j = np.asarray(jm(jnp.asarray(s, jnp.float32),
                              jnp.asarray(a, jnp.float32)))
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert tuple(tmod.OmnidirectionalModel(0.2).zero_action().shape) == (3,)


@pytest.mark.parametrize("scenario_index", [0, 1, 2])
def test_agents_trajectories_equal_jax(bases, scenario_index):
    """30 steps of the scenario's pedestrian (stagger drawn from one seed)
    and of its robot under seeded actions: equal to the JAX agents'."""
    jbase, tbase = bases
    actions = np.random.default_rng(scenario_index).uniform(
        [-0.2, -0.5], [1.0, 0.5], (30, 2))
    trajs = []
    for base, ag in ((jbase, jag), (tbase, tag)):
        hs, hp, rs, rp = jh.scenario(scenario_index)
        rng = random.Random(7)
        human_path = [tuple(base.ct2real(list(x))) for x in
                      base.net_graph.return_given_nodelist(hp[0])]
        human = ag.Human(np.concatenate([base.ct2real(hs[0]), [0.0]]), 0.2,
                         radius=0.2, stagger=0.5, rng=rng)
        human.set_path(human_path)
        robot = ag.Robot(np.array(base.ct2real(rs)), 0.2, 0.25, rng=rng)
        robot.set_path([tuple(base.ct2real(list(x))) for x in
                        base.net_graph.return_given_nodelist(rp)])
        moved = []
        for a in actions:
            moved.append(human.run_step(1.5))
            robot.one_step(a)
        trajs.append((np.array(human.past_traj), np.array(robot.past_traj),
                      moved, human.coming_path, rng.random()))
    (jh_, jr, jm, jc, jn), (th_, tr, tm, tc, tn) = trajs
    assert th_.shape == (31, 3) and tr.shape == (31, 3)
    np.testing.assert_array_equal(th_, jh_)
    np.testing.assert_array_equal(tr, jr)
    assert tm == jm and tc == jc and tn == jn
    assert np.linalg.norm(th_[-1, :2] - th_[0, :2]) > 1.0


def test_cvmp_matches_jax():
    rng = np.random.default_rng(1)
    port, ref = tcv.CvmpInterface(), jcv.CvmpInterface()
    assert port.n_hor == ref.n_hor == 20
    assert port.get_motion_prediction(None) is None
    for n in (1, 2, 5, 9):
        traj = rng.uniform(-10, 10, (n, 2)).tolist()
        for rescale in (1.0, 0.1):
            p_pos, p_std = port.get_motion_prediction(traj, rescale=rescale)
            j_pos, j_std = ref.get_motion_prediction(traj, rescale=rescale)
            np.testing.assert_allclose(p_pos, j_pos, rtol=0, atol=1e-12)
            assert p_std == j_std


def test_metrics_match_jax(bases):
    """The five metrics on seeded inputs on the real map.  Four are float64
    numpy on both sides (1e-12).  The static clearance runs the JAX
    package's `polygon_distance`, whose segment distances go through jnp in
    float32, against the port's float64: 1e-5 m, float32 rounding at
    map coordinates of up to 18 m."""
    _, tbase = bases
    static = tbase.geo_map.processed_obstacle_list
    rng = np.random.default_rng(2)
    states = np.concatenate([rng.uniform([-15, -15], [18, 14], (40, 2)),
                             rng.uniform(-np.pi, np.pi, (40, 1))], axis=1)
    # Points inside shelves and on top of a pedestrian too.
    inside = [np.append(np.mean(np.asarray(static[i]), axis=0), 0.0)
              for i in (0, 7, 30)]
    states = np.concatenate([states, np.array(inside)])
    humans = rng.uniform([-15, -15], [18, 14], (3, 2)).tolist()
    humans.append((states[5, :2] + [0.05, -0.1]).tolist())
    hits = []
    for s in states:
        hit = tmet.check_collision(s, static, humans)
        assert hit == jmet.check_collision(s, static, humans)
        hits.append(hit)
        assert tmet.calc_minimal_dynamic_obstacle_distance(s, humans) == \
            pytest.approx(jmet.calc_minimal_dynamic_obstacle_distance(
                s, humans), abs=1e-12)
    assert any(hits) and not all(hits)
    actions = rng.uniform(-1, 1, (25, 2))
    np.testing.assert_allclose(tmet.calc_action_smoothness(list(actions)),
                               jmet.calc_action_smoothness(list(actions)),
                               rtol=0, atol=1e-12)
    traj = states[:12, :2].tolist()
    ref_traj = [tuple(s) for s in rng.uniform(-5, 5, (50, 3))]
    np.testing.assert_allclose(
        tmet.calc_deviation_distance(ref_traj, traj),
        jmet.calc_deviation_distance(ref_traj, traj), rtol=0, atol=1e-12)
    clear_t = tmet.calc_minimal_obstacle_distance(traj, static)
    clear_j = jmet.calc_minimal_obstacle_distance(traj, static)
    assert clear_t == pytest.approx(clear_j, abs=1e-5)
    assert tmet.calc_minimal_obstacle_distance(states[-3:, :2].tolist(),
                                               static) == 0.0
