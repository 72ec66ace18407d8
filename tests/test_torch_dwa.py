"""The port's DWA engine (`dyobav_tpu_torch.ops.dwa`) against the JAX
package's, on the CPU: the host-side grid exactly, and on seeded scenes the
costs (within 1e-5 relative), the inf pattern, the best index, the stuck
rule and the all-inf stop exactly; then the cases of tests/test_dwa.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.ops import dwa as jdwa
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.ops import dwa as tdwa

torch.set_num_threads(1)

CFG, ROBOT = tcfg.DwaConfiguration(), tcfg.CircularRobotSpecification()
JCFG, JROBOT = jcfg.DwaConfiguration(), jcfg.CircularRobotSpecification()
N = CFG.N_hor


@pytest.fixture(scope="module")
def engines():
    return (tdwa.build_dwa_engine(CFG, ROBOT, device="cpu")[0],
            jdwa.build_dwa_engine(JCFG, JROBOT)[0])


def _grid(last_u):
    return tdwa.candidate_grid(CFG, ROBOT, tdwa.grid_spec(CFG, ROBOT),
                               np.asarray(last_u))


def _free_inputs(last_u=(0.8, 0.0)):
    """tests/test_dwa.py's free-space scene: robot at the origin heading
    +x, goal at (10, 0), obstacles FAR-padded."""
    u_all, valid = _grid(last_u)
    return [np.zeros(3, np.float32), u_all, valid,
            np.array([10.0, 0.0], np.float32),
            np.array([[0.0, 0.0], [10.0, 0.0]], np.float32), np.float32(1.2),
            np.full((64, 4, 2), tdwa.FAR, np.float32),
            np.full((N + 1, 16, 2), tdwa.FAR, np.float32)]


def _seeded_inputs(seed):
    """A random scene near the robot: up to 6 boxes, 3 pedestrians walking
    on a line, a 3-point reference path, a random last action."""
    rng = np.random.default_rng(seed)
    state = np.array([*rng.uniform(-1, 1, 2), rng.uniform(-np.pi, np.pi)],
                     np.float32)
    last_u = [rng.uniform(-0.5, 1.5), rng.uniform(-0.5, 0.5)]
    u_all, valid = _grid(last_u)
    stc = np.full((64, 4, 2), tdwa.FAR, np.float32)
    for i in range(rng.integers(1, 7)):
        c, h = rng.uniform(-4, 4, 2), rng.uniform(0.1, 0.6, 2)
        stc[i] = c + np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * h
    dyn = np.full((N + 1, 16, 2), tdwa.FAR, np.float32)
    for j in range(3):
        p0, v = rng.uniform(-3, 3, 2), rng.uniform(-0.3, 0.3, 2)
        dyn[:, j] = p0 + v * np.arange(N + 1)[:, None]
    ref = np.cumsum(rng.uniform(-2, 3, (3, 2)), axis=0).astype(np.float32)
    goal = ref[-1].copy()
    return [state, u_all, valid, goal, ref,
            np.float32(rng.uniform(0.3, 1.5)), stc, dyn]


def _run(engines, inputs):
    t = engines[0](*inputs)
    j = engines[1](*[jnp.asarray(x) for x in inputs])
    return ({f: getattr(t, f).numpy() for f in t._fields},
            {f: np.asarray(getattr(j, f)) for f in j._fields})


def _assert_same(t, j):
    np.testing.assert_array_equal(np.isinf(t["costs"]), np.isinf(j["costs"]))
    fin = np.isfinite(j["costs"])
    np.testing.assert_allclose(t["costs"][fin], j["costs"][fin], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["all_trajectories"], j["all_trajectories"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t["best_u"], j["best_u"])
    np.testing.assert_allclose(t["best_trajectory"], j["best_trajectory"],
                               rtol=0, atol=1e-5)
    assert (np.isinf(t["min_cost"]) and np.isinf(j["min_cost"])) or (
        t["min_cost"] == pytest.approx(float(j["min_cost"]), rel=1e-5))


def test_grid_spec_and_candidate_grid_match_jax():
    spec = tdwa.grid_spec(CFG, ROBOT)
    assert tuple(spec) == tuple(jdwa.grid_spec(JCFG, JROBOT)) == (6, 12)
    rng = np.random.default_rng(0)
    lasts = [[0.8, 0.0], [0.0, 0.0], [1.5, 0.5], [-0.5, -0.5]] + [
        list(rng.uniform([-0.5, -0.5], [1.5, 0.5])) for _ in range(20)]
    for last_u in lasts:
        u_t, v_t = tdwa.candidate_grid(CFG, ROBOT, spec, np.asarray(last_u))
        u_j, v_j = jdwa.candidate_grid(JCFG, JROBOT, spec, np.asarray(last_u))
        assert u_t.dtype == np.float32 and v_t.dtype == bool
        np.testing.assert_array_equal(u_t, u_j)
        np.testing.assert_array_equal(v_t, v_j)
    with pytest.raises(ValueError, match="grid spec"):
        tdwa.candidate_grid(CFG, ROBOT, tdwa.DwaGridSpec(2, 2),
                            np.zeros(2))


@pytest.mark.parametrize("seed", range(6))
def test_engine_matches_jax_on_seeded_scenes(engines, seed):
    t, j = _run(engines, _seeded_inputs(seed))
    _assert_same(t, j)
    best = int(np.argmin(j["costs"]))
    assert int(np.argmin(t["costs"])) == best


def test_engine_stuck_rule_and_all_inf_stop_match_jax(engines):
    # Boxed in between two walls: slow candidates only, the stuck rule
    # rewrites a slow best into a spin (tests/test_dwa.py).
    inputs = _free_inputs(last_u=(0.0, 0.0))
    inputs[6][0] = [[0.1, -5.0], [0.3, -5.0], [0.3, 5.0], [0.1, 5.0]]
    inputs[6][1] = [[-0.3, -5.0], [-0.1, -5.0], [-0.1, 5.0], [-0.3, 5.0]]
    t, j = _run(engines, inputs)
    _assert_same(t, j)
    np.testing.assert_array_equal(t["best_u"], [0.0, -ROBOT.ang_vel_max])
    # A pedestrian on the robot: every candidate hits, the engine stops.
    inputs = _free_inputs()
    inputs[7][0, 0] = [0.05, 0.0]
    t, j = _run(engines, inputs)
    _assert_same(t, j)
    assert np.isinf(t["costs"]).all()
    np.testing.assert_array_equal(t["best_u"], [0.0, 0.0])
    # Free space at base speed 0: the best candidate is v = 0, which the
    # stuck rule turns into a spin.
    inputs = _free_inputs(last_u=(0.0, 0.0))
    inputs[5] = np.float32(0.0)
    t, j = _run(engines, inputs)
    _assert_same(t, j)
    np.testing.assert_array_equal(t["best_u"], [0.0, -ROBOT.ang_vel_max])


def test_free_space_drives_forward(engines):
    res = engines[0](*_free_inputs())
    u = res.best_u.numpy()
    # The window is [0.6, 1.0) and arange excludes the top: 0.9 is fastest.
    assert u[0] == pytest.approx(0.9, abs=1e-6)
    assert u[1] == pytest.approx(0.0, abs=1e-6)
    traj = res.best_trajectory.numpy()
    assert traj.shape == (21, 3)
    np.testing.assert_allclose(traj[0], [0, 0, 0], atol=1e-7)
    assert traj[-1, 0] == pytest.approx(0.9 * 0.2 * 20, rel=1e-5)


def test_blocking_obstacle_is_inf(engines):
    inputs = _free_inputs()
    inputs[6][0] = [[1.0, -5.0], [1.2, -5.0], [1.2, 5.0], [1.0, 5.0]]
    res = engines[0](*inputs)
    costs, valid = res.costs.numpy(), res.valid.numpy()
    assert np.isinf(costs[valid]).any()
    assert res.best_u.numpy()[0] < 1.0


def test_dynamic_obstacle_steps_weighting(engines):
    inputs = _free_inputs()
    inputs[7][10, 0] = [2.0, 0.0]
    res = engines[0](*inputs)
    traj = res.best_trajectory.numpy()
    d = np.hypot(traj[9, 0] - 2.0, traj[9, 1] - 0.0)  # rollout 9 <-> step 10
    assert d > 0.2
    assert np.isfinite(float(res.min_cost))
