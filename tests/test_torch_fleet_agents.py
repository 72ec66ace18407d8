"""The fleet's other agents on the CPU: tests/test_fleet.py's bar for one
robot and a crossing pedestrian through the port's fleet
(`dyobav_tpu_torch.sim.fleet`), and the preset reciprocating (back-and-forth)
agent of `dyobav_tpu_torch.motion.models` against the JAX package's.

The crossing bar is held in tier-1 where it is decided, in lockstep with
JAX in float64 (tests/test_torch_fleet_lockstep.py's `window`): from the
poses of tests/test_fleet.py's JAX run (robot and pedestrian) before the
pedestrian crosses the robot's path and before the goal.  The port's
whole 50-step run is marked `slow`.
"""
import numpy as np
import pytest
import torch

from dyobav_tpu.motion import models as jm
from dyobav_tpu_torch.motion import models as tm
from dyobav_tpu_torch.sim import fleet as tf
from dyobav_tpu_torch.sim import scenarios as ts
from dyobav_tpu.sim import scenarios as js
from test_torch_fleet import CFG, FAST, ROBOT, crossing_human, stack
from test_torch_fleet_lockstep import (WINDOW, jax_prefixes,
                                       pedestrian_after, window)

torch.set_num_threads(1)


@pytest.mark.parametrize("p1, p2, speed", [
    ((0.0, 0.0), (2.0, 0.0), 1.0),
    ((1.5, -2.0), (-0.7, 3.1), 1.3),
    ((0.0, 0.0), (0.0, 0.5), 0.8),
    ((3.0, 1.0), (-2.0, -4.0), 1.5),
    ((0.0, 0.0), (1.0, 1.0), 2.0)])
def test_reciprocating_state_matches_jax(p1, p2, speed):
    period = int(2 * np.hypot(p2[0] - p1[0], p2[1] - p1[1]) / speed
                 / CFG.ts) + 1
    dev = 0.0
    for kt in range(2 * period + 3):
        want = np.asarray(jm.reciprocating_state(kt, speed, CFG.ts, p1, p2))
        got = tm.reciprocating_state(kt, speed, CFG.ts, p1, p2)
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        # A time step given as a tensor gives the same state.
        assert torch.equal(tm.reciprocating_state(
            torch.tensor(kt), speed, CFG.ts, p1, p2), got)
        dev = max(dev, float(np.abs(got.numpy() - want).max()))
    print(f"reciprocating_state {p1}->{p2} at {speed} m/s: max deviation "
          f"from JAX {dev:.3e} over {2 * period + 3} steps")
    jmod = jm.ReciprocatingModel(CFG.ts, p1, p2, speed=speed)
    tmod = tm.ReciprocatingModel(CFG.ts, p1, p2, speed=speed)
    assert (tmod.state_dim, tmod.action_dim, tmod.ts) == (3, 1, CFG.ts)
    np.testing.assert_array_equal(tmod.init_state().numpy(),
                                  np.asarray(jmod.init_state()))
    np.testing.assert_allclose(tmod(period // 2, [2 * speed]).numpy(),
                               np.asarray(jmod(period // 2, [2 * speed])),
                               rtol=0, atol=1e-6)


def test_reciprocating_model_round_trip():
    """tests/test_mpc_core.py's round trip against the port: starts at p1,
    reaches p2 at half period, returns to p1, heading flips."""
    m = tm.ReciprocatingModel(0.2, (0.0, 0.0), (2.0, 0.0), speed=1.0)
    period = int(2 * 2.0 / 1.0 / 0.2) + 1
    s0 = m(0).numpy()
    s_half = m(period // 2).numpy()
    s_full = m(period).numpy()
    np.testing.assert_allclose(s0[:2], [0, 0], atol=1e-6)
    assert s_half[0] > 1.5
    np.testing.assert_allclose(s_full[:2], [0, 0], atol=1e-5)
    assert abs(m(1).numpy()[2]) < 1e-6
    assert abs(abs(m(period - 2).numpy()[2]) - np.pi) < 1e-6


# tests/test_fleet.py's JAX run reaches these steps before each window: the
# pedestrian (0.3 m a step from (3, 4) to (3, -4)) is 1 m short of the
# robot's path at step 10 and least far from the robot at steps 14-16; the
# robot is done from step GOAL_AT + 4.
CROSS_AT, GOAL_AT = 10, 32
GOAL, HUMAN_GOAL = [[6.0, 0.0]], [[3.0, -4.0]]


@pytest.fixture(scope="module")
def crossing_windows():
    """tests/test_fleet.py's JAX run to CROSS_AT and to GOAL_AT, then both
    packages from JAX's poses (robot and pedestrian) in lockstep
    (`window`), one batch: the crossing window (lane 0) and the goal window
    (lane 1).  Returns the prefix at CROSS_AT and the port's results."""
    prefixes = jax_prefixes(crossing_human(js), 1, (CROSS_AT, GOAL_AT),
                            human_stagger=0.0)
    for pre in prefixes:
        assert not pre["collided"].any() and not pre["done"].any()
    rt = window("crossing windows (crossing, goal)",
                [(pre["final_states"], GOAL, pedestrian_after(n), HUMAN_GOAL)
                 for pre, n in zip(prefixes, (CROSS_AT, GOAL_AT))],
                human_stagger=0.0)
    return prefixes[0], rt


def test_crossing_window_matches_jax(crossing_windows):
    """tests/test_fleet.py's crossing bar where the pedestrian crosses: on
    the port, no collision, a finite clearance, and the least
    robot-pedestrian distance inside the window, with the pedestrian from
    one side of the robot's path to the other."""
    pre, rt = crossing_windows
    robot, human = pre["final_states"], pedestrian_after(CROSS_AT)
    human_end = pedestrian_after(CROSS_AT + WINDOW)
    d0 = float(np.hypot(*(robot[0, :2] - human[0])))
    d1 = float(np.hypot(*(rt["final_states"][0, 0, :2] - human_end[0])))
    clearance = rt["min_clearance"][0, 0]
    print(f"crossing: robot-pedestrian {d0} m at step {CROSS_AT}, least "
          f"{clearance}, {d1} m at step {CROSS_AT + WINDOW}")
    assert not rt["collided"][0].any() and np.isfinite(clearance)
    assert human[0, 1] > robot[0, 1] > human_end[0, 1]
    assert clearance < min(d0, d1)
    assert np.isinf(rt["min_inter_robot"]).all()


def test_crossing_goal_window_matches_jax(crossing_windows):
    """tests/test_fleet.py's crossing bar at the goal: on the port, the goal
    reached with no collision."""
    _, rt = crossing_windows
    print(f"crossing goal: steps used {rt['steps_used'][1]}")
    assert rt["done"][1].all() and not rt["collided"][1].any()


@pytest.mark.slow
def test_fleet_with_human():
    """tests/test_fleet.py's bar for one robot and one crossing pedestrian
    through the fleet (the H > 0 branch) at its FAST budget: clearance
    bookkeeping live, no collision, goal reached; no other robot, so the
    inter-robot distance stays infinite.  Slow; tier-1 holds the bar through
    the two windows above."""
    run = tf.build_fleet_sim(CFG, ROBOT, FAST, n_robots=1, n_steps=50,
                             human_stagger=0.0, device="cpu")
    res = run(stack([crossing_human(ts)]), np.arange(1))
    print(f"fleet with a crossing pedestrian: min clearance "
          f"{res.min_clearance.tolist()}, steps used {res.steps_used.tolist()}"
          f", done {res.done.tolist()}")
    assert not res.collided.any()
    assert torch.isfinite(res.min_clearance).all()
    assert res.done.all()
    assert torch.isinf(res.min_inter_robot).all()
