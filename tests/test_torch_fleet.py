"""The port's fleet (`dyobav_tpu_torch.sim.fleet` and the fleet scenario
builders of `.sim.scenarios`) on the CPU: the builders against the JAX
package's, the `predictor` argument against the default, and
tests/test_fleet.py's head-on and capacity bars.  The fleet in lockstep
with the JAX fleet is tests/test_torch_fleet_lockstep.py; the
crossing-pedestrian bar and the reciprocating agent are
tests/test_torch_fleet_agents.py.

The head-on bar is held in tier-1 where it is decided, in lockstep with
JAX in float64 (tests/test_torch_fleet_lockstep.py's `window`): from the
poses of tests/test_fleet.py's JAX run two steps before the robots pass
and before their goals.  The port's whole 60-step run is marked `slow`:
20 s a step on the CPU beside the suite's six workers, eager.
"""
import os

import numpy as np
import pytest
import torch

from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.sim import fleet as tf
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts
from dyobav_tpu_torch.sim.batch import cv_predict_horizon

# One intra-op thread: the solver's operators are tiny at these sizes, and
# the suite's parallel workers would otherwise oversubscribe the cores.
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
needs_map = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")

CFG, ROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
BASE_SPEED = ROBOT.lin_vel_max * 0.8
# tests/test_fleet.py's FAST budget.
FAST = tcfg.SolverConfiguration(max_inner_iters=8, max_outer_iters=2,
                                inner_iters_later=4,
                                escalation_ladder=((4, 2, 2, 1, 10.0),),
                                escalation_slots=(4,))


def head_on(mod, lateral: float = 0.2):
    """tests/test_fleet.py's two robots swapping ends of an 8 m corridor,
    offset laterally, built by `mod` (either package's scenarios module)."""
    return mod.synthetic_fleet_scenario(
        [[0.0, lateral, 0.0], [8.0, -lateral, np.pi]],
        [[8.0, lateral], [0.0, -lateral]], base_speed=BASE_SPEED, ts=CFG.ts)


def crossing_human(mod):
    """tests/test_fleet.py's one robot and one crossing pedestrian."""
    return mod.synthetic_fleet_scenario(
        [[0.0, 0.0, 0.0]], [[6.0, 0.0]], base_speed=BASE_SPEED, ts=CFG.ts,
        human_starts=[[3.0, 4.0]], human_goals=[[3.0, -4.0]])


def stack(scenarios):
    """FleetScenarios of numpy fields -> one batched FleetScenario."""
    return tf.FleetScenario(*[np.stack(x) for x in zip(*scenarios)])


def assert_fleet_scenarios_equal(a, b):
    """A JAX FleetScenario and the port's, field for field, bit for bit."""
    assert a._fields == b._fields == tf.FleetScenario._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        assert isinstance(y, np.ndarray), f
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(y, x, err_msg=f)


@pytest.mark.parametrize("build", [
    lambda mod: head_on(mod, 0.2), lambda mod: head_on(mod, 0.35),
    crossing_human], ids=["head_on_0.2", "head_on_0.35", "crossing_human"])
def test_synthetic_fleet_scenario_equals_jax(build):
    sc = build(ts)
    assert_fleet_scenarios_equal(build(js), sc)
    on_cpu = ts.synthetic_fleet_scenario(
        sc.robot_starts, sc.goals[:, :2], base_speed=BASE_SPEED, ts=CFG.ts,
        human_starts=sc.human_starts, human_goals=sc.human_paths[:, 0],
        device="cpu")
    for f, x in zip(tf.FleetScenario._fields, on_cpu):
        assert isinstance(x, torch.Tensor), f
        assert x.dtype == (torch.int64 if f in ("ref_lens", "human_path_len")
                           else torch.float32), f
        np.testing.assert_array_equal(x.numpy(), getattr(sc, f), err_msg=f)


@pytest.fixture(scope="module")
def bases():
    return (jh.MainBase(evaluation=True, seed=0),
            th.MainBase(evaluation=True, seed=0))


def preset_routes(tbase, given_starts: bool) -> dict:
    """The preset scenarios 0 and 1's routes as a 2-robot fleet: starts from
    the routes' first nodes, or given starts."""
    h0, hp0, r0, rp0 = th.scenario(0)
    h1, hp1, r1, rp1 = th.scenario(1)
    kw = dict(human_path_nodes=hp0 + hp1,
              human_starts=[np.array(tbase.ct2real(h))[:2] for h in h0 + h1])
    if given_starts:
        return dict(kw, robot_path_nodes=[rp0, rp1], robot_starts=[
            np.array(tbase.ct2real(r)) for r in (r0, r1)])
    return dict(kw, robot_path_nodes=[[9] + rp0, [13] + rp1])


@needs_map
@pytest.mark.parametrize("case", ["routes", "routes_given_starts",
                                  "random_3_robots", "random_defaults"])
def test_map_fleet_scenarios_equal_jax(bases, case):
    jbase, tbase = bases
    if case.startswith("routes"):
        kw = preset_routes(tbase, case == "routes_given_starts")
        a = js.build_fleet_scenario(jbase, **kw)
        b = ts.build_fleet_scenario(tbase, **kw)
        assert b.robot_starts.shape == (2, 3)
        assert b.human_starts.shape == (2, 2)
    elif case == "random_3_robots":
        # The same seed draws the same walks, in the same order.
        a = js.random_fleet_scenarios(jbase, 3, n_robots=3, n_humans=1,
                                      seed=0)
        b = ts.random_fleet_scenarios(tbase, 3, n_robots=3, n_humans=1,
                                      seed=0)
        assert b.robot_starts.shape == (3, 3, 3)
    else:                                     # two robots, no pedestrian
        a = js.random_fleet_scenarios(jbase, 4, seed=4)
        b = ts.random_fleet_scenarios(tbase, 4, seed=4)
        assert b.human_starts.shape == (4, 0, 2)
        on_cpu = ts.random_fleet_scenarios(tbase, 4, seed=4, device="cpu")
        for f, x in zip(tf.FleetScenario._fields, on_cpu):
            assert isinstance(x, torch.Tensor), f
            np.testing.assert_array_equal(x.numpy(), getattr(b, f),
                                          err_msg=f)
    assert_fleet_scenarios_equal(a, b)
    assert b.all_polys.shape[-3] == 64
    assert np.isfinite(b.all_polys[..., :55, :, :]).all()
    assert (b.ref_lens > 3).all()


def test_fleet_capacity_guard_and_default_device():
    with pytest.raises(ValueError):
        tf.build_fleet_sim(CFG, ROBOT, FAST, n_robots=CFG.Nother + 2,
                           device="cpu")
    tf.build_fleet_sim(CFG, ROBOT, FAST, n_robots=CFG.Nother + 1,
                       device="cpu")
    run = tf.build_fleet_sim(CFG, ROBOT, FAST, n_robots=3, device="cpu")
    with pytest.raises(ValueError, match="robots"):
        run(stack([head_on(ts)]), np.arange(1))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.build_fleet_sim(CFG, ROBOT)


def test_predictor_argument_matches_the_default():
    """An explicit constant-velocity predictor gives the default's result
    bit for bit, and is called once a step and once for the cold
    pre-solve, with the (B, 5, H, 2) history of the B scenarios."""
    small = tcfg.SolverConfiguration(max_inner_iters=2, max_outer_iters=1,
                                     inner_iters_later=1,
                                     cold_profile=(2, 1, 1, 1, 10.0))
    # The head-on pair with a pedestrian crossing between them.
    sc = ts.synthetic_fleet_scenario(
        [[0.0, 0.2, 0.0], [8.0, -0.2, np.pi]], [[8.0, 0.2], [0.0, -0.2]],
        base_speed=BASE_SPEED, ts=CFG.ts, human_starts=[[4.0, 3.0]],
        human_goals=[[4.0, -3.0]])
    batch, steps = stack([sc, sc]), 2
    calls = []

    def predict(hist):
        calls.append(tuple(hist.shape))
        return cv_predict_horizon(hist, CFG.N_hor)

    default, given = (tf.build_fleet_sim(
        CFG, ROBOT, small, n_robots=2, n_steps=steps, predictor=p,
        device="cpu")(batch, np.arange(2)) for p in (None, predict))
    assert calls == [(2, 5, 1, 2)] * (steps + 1)
    for f in tf.FleetResult._fields:
        assert torch.equal(getattr(default, f), getattr(given, f)), f
    # Different seeds draw different pedestrian staggers.
    assert not torch.equal(default.min_clearance[0],
                           default.min_clearance[1])
    assert default.final_states.shape == (2, 2, 3)
    assert default.smoothness.shape == (2, 2, 2)


# tests/test_fleet.py's JAX run reaches these steps before each window: the
# robots are 1.07 m apart at step 19 and pass at about 0.5 m two steps
# later; they are done from step GOAL_AT + 4.
PASS_AT, GOAL_AT = 19, 37
HEAD_ON_GOALS = [[8.0, 0.2], [0.0, -0.2]]
STRAIGHT_GAP = 2 * 0.2      # the lateral gap of the two straight references


def _gap(poses):
    """(2, 3) poses -> the distance between the two robots' centres."""
    return float(np.hypot(*(poses[0, :2] - poses[1, :2])))


@pytest.fixture(scope="module")
def head_on_windows():
    """tests/test_fleet.py's JAX run to PASS_AT and to GOAL_AT, then both
    packages from JAX's poses in lockstep (`window`), one batch: the pass
    window twice (lanes 0 and 1) and the goal window (lane 2).  Returns
    the prefix at PASS_AT and the port's window results."""
    from test_torch_fleet_lockstep import jax_prefixes, window

    prefixes = jax_prefixes(head_on(js), 2, (PASS_AT, GOAL_AT), copies=2)
    for pre in prefixes:
        assert not pre["collided"].any() and not pre["done"].any()
    assert (prefixes[1]["min_inter_robot"] > 0.95 * ROBOT.vehicle_width).all()
    at_pass, at_goal = (pre["final_states"] for pre in prefixes)
    rt = window("head-on windows (pass, pass, goal)",
                [(s, HEAD_ON_GOALS, (), ()) for s in (at_pass, at_pass,
                                                      at_goal)])
    return prefixes[0], rt


def test_head_on_pass_window_matches_jax(head_on_windows):
    """tests/test_fleet.py's head-on bar where the robots pass: on the port,
    no collision and a pass at about the fleet cost's safe distance,
    widened beyond the straight-line gap; the closest approach lies inside
    the window, and the two copies give equal lanes."""
    from test_torch_fleet_lockstep import WINDOW

    pre, rt = head_on_windows
    starts = pre["final_states"]
    min_inter = rt["min_inter_robot"][:2]
    print(f"head-on pass: gap {_gap(starts)} m at step {PASS_AT}, least "
          f"{min_inter.tolist()}, {_gap(rt['final_states'][0])} m at step "
          f"{PASS_AT + WINDOW}")
    assert not rt["collided"][:2].any(), f"fleet collision, {min_inter}"
    assert (min_inter > 0.95 * ROBOT.vehicle_width).all()
    assert STRAIGHT_GAP < 0.95 * ROBOT.vehicle_width
    assert (min_inter > STRAIGHT_GAP + 0.05).all()
    assert (min_inter < _gap(starts)).all()
    assert (min_inter < _gap(rt["final_states"][0])).all()
    for f, x in rt.items():
        np.testing.assert_array_equal(x[0], x[1], err_msg=f)


def test_head_on_goal_window_matches_jax(head_on_windows):
    """tests/test_fleet.py's head-on bar at the goals: on the port, both
    robots at their goals with no collision."""
    _, rt = head_on_windows
    print(f"head-on goal: steps used {rt['steps_used'][2]}")
    assert rt["done"][2].all() and not rt["collided"][2].any()


@pytest.mark.slow
def test_fleet_head_on_avoidance():
    """tests/test_fleet.py's head-on bar at its FAST budget for 60 steps:
    two robots swapping ends of an 8 m corridor must pass each other
    without a collision, at about the fleet cost's safe distance, and both
    reach their goals.  Slow; tier-1 holds the bar through the two windows
    above."""
    run = tf.build_fleet_sim(CFG, ROBOT, FAST, n_robots=2, n_steps=60,
                             device="cpu")
    res = run(stack([head_on(ts)]), np.arange(1))
    collided, min_inter = res.collided.numpy(), res.min_inter_robot.numpy()
    done = res.done.numpy()
    print(f"head-on fleet: min inter-robot distance {min_inter}, steps used "
          f"{res.steps_used.tolist()}, fails {res.solver_fail_steps.tolist()}")
    # The decentralized plan exchange must keep the robots apart: the soft
    # fleet cost (safe_distance = vehicle_width) equilibrates the pass at
    # about vehicle_width center distance.
    assert not collided.any(), f"fleet collision, min_inter={min_inter}"
    assert (min_inter > 0.95 * ROBOT.vehicle_width).all()
    # ...while still letting both finish the swap.
    assert done.all(), f"robots did not reach goals: done={done}"
    # And they interacted: the straight-line gap (2 * 0.2 m) is below the
    # cost's safe distance, so the pass must have been widened.
    assert STRAIGHT_GAP < 0.95 * ROBOT.vehicle_width
    assert (min_inter > STRAIGHT_GAP + 0.05).all()
