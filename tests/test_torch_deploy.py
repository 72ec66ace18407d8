"""The port's deployment node (`dyobav_tpu_torch.sim.deploy`), the fused
step program (`sim.batch.build_step_program`), the preset maps and the ROS
message conversions, against the JAX package on the CPU.

The fused lockstep runs the shipped `SolverConfiguration()`: with a weak
cold profile the multistart's candidate pick is a float32 tie that two
implementations may break differently (ROADMAP.md section C), so the weak
budget of tests/test_deploy_preset.py is held by its contract only.  JAX
solves with `linear_solver="cholesky"`, the TPU kernel's semantics, as in
every port test.
"""
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.maps import preset as jpreset
from dyobav_tpu.models import heatmap as jheatmap
from dyobav_tpu.motion.models import unicycle_step_np
from dyobav_tpu.predictors.cvmp import CvmpInterface as JCvmp
from dyobav_tpu.sim import batch as jbatch
from dyobav_tpu.sim import deploy as jdeploy
from dyobav_tpu.sim import ros_adapter as jros
from dyobav_tpu.sim.harness import MainBase as JMainBase
from dyobav_tpu.sim.scenarios import build_scenario as jbuild_scenario
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.maps import preset as tpreset
from dyobav_tpu_torch.models import heatmap as theatmap
from dyobav_tpu_torch.ops import engine as tengine
from dyobav_tpu_torch.predictors.cvmp import CvmpInterface as TCvmp
from dyobav_tpu_torch.sim import batch as tbatch
from dyobav_tpu_torch.sim import deploy as tdeploy
from dyobav_tpu_torch.sim import ros_adapter as tros
from dyobav_tpu_torch.sim.harness import MainBase as TMainBase
from dyobav_tpu_torch.sim.scenarios import build_scenario as tbuild_scenario

torch.set_num_threads(1)

LOCKSTEP_TICKS = 3
# tests/test_deploy_preset.py's weak budget.
WEAK = dict(max_inner_iters=3, max_outer_iters=2, inner_iters_later=2,
            cold_profile=(4, 3, 2, 1, 10.0),
            escalation_ladder=((4, 3, 2, 1, 10.0),))


def test_presets_equal_the_jax_presets():
    assert list(tpreset.PRESETS) == list(jpreset.PRESETS)
    for name in jpreset.PRESETS:
        assert tpreset.get_preset(name) == jpreset.get_preset(name), name
    assert tpreset.corridor(gap=1.5) == jpreset.corridor(gap=1.5)
    assert tpreset.rotated_block(angle=0.3) == jpreset.rotated_block(
        angle=0.3)
    assert tpreset.crosswalk_map(False) == jpreset.crosswalk_map(False)
    assert tpreset.crossing_map() == jpreset.crossing_map()
    with pytest.raises(KeyError, match="Unknown preset"):
        tpreset.get_preset("nowhere")


class _StubTracker:
    """Records run_step calls; returns a constant forward action."""

    def __init__(self):
        self.calls = []

    def set_current_state(self, state):
        self.state = state

    def run_step(self, mode, dyn, map_updated=True):
        self.calls.append((mode, dyn))
        actions = [np.array([0.7, 0.1])]
        pred = [np.array([1.0, 2.0, 0.0])] * 20
        return actions, pred, 3.5, [], np.zeros((20, 3))


def _feed(transport, robot, poses):
    transport.publish("robot_pose", {"x": robot[0], "y": robot[1],
                                     "theta": robot[2]})
    transport.publish("actor_poses", {"poses": poses})


def test_host_mode_node_matches_jax():
    nodes = {}
    for name, mod, cvmp in (("jax", jdeploy, JCvmp), ("port", tdeploy, TCvmp)):
        transport = mod.LocalTransport()
        node = mod.NavigationNode(transport, _StubTracker(),
                                  predictor=cvmp(), n_hor=20)
        assert node.control_tick() is None            # no pose yet
        for t in range(7):                            # past the 5-deque
            _feed(transport, (1.0, 2.0, 0.1 * t),
                  {"a1": (5.0 + 0.3 * t, 2.0 - 0.1 * t)}
                  | ({"a2": (3.0, 4.0 + 0.2 * t)} if t >= 3 else {}))
            action = node.control_tick(mode="super")
        nodes[name] = (node, transport, action)
    (jn, jt, ja), (tn, tt, ta) = nodes["jax"], nodes["port"]
    np.testing.assert_array_equal(ta, ja)
    assert tt.published == jt.published
    assert len(tn.tracker.calls) == len(jn.tracker.calls) == 7
    for (tm, tdyn), (jm, jdyn) in zip(tn.tracker.calls, jn.tracker.calls):
        assert tm == jm == "super"
        np.testing.assert_allclose(np.asarray(tdyn, float),
                                   np.asarray(jdyn, float), rtol=0,
                                   atol=1e-12)
    dyn = np.asarray(tn.tracker.calls[-1][1], float)
    assert dyn.shape == (2, 21, 6)
    assert dyn[0][5][0] > dyn[0][1][0]                # +x extrapolated
    # The backward-velocity override.
    tn.tracker.run_step = lambda *a, **k: ([np.array([-0.5, 0.0])],
                                           [np.zeros(3)] * 20, 0.0, [],
                                           np.zeros((20, 3)))
    np.testing.assert_array_equal(tn.control_tick(), [0.0, 0.0])


def test_ros_conversions_match_jax():
    for q in ((0.0, 0.0, math.sin(math.pi / 4), math.cos(math.pi / 4)),
              (0.1, -0.2, 0.3, 0.9), (0.0, 0.0, -1.0, 0.0)):
        assert tros.quaternion_yaw(*q) == jros.quaternion_yaw(*q)
    assert abs(tros.quaternion_yaw(0.0, 0.0, math.sin(math.pi / 4),
                                   math.cos(math.pi / 4))
               - math.pi / 2) < 1e-9
    msg = SimpleNamespace(pose=SimpleNamespace(pose=SimpleNamespace(
        position=SimpleNamespace(x=1.5, y=-2.0),
        orientation=SimpleNamespace(x=0.0, y=0.0, z=0.6, w=0.8))))
    assert tros.odometry_to_pose(msg) == jros.odometry_to_pose(msg)
    # rospy is imported only when a RosTransport is built.
    try:
        import rospy  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="rospy"):
            tros.RosTransport()


def _worlds(n_ticks, sc):
    """The deployment latency script's drifting world: the pedestrians
    drift by uniform(-0.1, 0.1) + [0, 0.15] a tick (default_rng(0))."""
    rng = np.random.default_rng(0)
    humans = np.asarray(sc.human_starts, float)
    out = []
    for _ in range(n_ticks):
        out.append(humans)
        humans = humans + rng.uniform(-0.1, 0.1, humans.shape) + [0.0, 0.15]
    return out


@pytest.fixture(scope="module")
def scenarios():
    jbase = JMainBase(max_run_time_step=3, evaluation=True, seed=0)
    tbase = TMainBase(max_run_time_step=3, evaluation=True, seed=0,
                      device="cpu")
    jsc = jbuild_scenario(jbase, scenario_index=0)
    tsc = tbuild_scenario(tbase, scenario_index=0)
    for a, b in zip(jsc, tsc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return jbase, tbase, jsc, tsc


@pytest.fixture(scope="module")
def programs(scenarios):
    """Both packages' step programs at the shipped budget (JAX compiles
    its pair once for the module)."""
    jbase, tbase, _, _ = scenarios
    return (jbatch.build_step_program(
                jbase.config_mpc, jbase.config_robot,
                jcfg.SolverConfiguration(linear_solver="cholesky")),
            tbatch.build_step_program(
                tbase.config_mpc, tbase.config_robot,
                tcfg.SolverConfiguration(), device="cpu"))


def _nodes(scenarios, programs, n_humans=None):
    _, _, jsc, tsc = scenarios
    jfused, tfused = programs
    H = int(jsc.human_starts.shape[0]) if n_humans is None else n_humans
    jt, tt = jdeploy.LocalTransport(), tdeploy.LocalTransport()
    jn = jdeploy.NavigationNode(
        jt, fused_step=jfused, n_humans=H,
        scenario=jbatch.Scenario(*[jnp.asarray(x) for x in jsc]))
    tn = tdeploy.NavigationNode(tt, fused_step=tfused, scenario=tsc,
                                n_humans=H, device="cpu")
    return (jn, jt), (tn, tt)


def _lockstep(scenarios, programs, ticks, humans_of=None, n_humans=None):
    """Both nodes fed the same messages; the robot follows the JAX action.
    Returns per tick (JAX action, port action, JAX ref_idx, port ref_idx)
    and both nodes with their transports."""
    _, _, jsc, _ = scenarios
    (jn, jt), (tn, tt) = _nodes(scenarios, programs, n_humans)
    state = np.asarray(jsc.robot_start, float)
    out = []
    for humans in _worlds(ticks, jsc):
        if humans_of is not None:
            humans = humans_of(humans)
        poses = {f"a{i}": (p[0], p[1]) for i, p in enumerate(humans)}
        for tr in (jt, tt):
            _feed(tr, state, poses)
        ja, ta = jn.control_tick(), tn.control_tick()
        out.append((np.asarray(ja), np.asarray(ta),
                    int(jn.fused["ref_idx"]), int(tn.fused["ref_idx"])))
        state = unicycle_step_np(state, np.asarray(ja, float), 0.2)
    return out, (jn, jt), (tn, tt)


def test_fused_step_lockstep_matches_jax(scenarios, programs):
    out, (jn, jt), (tn, tt) = _lockstep(scenarios, programs, LOCKSTEP_TICKS)
    dev = [float(np.abs(ja - ta).max()) for ja, ta, _, _ in out]
    print(f"fused step, cold start + {LOCKSTEP_TICKS} ticks: action "
          f"deviation per tick {dev}")
    assert max(dev) <= 1e-4, dev
    assert [o[2] for o in out] == [o[3] for o in out]
    assert [m["converged"] for m in tt.published["viz"]] == [
        m["converged"] for m in jt.published["viz"]]
    for tm, jm in zip(tt.published["viz"], jt.published["viz"]):
        assert tm["cost"] == pytest.approx(jm["cost"], rel=1e-3)
    np.testing.assert_allclose(tn.fused["u_warm"].numpy(),
                               np.asarray(jn.fused["u_warm"]), rtol=0,
                               atol=1e-4)
    assert all(a[0] > 0.1 for _, a, _, _ in out)      # the robot drives


def test_two_humans_with_one_actor_pad_far(scenarios, programs):
    """A node sized for two pedestrians that sees one: the absent slot's
    history is 1e6 m away on both sides, the heat maps of such a point are
    zeros (no NaN) as in JAX, and the ticks stay in lockstep."""
    one = lambda humans: humans[:1]
    out, (jn, _), (tn, _) = _lockstep(scenarios, programs, 2, humans_of=one,
                                      n_humans=2)
    hist_t = tn._human_hist()
    np.testing.assert_array_equal(hist_t,
                                  np.asarray(jn._human_hist_tensor()))
    assert (hist_t[:, 1] == 1e6).all() and (hist_t[:, 0] < 1e3).all()
    dev = [float(np.abs(ja - ta).max()) for ja, ta, _, _ in out]
    print(f"two slots, one actor: action deviation per tick {dev}")
    assert max(dev) <= 1e-4 and [o[2] for o in out] == [o[3] for o in out]
    # The neural predictor's view of the padded slot: its pixel trajectory
    # lies ~1e7 px off the map.
    _, tbase, _, _ = scenarios
    far_px = np.full((5, 2), 1e7, np.float32)
    rm = np.asarray(tbase.ref_map, np.float32)
    offsets = np.arange(1.0, 21.0, dtype=np.float32)
    t_stack = theatmap.traj_to_input_stack(torch.from_numpy(far_px),
                                           torch.from_numpy(rm),
                                           torch.from_numpy(offsets)).numpy()
    j_stack = np.asarray(jheatmap.traj_to_input_stack(
        jnp.asarray(far_px), jnp.asarray(rm), jnp.asarray(offsets)))
    assert np.isfinite(t_stack).all() and np.isfinite(j_stack).all()
    np.testing.assert_array_equal(t_stack[:, :5], 0.0)
    np.testing.assert_allclose(t_stack, np.moveaxis(j_stack, -1, 1),
                               rtol=0, atol=1e-6)


def test_weak_budget_contract(scenarios):
    """tests/test_deploy_preset.py::test_navigation_node_fused_step on the
    port: finite actions, no reverse, one cmd_vel a tick, a converged flag
    in the diagnostics, and one host copy a tick plus the multistart's
    one sync."""
    _, tbase, _, tsc = scenarios
    fused = tbatch.build_step_program(tbase.config_mpc, tbase.config_robot,
                                      tcfg.SolverConfiguration(**WEAK),
                                      device="cpu")
    transport = tdeploy.LocalTransport()
    node = tdeploy.NavigationNode(transport, fused_step=fused, scenario=tsc,
                                  n_humans=int(tsc.human_starts.shape[0]),
                                  device="cpu")
    assert node.control_tick() is None
    r = np.asarray(tsc.robot_start, float)
    _feed(transport, r, {f"a{i}": (p[0], p[1])
                         for i, p in enumerate(np.asarray(tsc.human_starts))})
    tengine.to_host.syncs = tengine.any_lane.syncs = 0
    actions = [node.control_tick() for _ in range(3)]
    for a in actions:
        assert a is not None and np.all(np.isfinite(a))
        assert a[0] >= 0.0
    assert len(transport.published["cmd_vel"]) == 3
    assert "converged" in transport.published["viz"][-1]
    assert tengine.to_host.syncs == 3 and tengine.any_lane.syncs == 3


def test_step_program_needs_a_device_or_cuda(scenarios):
    _, tbase, _, tsc = scenarios
    with pytest.raises(ValueError, match="tracker_interface or fused_step"):
        tdeploy.NavigationNode(tdeploy.LocalTransport())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdeploy.NavigationNode(tdeploy.LocalTransport(),
                               fused_step=(None, None), scenario=tsc)
