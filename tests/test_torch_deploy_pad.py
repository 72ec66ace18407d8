"""The port's deployment node sized for two pedestrians that sees one, in
lockstep with JAX's (the float32 nodes by outcome, the float64 step
programs within 1e-8; the helpers and fixtures of
tests/test_torch_deploy.py), and the dtype of the port's step program
(`dyobav_tpu_torch.sim.batch.build_step_program`).  A file of its own, so
that the suite's workers run its lockstep beside the one-slot node's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dyobav_tpu.models import heatmap as jheatmap
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.models import heatmap as theatmap
from dyobav_tpu_torch.sim import batch as tbatch
from test_torch_deploy import _hold, _lockstep, programs, scenarios  # noqa: F401

torch.set_num_threads(1)

# One iteration of every profile: a dtype does not depend on the budget.
ONE_ITERATION = dict(max_inner_iters=1, max_outer_iters=1,
                     inner_iters_later=1, cold_profile=(1, 1, 1, 1, 10.0),
                     escalation_ladder=((1, 1, 1, 1, 10.0),))


def test_two_humans_with_one_actor_pad_far(scenarios, programs):
    """A node sized for two pedestrians that sees one: the absent slot's
    history is 1e6 m away on both sides, the heat maps of such a point are
    zeros (no NaN) as in JAX, and the ticks stay in lockstep."""
    one = lambda humans: humans[:1]
    out, (jn, _), (tn, _), f64 = _lockstep(scenarios, programs, 2,
                                           humans_of=one, n_humans=2)
    hist_t = tn._human_hist()
    np.testing.assert_array_equal(hist_t,
                                  np.asarray(jn._human_hist_tensor()))
    assert (hist_t[:, 1] == 1e6).all() and (hist_t[:, 0] < 1e3).all()
    _hold("two slots, one actor", out, f64)
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


class _Narrowing(TorchDispatchMode):
    """Records every operator that makes a float32 tensor out of a float64
    input."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if (any(t.dtype == torch.float64 for t in ins)
                and any(isinstance(t, torch.Tensor)
                        and t.dtype == torch.float32
                        for t in tree_leaves(out))):
            self.ops.add(str(func))
        return out


@pytest.mark.parametrize("dtype", [None, torch.float64],
                         ids=["default", "float64"])
def test_step_program_dtype(scenarios, dtype):
    """`build_step_program` is float32 by default; at `dtype=torch.float64`
    its cold start and step return float64 and no operator on the way
    makes a float32 tensor out of a float64 one (the scenario's float32
    fields are only cast up), so the float64 lockstep above is a float64
    solve end to end."""
    _, tbase, _, tsc = scenarios
    kw = {} if dtype is None else {"dtype": dtype}
    want = torch.float32 if dtype is None else dtype
    step, cold = tbatch.build_step_program(
        tbase.config_mpc, tbase.config_robot,
        tcfg.SolverConfiguration(**ONE_ITERATION), device="cpu", **kw)
    robot = torch.as_tensor(np.asarray(tsc.robot_start), dtype=want)
    hist = torch.as_tensor(np.broadcast_to(np.asarray(tsc.human_starts),
                                           (5,) + tsc.human_starts.shape),
                           dtype=want)
    u_init = torch.tensor([1.2, 0.0], dtype=want).repeat(
        tbase.config_mpc.N_hor)
    with _Narrowing() as narrowing:
        u_warm = cold(tsc, robot, hist, u_init)
        action, u_next, _, _, cost = step(
            tsc, robot, hist, u_warm, torch.zeros(2, dtype=want),
            torch.zeros((), dtype=torch.long))
    assert u_warm.dtype == action.dtype == u_next.dtype == cost.dtype == want
    assert torch.isfinite(action).all()
    if dtype is None:
        # The probe sees the float32 program's products with Python floats,
        # which reach the operators as 0-dim float64 tensors.
        assert narrowing.ops
    else:
        assert not narrowing.ops, narrowing.ops
