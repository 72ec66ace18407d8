"""One multistart decision of the batched simulation
(`dyobav_tpu_torch.sim.batch.build_lane_solvers` -> `solve_batch_multistart`)
against the JAX package's, on the CPU, at tests/test_batch_sim.py's FAST
budget under Cholesky semantics (see tests/test_torch_batch_sim.py).
"""
import jax.numpy as jnp
import numpy as np
import torch

from dyobav_tpu.ops.params import MpcParams as JaxParams
from dyobav_tpu.sim import batch as jb
from dyobav_tpu_torch.convert import params_from_numpy
from dyobav_tpu_torch.ops import engine as tengine
from dyobav_tpu_torch.sim import batch as tb
from test_torch_batch_sim import (CFG, FAST, ROBOT, TCFG, TROBOT, _np,
                                  _port_cfg)


def test_solve_batch_multistart_matches_jax():
    """One multistart decision on 4 lanes: an ellipse ahead of the robot at
    four lateral offsets, so that the brake, zero and swerve candidates
    compete with the warm start."""
    from dyobav_tpu.ops.params import empty_params, tuning_vector

    N = CFG.N_hor
    rng = np.random.default_rng(0)
    lanes = []
    for offset, v_prev in ((0.0, 1.2), (0.15, 0.9), (-0.3, 1.2), (1.5, 0.3)):
        ref = np.zeros((N, 3), np.float32)
        ref[:, 0] = 0.24 * np.arange(1, N + 1)
        ell = np.zeros((CFG.Ndynobs, N + 1, CFG.ndynobs), np.float32)
        ell[0, :, :] = [1.6, offset, 0.4, 0.4, 0.0, 1.0]
        p = empty_params(CFG)._replace(
            u_prev=np.array([v_prev, 0.0], np.float32),
            sN=ref[-1], q=np.asarray(tuning_vector(CFG), np.float32),
            ref_states=ref, ref_speed=np.full((N,), 1.2, np.float32),
            dyn_obs=ell, q_stc=np.full((N,), 10.0, np.float32),
            q_dyn=np.full((N,), 10.0, np.float32))
        lanes.append([np.asarray(x, np.float32) for x in p])
    P = JaxParams(*[np.stack(x) for x in zip(*lanes)])
    U0 = (np.tile([1.2, 0.0], (4, N)) + rng.normal(0, 0.02, (4, 2 * N))
          ).astype(np.float32)

    solve_j = jb.build_lane_solvers(CFG, ROBOT, FAST)[3]
    rj, oj = solve_j(JaxParams(*[jnp.asarray(x) for x in P]),
                     jnp.asarray(U0), jnp.asarray(P.u_prev))
    solve_t = tb.build_lane_solvers(TCFG, TROBOT, _port_cfg(FAST),
                                    device="cpu")[3]
    syncs = tengine.any_lane.syncs
    rt, ot = solve_t(params_from_numpy(P), torch.from_numpy(U0),
                     torch.from_numpy(P.u_prev))
    assert tengine.any_lane.syncs == syncs + 1     # one host sync per call
    rj, rt = _np(rj), _np(rt)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(rt["converged"], rj["converged"])
    # The candidates settle in different basins (brake, pass left, pass
    # right), far more than 1e-4 apart: u within 1e-4 on every lane means
    # both sides chose the same candidate and took the same cold re-solve.
    du = np.abs(rt["u"] - rj["u"]).max(axis=1)
    print("multistart |du| per lane:", du)
    assert du.max() < 1e-4, du
    np.testing.assert_allclose(rt["cost"], rj["cost"], rtol=1e-4, atol=1e-4)
    assert np.abs(rj["u"][0] - rj["u"][3]).max() > 0.1
