"""One damped Newton iteration of the port's NMPC engine against the JAX
engine, on the problem batch of tests/test_escalation.py (the escalated
solves are held in tests/test_torch_engine.py).

Both sides solve with Cholesky semantics: JAX with
`linear_solver="cholesky"`, whose solve gives NaN on an indefinite matrix
as the TPU kernel's clamped Cholesky does on every indefinite system these
problems produce, and the port with its default SPD solve.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from test_escalation import CFG, ROBOT, SCFG, _problem_batch
from test_torch_engine import _np, _port

from dyobav_tpu.ops.engine import build_mpc_solver as jax_build


@pytest.fixture(scope="module")
def perturbed():
    """The batch with the warm start moved off the reference line: the
    straight start puts every state exactly on a kink of the ref-path
    cost, where one ulp of rollout rounding picks the Hessian's branch."""
    Z, U0 = _problem_batch(32)
    Z, U0 = np.array(Z), np.array(U0)
    rng = np.random.default_rng(5)
    return Z, (U0 + rng.normal(0, 0.05, U0.shape)).astype(np.float32)


@pytest.mark.parametrize("substeps", [1, 3])
def test_one_iteration_matches_jax(perturbed, substeps):
    """Budget (1, 1, 1, substeps): one Hessian, `substeps` LM updates and
    the stationarity probe.  With one update every rung of every lane is
    indefinite (nothing moves, under LU or Cholesky); with three the
    damping has grown enough for the ladder to move every lane."""
    Z, U0 = perturbed
    scfg = dataclasses.replace(SCFG, newton_substeps=substeps,
                               linear_solver="cholesky")
    a = _np(jax_build(CFG, ROBOT, scfg).solve_batch(jnp.asarray(Z),
                                                    jnp.asarray(U0)))
    b = _np(_port(scfg).solve_batch(Z, U0))
    moved = np.abs(b["u"] - U0).max(axis=1) > 1e-6
    assert moved.all() if substeps == 3 else not moved.any()
    # f32 rounding in another order (sums, rsqrt) through one to three
    # damped Newton steps: 1e-4 in control units and relative cost.
    np.testing.assert_allclose(b["u"], a["u"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-4)
    np.testing.assert_allclose(b["infeasibility"], a["infeasibility"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b["residual"], a["residual"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(b["pred_states"], a["pred_states"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(b["exit_ok"], a["exit_ok"])
