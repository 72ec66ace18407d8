"""The port's `method="panoc"` engine (`dyobav_tpu_torch.ops.engine` over
`ops.panoc`) in lockstep with the JAX package's, in float64 on the CPU
(JAX under `jax.enable_x64`): `solve_batch` and `solve_batch_escalated` at
B=4 on tests/test_escalation.py's problems, at a short budget.

In float32 the two frameworks part within a few iterations
(tests/test_torch_panoc.py); in float64 they take the same accept and
step-size decisions, and the iterates agree to 1e-8.

The band quirk of the JAX engine (`dyobav_tpu/ops/engine.py:229-231`,
ROADMAP.md section C) is kept: `escalation_residual_tol` (1e-4) also
gates PANOC lanes, whose fixed-point residual is of gradient scale, so
every converged PANOC lane counts as a band lane and is re-solved.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_escalation import CFG, ROBOT, _problem_batch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.ops.engine import build_mpc_solver as jax_build
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.ops import engine as tengine

torch.set_num_threads(1)

TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
# A short budget (10 + 8 warm iterations, 14 + 8 in the escalation stage)
# with a residual tolerance of PANOC's scale, so that 3 of the 4 lanes
# converge and sit in the residual band above 1e-4.
SCFG = jcfg.SolverConfiguration(
    max_inner_iters=10, max_outer_iters=2, inner_iters_later=8, tol=100.0,
    escalation_ladder=((14, 2, 8, 1, 1250.0),))


def _port(scfg, dtype=torch.float64):
    """The port's PANOC bundle for the JAX configuration `scfg`."""
    tscfg = dataclasses.replace(
        config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(scfg)),
        dtype=dtype)
    return tengine.build_mpc_solver(TCFG, TROBOT, tscfg, method="panoc",
                                    device="cpu")


def _np(sol):
    return {f: np.asarray(getattr(sol, f)) for f in sol._fields}


def _jax64(fn_name, scfg, Z, U0):
    with jax.enable_x64(True):
        bundle = jax_build(CFG, ROBOT,
                           dataclasses.replace(scfg, dtype=jnp.float64),
                           method="panoc")
        return _np(getattr(bundle, fn_name)(jnp.asarray(Z, jnp.float64),
                                            jnp.asarray(U0, jnp.float64)))


@pytest.fixture(scope="module")
def batch():
    Z, U0 = _problem_batch(4)
    return np.array(Z), np.array(U0)


def test_solve_batch_lockstep_float64(batch):
    Z, U0 = batch
    a = _jax64("solve_batch", SCFG, Z, U0)
    b = _np(_port(SCFG).solve_batch(Z, U0))
    assert b["u"].dtype == np.float64
    np.testing.assert_allclose(b["u"], a["u"], rtol=0, atol=1e-8)
    for f in ("cost", "residual", "infeasibility"):
        np.testing.assert_allclose(b[f], a[f], rtol=1e-8, atol=1e-10,
                                   err_msg=f)
    np.testing.assert_array_equal(b["exit_ok"], a["exit_ok"])
    np.testing.assert_allclose(b["pred_states"], a["pred_states"], rtol=0,
                               atol=1e-8)


def test_escalated_lockstep_float64_keeps_band_quirk(batch, monkeypatch):
    Z, U0 = batch
    masks = []
    gather = tengine.gather_slots

    def recorded(mask, K):
        masks.append(mask.clone())
        return gather(mask, K)

    monkeypatch.setattr(tengine, "gather_slots", recorded)
    port = _port(SCFG)
    warm = _np(port.solve_batch(Z, U0))
    esc = _np(port.solve_batch_escalated(Z, U0))
    band_mask = masks.pop()
    # The quirk's precondition: converged lanes whose PANOC residual is far
    # above escalation_residual_tol (1e-4), beside one that fails.
    band = warm["exit_ok"] & (warm["residual"] > SCFG.escalation_residual_tol)
    assert band.sum() >= 2 and not warm["exit_ok"].all()
    # They are gathered for the deep re-solve with the failing lanes.
    np.testing.assert_array_equal(band_mask.numpy(),
                                  band | ~warm["exit_ok"])
    taken = np.abs(esc["u"] - warm["u"]).max(axis=1) > 0
    assert (taken & band).any()
    # The JAX engine does the same, lane for lane.
    a = _jax64("solve_batch_escalated", SCFG, Z, U0)
    np.testing.assert_allclose(esc["u"], a["u"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(esc["exit_ok"], a["exit_ok"])
    np.testing.assert_allclose(esc["cost"], a["cost"], rtol=1e-8)
    np.testing.assert_allclose(esc["residual"], a["residual"], rtol=1e-8)
    # Without the band, only the failing lanes are re-solved and the band
    # lanes keep their warm answers.
    no_band = _port(dataclasses.replace(SCFG, escalation_residual_tol=None))
    esc_nb = _np(no_band.solve_batch_escalated(Z, U0))
    np.testing.assert_array_equal(masks.pop().numpy(), ~warm["exit_ok"])
    np.testing.assert_array_equal(esc_nb["u"][band], warm["u"][band])
