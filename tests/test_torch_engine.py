"""The port's NMPC engine (`dyobav_tpu_torch.ops.engine`) against the JAX
engine, on the problem batch and budgets of tests/test_escalation.py.

Two JAX references, run on the CPU:
  * the JAX default (`linear_solver="pallas"`), which off the TPU solves
    with batched LU (`pallas_spd.py:145-147`);
  * JAX with `linear_solver="cholesky"`, whose solve gives NaN on an
    indefinite matrix as the TPU kernel's clamped Cholesky does on every
    indefinite system these problems produce.
The port follows the TPU kernel, so it is held tightly to the second and
within stated margins to the first.  Where LM rungs are indefinite (the
merit Hessian carries dynamics curvature and is not PD by construction),
LU returns a finite step that the ladder may take while the Cholesky
rejects the rung, and the two solvers walk to different iterates.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_escalation import CFG, ROBOT, SCFG, _problem_batch

from dyobav_tpu.ops.engine import build_mpc_solver as jax_build
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.ops import engine as tengine

# One intra-op thread: the solver's operators are tiny at these sizes, and
# the suite's parallel workers would otherwise oversubscribe the cores.
torch.set_num_threads(1)

TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()


def _port(scfg):
    return tengine.build_mpc_solver(
        TCFG, TROBOT,
        config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(scfg)),
        device="cpu")


def _np(sol):
    return {f: np.asarray(getattr(sol, f)) for f in sol._fields}


@pytest.fixture(scope="module")
def batch():
    Z, U0 = _problem_batch(32)
    return np.array(Z), np.array(U0)


@pytest.fixture(scope="module")
def escalated(batch):
    Z, U0 = batch
    port = _port(SCFG)
    return {"raw": _np(port.solve_batch(Z, U0)),
            "esc": _np(port.solve_batch_escalated(Z, U0)),
            "jax": _np(jax_build(CFG, ROBOT, SCFG).solve_batch_escalated(
                jnp.asarray(Z), jnp.asarray(U0))),
            "jax_chol": _np(jax_build(
                CFG, ROBOT, dataclasses.replace(
                    SCFG, linear_solver="cholesky")).solve_batch_escalated(
                jnp.asarray(Z), jnp.asarray(U0)))}


def test_escalated_matches_jax(escalated):
    esc = escalated["esc"]
    for ref, ok_margin, n_far_max in (("jax_chol", 0.0, 0),
                                      ("jax", 2 / 32, 1)):
        a = escalated[ref]
        ea, eb = a["exit_ok"], esc["exit_ok"]
        both = ea & eb
        du = np.abs(a["u"][:, :2] - esc["u"][:, :2]).max(axis=1)
        far = np.flatnonzero(both & (du > 1e-3))
        msg = (f"vs {ref}: exit_ok {ea.mean():.4f} (JAX) vs {eb.mean():.4f}"
               f" (port), lanes disagreeing on exit_ok "
               f"{np.flatnonzero(ea != eb).tolist()}, lanes both converge "
               f"{int(both.sum())}, first-action deviation > 1e-3 on "
               f"{far.tolist()} (max {du[both].max():.2e})")
        print(msg)          # the departure counts, shown by `pytest -s`
        # exit_ok: identical under Cholesky semantics; within 2 of 32
        # lanes of JAX-on-CPU's LU (the indefinite-rung difference).
        assert abs(ea.mean() - eb.mean()) <= ok_margin + 1e-9, msg
        # The fidelity bar of docs/parity_r3_default.json: first-action
        # deviation < 1e-3 control units where both converge.
        assert len(far) <= n_far_max, msg
        assert both.sum() >= 12, msg


def test_escalated_recovers_tail_and_preserves_converged(escalated):
    """The invariants of tests/test_escalation.py, held by the port."""
    raw, esc = escalated["raw"], escalated["esc"]
    assert raw["exit_ok"].mean() < 1.0
    assert esc["exit_ok"].mean() > raw["exit_ok"].mean()
    res_tol = SCFG.escalation_residual_tol or 0.0
    clean = raw["exit_ok"] & (raw["residual"] <= res_tol)
    assert np.abs(esc["u"] - raw["u"])[clean].max(initial=0.0) == 0.0
    band_changed = raw["exit_ok"] & (np.abs(esc["u"] - raw["u"]) > 0).any(1)
    polished = ((esc["residual"] <= raw["residual"] + 1e-6)
                & (esc["cost"] <= raw["cost"] + 1e-5 * (1 + abs(raw["cost"]))))
    basin_fix = esc["cost"] <= raw["cost"] - 5e-4 * (1 + abs(raw["cost"]))
    assert np.all(~band_changed | polished | basin_fix)
    both_feas = (raw["infeasibility"] <= 1e-3) & (esc["infeasibility"] <= 1e-3)
    assert np.where(both_feas, esc["cost"] - raw["cost"], 0.0).max() <= 1e-3


def test_single_solve_and_objective_match_batch(batch):
    Z, U0 = batch
    port = _port(SCFG)
    lanes = port.solve_batch(Z[:3], U0[:3])
    one = port.solve(Z[1], U0[1])
    for f in one._fields:
        np.testing.assert_array_equal(getattr(one, f).numpy(),
                                      getattr(lanes, f)[1].numpy(), err_msg=f)
    br = port.objective(one.u, Z[1])
    np.testing.assert_allclose(br.states.numpy(), one.pred_states.numpy())
    assert float(br.objective) == pytest.approx(float(one.cost), rel=1e-6)
    assert port.n_params == CFG.n_params and port.n_decision == 40
    assert port.device == torch.device("cpu")
    assert _port(SCFG) is port                       # memoized bundle


# 10 + 4 x 5 iterations, the penalty ramped from 10: the budget of
# tests/test_torch_newton_modes.py's float32 comparisons.
MODE_BUDGET = dict(max_inner_iters=10, max_outer_iters=5, inner_iters_later=5,
                   newton_substeps=1, initial_penalty=10.0, cold_profile=None)


@pytest.mark.parametrize("change,match", [
    ({"linear_solver": "schulz"}, "schulz"),
    ({"hessian_mode": "structured"}, "structured"),
    ({"hessian_mode": "jacfwd"}, "jacfwd"),
    ({"fused": False}, "staged"),
])
def test_unported_options_raise(change, match, batch):
    """The solver options that raised until they were ported (ROADMAP
    item 3b) now solve: B=4 problems at a short budget, held to JAX at the
    same option by outcome (u within 1e-3 and the flags equal on at least
    3/4 of the lanes).  JAX solves with Cholesky semantics, or with
    Schulz where that is the option."""
    Z, U0 = batch[0][::8], batch[1][::8]
    scfg = dataclasses.replace(SCFG, **MODE_BUDGET, **change)
    jscfg = (scfg if "linear_solver" in change
             else dataclasses.replace(scfg, linear_solver="cholesky"))
    j = _np(jax_build(CFG, ROBOT, jscfg).solve_batch(jnp.asarray(Z),
                                                     jnp.asarray(U0)))
    t = _np(_port(scfg).solve_batch(Z, U0))
    du = np.abs(t["u"] - j["u"]).max(axis=1)
    agree = (du <= 1e-3) & (t["exit_ok"] == j["exit_ok"])
    print(f"{match}: exit_ok JAX {j['exit_ok']}, port {t['exit_ok']}, "
          f"max |du| per lane {du}")
    assert agree.mean() >= 0.75, match
    assert t["exit_ok"].any() and np.isfinite(t["u"]).all(), match


def test_panoc_and_cold_profile_options(batch):
    """method="panoc" builds its own bundle and solves (its parity with
    JAX: tests/test_torch_panoc*.py); without a cold profile there is no
    escalated solve, and a pre-escalated warm penalty then warns."""
    scfg = config_from_dict(tcfg.SolverConfiguration,
                            dataclasses.asdict(SCFG))
    short = dataclasses.replace(scfg, max_inner_iters=2, max_outer_iters=1)
    panoc = tengine.build_mpc_solver(TCFG, TROBOT, short, method="panoc",
                                     device="cpu")
    assert panoc is not tengine.build_mpc_solver(TCFG, TROBOT, short,
                                                 device="cpu")
    Z, U0 = batch
    sol = panoc.solve_batch(Z[:2], U0[:2])
    assert sol.u.shape == (2, 40) and bool(torch.isfinite(sol.u).all())
    no_cold = dataclasses.replace(scfg, cold_profile=None,
                                  initial_penalty=10.0)
    assert tengine.build_mpc_solver(
        TCFG, TROBOT, no_cold, device="cpu").solve_batch_escalated is None
    tengine._COLD_WARNED = False
    with pytest.warns(UserWarning, match="cold"):
        tengine.build_mpc_solver(
            TCFG, TROBOT, dataclasses.replace(scfg, cold_profile=None,
                                              lbfgs_memory=9), device="cpu")
