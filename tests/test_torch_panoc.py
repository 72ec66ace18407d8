"""The port's PANOC/ALM solver (`dyobav_tpu_torch.ops.panoc`) against the
JAX package's, on the CPU: the L-BFGS buffer and two-loop direction per
lane, tests/test_panoc.py's analytic problems, and the `method="panoc"`
engine at a short float32 budget.

PANOC's FBE accept test and its γ bound are knife edges, and the step size
starts from a finite difference of two gradients of scale 1e4: in float32
the two frameworks' summation orders part within a few iterations (1e-4 in
u after 5), so float32 is held to JAX only at a 5-iteration budget, within
1e-3.  tests/test_torch_panoc_engine.py holds the engine to JAX in float64
over tens of iterations, escalation included; tests/test_torch_panoc_open.py
holds the outcome at the OpEn-scale budget.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_escalation import CFG, ROBOT, _problem_batch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.ops import panoc as jpanoc
from dyobav_tpu.ops.engine import build_mpc_solver as jax_build
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.ops import engine as tengine
from dyobav_tpu_torch.ops import panoc as tpanoc

torch.set_num_threads(1)

TCFG, TROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
def _port(scfg, dtype=torch.float64):
    """The port's PANOC bundle for the JAX configuration `scfg`."""
    tscfg = dataclasses.replace(
        config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(scfg)),
        dtype=dtype)
    return tengine.build_mpc_solver(TCFG, TROBOT, tscfg, method="panoc",
                                    device="cpu")


def _np(sol):
    return {f: np.asarray(getattr(sol, f)) for f in sol._fields}


@pytest.fixture(scope="module")
def batch():
    Z, U0 = _problem_batch(4)
    return np.array(Z), np.array(U0)


def test_lbfgs_push_and_direction_match_jax():
    """Seeded pushes into an m=4 buffer per lane (some rejected: disabled
    or of negative curvature, so heads differ across lanes and wrap), and
    the two-loop direction after each, against the JAX buffer per lane."""
    rng = np.random.default_rng(0)
    B, m, n = 5, 4, 7
    tbuf = tpanoc.lbfgs_init(B, m, n, torch.float32, "cpu")
    jbuf = jax.vmap(lambda _: jpanoc._lbfgs_init(m, n, jnp.float32))(
        jnp.arange(B))
    push = jax.vmap(jpanoc._lbfgs_push)
    direction = jax.vmap(jpanoc._lbfgs_direction)
    for _ in range(11):
        s = rng.normal(size=(B, n)).astype(np.float32)
        y = (s * rng.uniform(0.5, 2.0, (B, n))
             * rng.choice([1.0, 1.0, -1.0], (B, 1))).astype(np.float32)
        on = rng.uniform(size=B) < 0.8
        tbuf = tpanoc.lbfgs_push(tbuf, torch.tensor(s), torch.tensor(y),
                                 torch.tensor(on))
        jbuf = push(jbuf, jnp.asarray(s), jnp.asarray(y), jnp.asarray(on))
        for f in ("s", "y", "rho"):
            np.testing.assert_allclose(getattr(tbuf, f).numpy(),
                                       np.asarray(getattr(jbuf, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(tbuf.head.numpy(),
                                      np.asarray(jbuf.head))
        r = rng.normal(size=(B, n)).astype(np.float32)
        np.testing.assert_allclose(
            tpanoc.lbfgs_direction(tbuf, torch.tensor(r)).numpy(),
            np.asarray(direction(jbuf, jnp.asarray(r))), rtol=1e-5,
            atol=1e-6)
    assert len(set(tbuf.head.tolist())) > 1 and tbuf.head.max() > m


def _box_qp():
    target = np.array([2.0, -3.0, 0.3], np.float32)
    return ((lambda u: (jnp.sum((u - target) ** 2), jnp.zeros(1),
                        jnp.zeros(1))),
            (lambda u, p: (torch.sum((u - torch.tensor(target)) ** 2),
                           torch.zeros(1), torch.zeros(1))),
            [-1.0] * 3, [1.0] * 3, [-1e9], [1e9], [0.0] * 3,
            [1.0, -1.0, 0.3], 1e-5)


def _alm():
    return ((lambda u: (jnp.sum((u - 2.0) ** 2), u, jnp.zeros(1))),
            (lambda u, p: (torch.sum((u - 2.0) ** 2), u, torch.zeros(1))),
            [-10.0], [10.0], [0.0], [1.0], [0.5], [1.0], 2e-3)


def _rosenbrock():
    def f(u):
        return 100.0 * (u[1] - u[0] ** 2) ** 2 + (1 - u[0]) ** 2

    return ((lambda u: (f(u), jnp.zeros(1), jnp.zeros(1))),
            (lambda u, p: (f(u), torch.zeros(1), torch.zeros(1))),
            [-2.0, -2.0], [2.0, 2.0], [-1e9], [1e9], [-1.5, 1.5],
            [1.0, 1.0], 1e-3)


@pytest.mark.parametrize("problem", [_box_qp, _alm, _rosenbrock],
                         ids=["box_qp", "alm_constraint", "rosenbrock_box"])
def test_analytic_problems(problem):
    """tests/test_panoc.py's analytic problems at the full budget: the
    port reaches the known solution with tests/test_panoc.py's tolerance,
    and JAX's within twice it (Rosenbrock's valley parts the two
    frameworks' float32 iterates by 2e-4)."""
    jobj, tobj, lo, hi, clo, chi, u0, sol, atol = problem()
    arrays = [np.asarray(x, np.float32) for x in (lo, hi, clo, chi, u0)]
    t = tpanoc.make_panoc_solver(
        tobj, *[torch.tensor(a) for a in arrays[:4]],
        tcfg.strong_configuration())(torch.tensor(arrays[4])[None],
                                     torch.zeros(1, 1))
    j = jax.jit(jpanoc.make_panoc_solver(
        jobj, *[jnp.asarray(a) for a in arrays[:4]],
        jcfg.strong_configuration()))(jnp.asarray(arrays[4]))
    np.testing.assert_allclose(t.u[0].numpy(), sol, atol=atol)
    np.testing.assert_allclose(t.u[0].numpy(), np.asarray(j.u), atol=2 * atol)
    assert bool(t.converged[0]) == bool(j.converged)
    assert t.u.shape == (1, len(sol)) and t.residual.shape == (1,)


def test_float32_short_budget_matches_jax(batch):
    """At 5 iterations the float32 iterates still agree within 1e-3."""
    Z, U0 = batch
    scfg = jcfg.SolverConfiguration(max_inner_iters=5, max_outer_iters=1)
    a = _np(jax_build(CFG, ROBOT, scfg, method="panoc").solve_batch(
        jnp.asarray(Z), jnp.asarray(U0)))
    b = _np(_port(scfg, torch.float32).solve_batch(Z, U0))
    du = np.abs(a["u"] - b["u"]).max(axis=1)
    print(f"float32, 5 iterations: u deviation per lane {du}")
    assert b["u"].dtype == np.float32 and du.max() <= 1e-3
    np.testing.assert_array_equal(a["exit_ok"], b["exit_ok"])
    np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-3)
    np.testing.assert_allclose(b["pred_states"], a["pred_states"], rtol=0,
                               atol=1e-2)


def test_engine_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tengine.build_mpc_solver(TCFG, TROBOT, method="sqp", device="cpu")
