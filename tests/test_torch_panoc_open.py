"""The port's PANOC at the OpEn-scale budget solves the production NLP
(tests/test_panoc.py::test_panoc_solves_production_nlp, on the port): 300
inner iterations, then 9 stages of 150, on the problem of
tests/test_newton_fused.py, seed 1.

Over 1,650 float32 iterations the port's and JAX's iterates part at
knife-edge accept tests (tests/test_torch_panoc.py), so the outcome is
held instead: PANOC converges, is feasible to 1e-3, and lands on the
port's own Newton solution within the JAX test's tolerances (cost rtol
1e-4, atol 1e-3; controls 5e-4).  The Newton reference runs the strong
(OpEn-default) solve at a budget it converges within, asserted.
"""
import numpy as np
import torch

from test_newton_fused import _problem

from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.ops import engine as tengine

torch.set_num_threads(1)

CFG, ROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()


def test_panoc_solves_production_nlp():
    z = np.array(_problem(1))
    u0 = np.tile(np.array([1.2, 0.0], np.float32), CFG.N_hor)
    newton = tengine.build_mpc_solver(
        CFG, ROBOT, tcfg.strong_configuration(
            max_inner_iters=8, max_outer_iters=3, inner_iters_later=4),
        device="cpu")
    panoc = tengine.build_mpc_solver(
        CFG, ROBOT, tcfg.SolverConfiguration(
            max_inner_iters=300, max_outer_iters=10, inner_iters_later=150),
        method="panoc", device="cpu")
    a = newton.solve(z, u0)
    b = panoc.solve(z, u0)
    print(f"panoc cost {float(b.cost):.6f}, residual {float(b.residual):.3e}, "
          f"newton cost {float(a.cost):.6f}; max control gap "
          f"{float((a.u - b.u).abs().max()):.3e}")
    assert bool(a.exit_ok) and float(a.infeasibility) <= 1e-3
    assert float(b.infeasibility) <= 1e-3
    assert bool(b.exit_ok)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(b.u.numpy(), a.u.numpy(), atol=5e-4)
    assert b.pred_states.shape == (CFG.N_hor, CFG.ns)
