"""The port's solver options beside its default (`dyobav_tpu_torch.ops.engine`
with `linear_solver="schulz"`, `hessian_mode="structured"` or `"jacfwd"`,
and the staged solve, `fused=False`) against the JAX engine on the CPU, at
one short budget on tests/test_escalation.py's problem batch.

The staged float32 solve of B=8 problems (every fourth of the batch) serves
both tests below: lanes 0, 2, 4 and 6 of it are the B=4 problems of
`test_unported_options_raise` (every eighth), and each lane of a batched
solve comes out of a batch of 4 or of 8 the same to the bit, in either
package.  The float64 staged lockstep is tests/test_torch_newton_modes.py.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_escalation import CFG, ROBOT, SCFG, _problem_batch
from test_torch_engine import _np, _port

from dyobav_tpu.ops.engine import build_mpc_solver as jax_build
from dyobav_tpu_torch.ops import spd

torch.set_num_threads(1)

# 10 + 4 x 5 iterations, the penalty ramped from 10, on which 7 of the 8
# staged problems converge.  At a shorter budget the lanes that do not
# converge are mid-iteration at curvatures of 1e6, where float32 JAX and
# the port part (as do JAX's own LU and Cholesky solves).
MODE_BUDGET = dict(max_inner_iters=10, max_outer_iters=5, inner_iters_later=5,
                   newton_substeps=1, initial_penalty=10.0, cold_profile=None)
STAGED = {"fused": False}


def _configs(change):
    """(the port's, JAX's) SolverConfiguration for one option: JAX solves
    with Cholesky semantics, or with Schulz where that is the option."""
    scfg = dataclasses.replace(SCFG, **MODE_BUDGET, **change)
    jscfg = (scfg if "linear_solver" in change
             else dataclasses.replace(scfg, linear_solver="cholesky"))
    return scfg, jscfg


def _jax_solve(jscfg, Z, U0):
    """JAX's solve_batch, run in a second thread beside the port's solve
    so that its compile overlaps it."""
    return _np(jax_build(CFG, ROBOT, jscfg).solve_batch(jnp.asarray(Z),
                                                        jnp.asarray(U0)))


@pytest.fixture(scope="module")
def problems():
    Z, U0 = _problem_batch(32)
    return np.array(Z)[::4], np.array(U0)[::4]


@pytest.fixture(scope="module")
def staged_f32(problems):
    """Both packages' staged float32 solves of the B=8 problems, and the
    SPD kernel's launches during the port's."""
    Z, U0 = problems
    scfg, jscfg = _configs(STAGED)
    with ThreadPoolExecutor(1) as pool:
        jsol = pool.submit(_jax_solve, jscfg, Z, U0)
        port = _port(scfg)
        spd.spd_solve.launches = 0
        tsol = _np(port.solve_batch(Z, U0))
        return jsol.result(), tsol, spd.spd_solve.launches, port


@pytest.mark.parametrize("change,match", [
    ({"linear_solver": "schulz"}, "schulz"),
    ({"hessian_mode": "structured"}, "structured"),
    ({"hessian_mode": "jacfwd"}, "jacfwd"),
    (STAGED, "staged"),
])
def test_unported_options_raise(change, match, problems, request):
    """The solver options that raised until they were ported (ROADMAP
    item 3b) now solve: B=4 problems at a short budget, held to JAX at the
    same option by outcome (u within 1e-3 and the flags equal on at least
    3/4 of the lanes)."""
    Z, U0 = problems[0][::2], problems[1][::2]
    if change is STAGED:
        jsol, tsol = request.getfixturevalue("staged_f32")[:2]
        j = {f: x[::2] for f, x in jsol.items()}
        t = {f: x[::2] for f, x in tsol.items()}
    else:
        scfg, jscfg = _configs(change)
        with ThreadPoolExecutor(1) as pool:
            j = pool.submit(_jax_solve, jscfg, Z, U0)
            t = _np(_port(scfg).solve_batch(Z, U0))
            j = j.result()
    du = np.abs(t["u"] - j["u"]).max(axis=1)
    agree = (du <= 1e-3) & (t["exit_ok"] == j["exit_ok"])
    print(f"{match}: exit_ok JAX {j['exit_ok']}, port {t['exit_ok']}, "
          f"max |du| per lane {du}")
    assert agree.mean() >= 0.75, match
    assert t["exit_ok"].any() and np.isfinite(t["u"]).all(), match


def test_staged_solve_float32_by_outcome_and_no_masking_leak(problems,
                                                             staged_f32):
    """float32 staged solves land where JAX's do on at least 3/4 of the
    lanes; and a lane that meets the constraint tolerance in its first
    stage keeps its iterate while the others go on (per-lane masks)."""
    Z, U0 = problems
    jsol, tsol, launches, port = staged_f32
    assert launches == 0                    # a CPU tensor takes the plain path
    du = np.abs(tsol["u"] - jsol["u"]).max(axis=1)
    agree = (du <= 1e-3) & (tsol["exit_ok"] == jsol["exit_ok"])
    print(f"staged float32: lanes agreeing {agree.tolist()}, du {du}")
    assert agree.mean() >= 0.75
    assert 0 < jsol["exit_ok"].sum() < len(Z)
    # A lane solved alone gives what it gives inside the batch, whether it
    # converges or not: no lane is frozen by another's progress.
    for lane in (int(np.argmin(jsol["exit_ok"])), int(np.argmax(
            jsol["exit_ok"]))):
        one = _np(port.solve_batch(Z[lane:lane + 1], U0[lane:lane + 1]))
        np.testing.assert_allclose(one["u"][0], tsol["u"][lane], rtol=0,
                                   atol=1e-5, err_msg=f"lane {lane}")
