"""The port's forward-mode derivatives keep to torch's C++ kernels.

An operator between a tensor with a forward-mode tangent and one without
sends torch through its Python reference kernels (`torch._refs`,
`torch._prims`), which cost more host time than the operator
(`dyobav_tpu_torch/ops/tangents.py`).  These tests count the Python frames
entered there during one `costs.make_block_curvature` call and one
`newton.step_derivatives` call on the CPU, in float32 and float64, so that
the detour cannot come back unnoticed, and check that the outputs are
finite, the shrinking window's `inf`-masked segments included.

What is left: 4 operators of the block Hessian's reverse pass, inside
torch's own backward formula of `amin` (the refpath's minimum over the
window), which the port cannot lift.
"""
import os
import sys

import numpy as np
import pytest
import torch

from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.ops import costs
from dyobav_tpu_torch.ops.newton import step_derivatives

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from bit_equality_cpu import busy_problem  # noqa: E402

torch.set_num_threads(1)

CFG, ROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
N, NS, NU = CFG.N_hor, CFG.ns, CFG.nu
# Top-level operators that reach torch._refs: 4 in torch's backward formula
# of the refpath's `amin` under the block Hessian; none in the step's.
BLOCK_FN_OPS, STEP_OPS = 4, 0


def refs_ops(fn):
    """(outermost torch._refs / torch._prims operators entered, all frames
    entered there) during fn(), after one call to warm it up."""
    fn()
    ops, frames = [0], [0]

    def prof(frame, event, arg):
        if event != "call":
            return
        name = frame.f_code.co_filename
        if "/torch/_refs/" in name or "/torch/_prims/" in name:
            frames[0] += 1
            back = frame.f_back.f_code.co_filename if frame.f_back else ""
            if "/torch/_prims_common/wrappers" in back:
                ops[0] += 1

    sys.setprofile(prof)
    try:
        out = fn()
    finally:
        sys.setprofile(None)
    return ops[0], frames[0], out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_curvature_keeps_to_cpp_kernels(dtype):
    p, u, X = busy_problem(0, CFG, dtype)
    y = torch.as_tensor(np.random.default_rng(1).normal(0, 1, 2 * N)).to(
        dtype)
    block_fn = costs.make_block_curvature(p, CFG, ROBOT)
    ops, frames, (C7, gF) = refs_ops(
        lambda: block_fn(X, u, y, torch.tensor(1250.0, dtype=dtype)))
    print(f"block_fn {dtype}: {ops} operators, {frames} frames in torch._refs"
          f" / torch._prims")
    assert ops <= BLOCK_FN_OPS
    assert frames < 40 * BLOCK_FN_OPS
    assert C7.shape == (N, NS + 2 * NU, NS + 2 * NU) and C7.dtype == dtype
    assert gF.shape == (N, CFG.Ndynobs, NS) and gF.dtype == dtype
    # Every step but the first masks segments j < k with inf: none of it
    # may leak into the curvature as inf or NaN.
    assert torch.isfinite(C7).all() and torch.isfinite(gF).all()
    assert (C7.abs().sum(dim=(1, 2)) > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_derivatives_keep_to_cpp_kernels(dtype):
    p, u, X = busy_problem(1, CFG, dtype)
    zk = torch.cat([torch.cat([p.s0[None], X[:-1]]), u.reshape(N, NU)], 1)
    step = lambda x, a: costs.unicycle_step(x, a, CFG.ts)  # noqa: E731
    ops, frames, (AB, Hf) = refs_ops(lambda: step_derivatives(step, zk, NS))
    assert (ops, frames) == (STEP_OPS, 0)
    assert AB.shape == (N, NS, NS + NU) and Hf.shape == (N, NS, NS + NU,
                                                         NS + NU)
    assert torch.isfinite(AB).all() and torch.isfinite(Hf).all()
    # The same derivatives as torch.func's, to the bit.
    from torch.func import jacfwd, vmap

    def step_z(zz):
        return step(zz[:NS], zz[NS:])

    assert torch.equal(AB, vmap(jacfwd(step_z))(zk))
    assert torch.equal(Hf, vmap(jacfwd(jacfwd(step_z)))(zk))
