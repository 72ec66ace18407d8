"""Forward-mode derivatives that keep torch on its C++ kernels.

An operator between a tensor that carries a forward-mode tangent and one
that does not (a constant, a Python number, or the basis or cotangent seed
of an inner transform) fills the missing tangent with an efficient zero
tensor.  `add`, `sub` and `mul` of such a tensor take their output's shape
from the Meta dispatch key, which `torch._meta_registrations` points at the
Python reference kernels (`torch._refs`, `torch._prims`): hundreds of
microseconds of host time an operator, more than the operator.

So the derivative code lifts its tensor constants, and the inner
transform's basis or seed, once into the tangent levels of the point it
differentiates at, with a zero tangent (`lift`).  The lifted tensors hold
the same values; a tangent then gains terms that are exact zeros, which
leave every value as it was.  Python numbers go through the `.Scalar`
overloads (`motion/models.py`), which need no lifting.
"""
from __future__ import annotations

import torch
from torch.func import jvp, vjp, vmap


def lift(anchor: torch.Tensor, tree):
    """The floating tensors of `tree` (a tensor, or a dict / tuple / list of
    them) as tensors at `anchor`'s tangent levels with a zero tangent; the
    values are the same, and other leaves are returned as they are.

    anchor: a 0-dim tensor at the levels to lift into.  A tensor carrying
    `inf` stays as it is: the lift selects, it does not add or multiply.
    """
    if isinstance(tree, dict):
        return {k: lift(anchor, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(lift(anchor, v) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        no = torch.zeros((), dtype=torch.bool, device=tree.device)
        return torch.where(no, anchor, tree)
    return tree


def jacfwd(f):
    """`torch.func.jacfwd(f)` for f(x, consts) with x a 1-d tensor: consts
    and the basis are lifted to x's tangent levels (an enclosing `jacfwd`'s
    included), so nested derivatives keep to the C++ kernels.  The outputs
    (a tensor or a tuple of them) have the trailing dim x.shape[0], as
    `torch.func.jacfwd`'s, with the same values."""
    def jac(x, consts=None):
        anchor = x[0]
        basis = lift(anchor, torch.eye(x.shape[0], dtype=x.dtype,
                                       device=x.device))

        def push(xd):
            return f(xd, lift(xd[0], consts))

        def column(t):
            return jvp(push, (x,), (t,))[1]

        cols = vmap(column)(basis)
        if isinstance(cols, tuple):
            return tuple(c.movedim(0, -1) for c in cols)
        return cols.movedim(0, -1)
    return jac


def hessian(f):
    """`torch.func.hessian(f)` (jacfwd of jacrev) for a scalar f(x, consts)
    with x a 1-d tensor: consts and the reverse pass's cotangent seed are
    lifted into the forward pass's tangent level, and consts stay constants
    of the reverse pass (they get no gradient).  The seed is not batched as
    `torch.func.jacrev`'s one-row basis is: the same values, one transform
    level fewer."""
    def grad_x(xd, consts):
        out, vjp_fn = vjp(lambda x_: f(x_, consts), xd)
        seed = lift(xd[0], torch.ones_like(out))
        return vjp_fn(seed)[0]
    return jacfwd(grad_x)
