"""Kinematic motion models in PyTorch (L1), the port of
`dyobav_tpu.motion.models`.

state = (x, y, theta); action = (v, omega) for the unicycle and
(vx, vy, omega) for the omnidirectional model; the reciprocating model's
state is a pure function of the time step.  The functions take one
state and one action; batch them with `torch.func.vmap`.  Each has a numpy
twin for host-side callers (the simulation's agents), which `MotionModel`
picks for a state that is not a tensor.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


# Python numbers enter the model through the `.Scalar` overloads.  Written
# as `0.5 * k1`, a number becomes a tensor without a forward-mode tangent;
# under `jacfwd` torch fills that tangent with an efficient zero tensor and
# takes the operator's output shape from its Python reference kernel
# (`torch._refs`), which costs more host time than the operator.  The
# overloads run the same kernels, so every value, tangent included, is the
# same (`ops/costs.py` does the same for its constants).
_mul = torch.ops.aten.mul.Scalar
_div = torch.ops.aten.div.Scalar


def unicycle_derivative(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    v, w = action[0], action[1]
    return torch.stack([v * torch.cos(state[2]), v * torch.sin(state[2]), w])


def unicycle_step(state: torch.Tensor, action: torch.Tensor, ts: float,
                  rk4: bool = True) -> torch.Tensor:
    """Unicycle kinematics, RK4-integrated by default; the action is held
    constant across the RK4 sub-steps, as in the reference.  ts is a
    Python number."""
    if rk4:
        k1 = _mul(unicycle_derivative(state, action), ts)
        k2 = _mul(unicycle_derivative(state + _mul(k1, 0.5), action), ts)
        k3 = _mul(unicycle_derivative(state + _mul(k2, 0.5), action), ts)
        k4 = _mul(unicycle_derivative(state + k3, action), ts)
        return state + _div(k1 + _mul(k2, 2.0) + _mul(k3, 2.0) + k4, 6.0)
    return state + _mul(unicycle_derivative(state, action), ts)


def omnidirectional_step(state: torch.Tensor, action: torch.Tensor,
                         ts: float) -> torch.Tensor:
    """Holonomic model: state += ts * action
    (`motion_model.omnidirectional_model`, motion_model.py:130-139)."""
    return state + ts * action


def unicycle_step_np(state, action, ts: float, rk4: bool = True):
    """Numpy twin of `unicycle_step` for host-side callers."""
    def d(s):
        return ts * np.array([action[0] * np.cos(s[2]),
                              action[0] * np.sin(s[2]), action[1]])

    if rk4:
        k1 = d(state)
        k2 = d(state + 0.5 * k1)
        k3 = d(state + 0.5 * k2)
        k4 = d(state + k3)
        return state + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    return state + d(state)


def omnidirectional_step_np(state, action, ts: float):
    """Numpy twin of `omnidirectional_step` (host-side agents)."""
    return state + ts * action


class MotionModel:
    """Callable carrying (state_dim, action_dim, ts), the reference's
    `MotionModel` surface (motion_model.py:32-68)."""

    def __init__(self, fn: Callable, state_dim: int, action_dim: int,
                 ts: float, np_fn: Callable | None = None):
        self.fn = fn
        self.np_fn = np_fn
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.ts = ts

    def __call__(self, state, action, ts: float | None = None):
        ts = self.ts if ts is None else ts
        # A host-side state (the simulation's agents) takes the numpy twin:
        # one 3-element step is not worth a device round trip.
        if self.np_fn is not None and not isinstance(state, torch.Tensor):
            return self.np_fn(np.asarray(state, np.float64),
                              np.asarray(action, np.float64), ts)
        return self.fn(torch.as_tensor(state), torch.as_tensor(action), ts)

    def zero_state(self):
        return torch.zeros(self.state_dim)

    def zero_action(self):
        return torch.zeros(self.action_dim)


class UnicycleModel(MotionModel):
    def __init__(self, ts: float, rk4: bool = True):
        super().__init__(
            lambda s, a, t: unicycle_step(s, a, t, rk4=rk4), 3, 2, ts,
            np_fn=lambda s, a, t: unicycle_step_np(s, a, t, rk4=rk4))


class OmnidirectionalModel(MotionModel):
    def __init__(self, ts: float):
        super().__init__(omnidirectional_step, 3, 3, ts,
                         np_fn=omnidirectional_step_np)


def reciprocating_state(kt, speed, ts: float, p1, p2) -> torch.Tensor:
    """Preset back-and-forth motion between p1 and p2, starting at p1
    (reference `reciprocating_model`, motion_model.py:165-186): the position
    is a pure function of the time step.

    Args:
        kt: current time step (int or integer tensor).
        speed: linear speed along the segment (float or 0-d tensor).
    Returns:
        (3,) float32 state [x, y, theta].

    The float32 operations follow the JAX package's order: the period, the
    progress and the two weights as written there give the same rounding
    at the turnaround.
    """
    p1 = torch.as_tensor(p1, dtype=torch.float32)
    p2 = torch.as_tensor(p2, dtype=torch.float32)
    period = torch.floor(2.0 * torch.linalg.norm(p1 - p2) / speed / ts) + 1.0
    progress = torch.remainder(torch.as_tensor(kt), period) / period
    theta = torch.where(
        progress < 0.5,
        torch.atan2(p2[1] - p1[1], p2[0] - p1[0]),
        torch.atan2(p1[1] - p2[1], p1[0] - p2[0]))
    w1 = 2.0 * torch.abs(0.5 - progress)
    w2 = 2.0 * (0.5 - torch.abs(0.5 - progress))
    xy = w1 * p1 + w2 * p2
    return torch.cat([xy, theta[None]])


class ReciprocatingModel(MotionModel):
    """Preset reciprocating agent (reference motion_model.py:102-127):
    `model(kt)` returns the state at time step kt; action = (speed,)."""

    def __init__(self, ts: float, p1: tuple, p2: tuple, speed: float = 1.0):
        super().__init__(
            lambda state, action, ts_: reciprocating_state(
                state, action[0], ts_, p1, p2),
            3, 1, ts)
        self.p1, self.p2, self.speed = p1, p2, speed

    def __call__(self, kt, action=None):
        a = torch.as_tensor([self.speed] if action is None else action)
        return self.fn(kt, a, self.ts)

    def init_state(self):
        return torch.tensor([self.p1[0], self.p1[1], 0.0], dtype=torch.float32)
