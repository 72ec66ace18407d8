"""Unicycle kinematics in PyTorch (L1), the port of `dyobav_tpu.motion.models`.

state = (x, y, theta), action = (v, omega).  The functions take one state
and one action; batch them with `torch.func.vmap`.
"""
from __future__ import annotations

import numpy as np
import torch


def unicycle_derivative(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    v, w = action[0], action[1]
    return torch.stack([v * torch.cos(state[2]), v * torch.sin(state[2]), w])


def unicycle_step(state: torch.Tensor, action: torch.Tensor, ts: float,
                  rk4: bool = True) -> torch.Tensor:
    """Unicycle kinematics, RK4-integrated by default; the action is held
    constant across the RK4 sub-steps, as in the reference."""
    if rk4:
        k1 = ts * unicycle_derivative(state, action)
        k2 = ts * unicycle_derivative(state + 0.5 * k1, action)
        k3 = ts * unicycle_derivative(state + 0.5 * k2, action)
        k4 = ts * unicycle_derivative(state + k3, action)
        return state + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    return state + ts * unicycle_derivative(state, action)


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
