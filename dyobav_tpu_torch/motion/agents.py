"""Simulation agents: waypoint-following robot and pedestrians, the port of
`dyobav_tpu.motion.agents` (reference `src/basic_agent.py`: MovingAgent
:16-96, Human :98, Robot :103).

Numpy states on the host: omnidirectional pedestrians with random stagger,
an RK4 unicycle robot, past-trajectory buffers.  The stagger is drawn from
the `random.Random` the caller passes, the standard library's stream, so
one seed gives the JAX package's agents and these the same draws.
"""
from __future__ import annotations

import copy
import math
import random
from typing import List, Union

import numpy as np

from .models import OmnidirectionalModel, UnicycleModel


class MovingAgent:
    def __init__(self, state: np.ndarray, ts: float, radius: float = 1.0,
                 stagger: float = 0.0, rng: random.Random | None = None):
        if not isinstance(state, np.ndarray):
            raise TypeError(f"State must be numpy.ndarray, got {type(state)}.")
        self.r = radius
        self.ts = ts
        self.state = state.astype(np.float64)
        self.stagger = stagger
        self.rng = rng or random.Random()
        self.motion_model = OmnidirectionalModel(ts)
        self.past_traj: List[np.ndarray] = [self.state]
        self.with_path = False

    def set_path(self, path: List[tuple]):
        self.with_path = True
        self.path = path
        self.coming_path = copy.deepcopy(list(path))
        self.past_traj = [self.state]

    def get_next_goal(self, vmax: float) -> Union[tuple, None]:
        if not self.with_path:
            raise RuntimeError("Path is not set yet.")
        if not self.coming_path:
            return None
        dist = math.hypot(self.coming_path[0][0] - self.state[0],
                          self.coming_path[0][1] - self.state[1])
        if dist < vmax * self.ts:
            self.coming_path.pop(0)
        return self.coming_path[0] if self.coming_path else None

    def get_action(self, next_path_node: tuple, vmax: float) -> np.ndarray:
        stagger = (self.rng.choice([1, -1])
                   * self.rng.randint(0, 10) / 10 * self.stagger)
        dist = math.hypot(self.coming_path[0][0] - self.state[0],
                          self.coming_path[0][1] - self.state[1])
        dire = ((next_path_node[0] - self.state[0]) / dist,
                (next_path_node[1] - self.state[1]) / dist)
        return np.array([dire[0] * vmax + stagger, dire[1] * vmax + stagger])

    def one_step(self, action: np.ndarray):
        action = np.asarray(action, dtype=np.float64)
        if action.shape[0] < self.motion_model.action_dim:
            action = np.concatenate(
                [action,
                 np.zeros(self.motion_model.action_dim - action.shape[0])])
        self.state = np.asarray(self.motion_model(self.state, action),
                                dtype=np.float64)
        self.past_traj.append(self.state)

    def run_step(self, vmax: float) -> bool:
        next_node = self.get_next_goal(vmax)
        if next_node is None:
            return False
        self.one_step(self.get_action(next_node, vmax))
        return True

    def plot_agent(self, ax, color: str = "b", ct=None):
        import matplotlib.patches as patches
        center = ct(self.state[:2]) if ct is not None else self.state[:2]
        ax.add_patch(patches.Circle(center, self.r, color=color))


class Human(MovingAgent):
    """Omnidirectional pedestrian with stagger noise."""


class Robot(MovingAgent):
    """Unicycle robot (RK4)."""

    def __init__(self, state: np.ndarray, ts: float, radius: float,
                 rng: random.Random | None = None):
        super().__init__(state, ts, radius, 0.0, rng)
        self.motion_model = UnicycleModel(self.ts, rk4=True)

    def one_step(self, action: np.ndarray):
        action = np.asarray(action, dtype=np.float64)[:2]
        self.state = np.asarray(self.motion_model(self.state, action),
                                dtype=np.float64)
        self.past_traj.append(self.state)
