"""DWA trajectory tracker, the port of `dyobav_tpu.trackers.dwa_tracker`
(reference `pkg_dwa_tracker/trajectory_tracker.TrajectoryTracker`,
:15-355): the stateful wrapper over the batched engine of `ops.dwa`, with
the MPC tracker's run protocol.

`device` (None: the current CUDA device; raises without one) is where the
candidate search runs.  Each step's whole `DwaResult` comes back to the
host in one copy (`ops.engine.to_host`).
"""
from __future__ import annotations

import math
import timeit
from typing import List, Union

import numpy as np
import torch

from ..configs import CircularRobotSpecification, DwaConfiguration
from ..ops.dwa import FAR, DwaResult, build_dwa_engine, candidate_grid
from ..ops.engine import resolve_device, to_host
from .mpc_tracker import TrajectoryTracker as _MpcTracker


def fetch(res: DwaResult) -> DwaResult:
    """A `DwaResult` as numpy, moved to the host in one copy."""
    fields = [res.best_u, res.best_trajectory, res.min_cost,
              res.all_trajectories, res.costs, res.valid]
    flat = to_host(torch.cat([f.reshape(-1).to(res.costs.dtype)
                              for f in fields]))
    ends = np.cumsum([f.numel() for f in fields])
    parts = [p.reshape(f.shape)
             for p, f in zip(np.split(flat, ends[:-1]), fields)]
    return DwaResult(*parts[:5], valid=parts[5] > 0.5)


class TrajectoryTracker:
    def __init__(self, config: DwaConfiguration,
                 robot_specification: CircularRobotSpecification,
                 max_static_obs: int = 64, max_dyn_obs: int = 16,
                 verbose: bool = False, device=None):
        self.vb = verbose
        self.config = config
        self.robot_spec = robot_specification
        self.device = resolve_device(device)
        self.ts = config.ts
        self.ns = config.ns
        self.nu = config.nu
        self.N_hor = config.N_hor

        self.max_static_obs = max_static_obs
        self.max_dyn_obs = max_dyn_obs
        self.engine, self.grid = build_dwa_engine(
            config, robot_specification, max_static_obs, max_dyn_obs,
            device=self.device)

        self.idle = True
        self.set_work_mode(mode="work")

    def load_motion_model(self, motion_model) -> None:
        self.motion_model = motion_model

    def load_init_states(self, current_state: np.ndarray, goal_state: np.ndarray):
        if not isinstance(current_state, np.ndarray) or not isinstance(goal_state, np.ndarray):
            raise TypeError("States must be numpy arrays.")
        self.state = current_state
        self.final_goal = goal_state
        self.past_states: List[np.ndarray] = []
        self.past_actions: List[np.ndarray] = []
        self.cost_timelist: List[float] = []
        self.solver_time_timelist: List[float] = []
        self.idx_ref_traj = 0
        self.idx_ref_path = 0
        self.idle = False

    def set_work_mode(self, mode: str = "safe"):
        scale = {"aligning": 0.1, "safe": 0.2, "work": 0.8, "super": 1.0}
        if mode not in scale:
            raise ValueError(f"There is no mode called {mode}.")
        self.base_speed = self.robot_spec.lin_vel_max * scale[mode]

    def set_current_state(self, current_state: np.ndarray):
        if not isinstance(current_state, np.ndarray):
            raise TypeError("State must be a numpy array.")
        self.state = current_state

    def set_ref_trajectory(self, ref_path: List[tuple], ref_traj=None):
        self.idx_ref_path = 0
        self.idx_ref_traj = 0
        self.ref_path = ref_path
        self.ref_traj = (ref_traj if ref_traj is not None
                         else _MpcTracker.get_ref_traj(self.ts, ref_path,
                                                       self.state, self.base_speed))

    def check_termination_condition(self, state, action, final_goal) -> bool:
        if (np.allclose(state[:2], final_goal[:2], atol=0.5, rtol=0)
                and abs(action[0]) < 0.4):
            self.idle = True
            return True
        return False

    # ---------------------------------------------------------------- padding
    def _pad_static(self, static_obstacles: List[List[tuple]]) -> np.ndarray:
        """(max_static_obs, 4, 2), FAR-padded.  A polygon keeps its first 4
        vertices (the JAX package's truncation); a shorter one repeats its
        last vertex."""
        out = np.full((self.max_static_obs, 4, 2), FAR, dtype=np.float32)
        for i, obs in enumerate(static_obstacles[: self.max_static_obs]):
            poly = np.asarray(obs, dtype=np.float32)
            if poly.shape[0] >= 4:
                out[i] = poly[:4]
            else:
                out[i, :poly.shape[0]] = poly
                out[i, poly.shape[0]:] = poly[-1]
        return out

    def _pad_dynamic(self, dyn_obstacle_list) -> np.ndarray:
        """dyn_obstacle_list: list over steps (len N_hor+1) of position
        lists, or a flat list of positions (applied to step 0 only)."""
        out = np.full((self.N_hor + 1, self.max_dyn_obs, 2), FAR, np.float32)
        if dyn_obstacle_list is None:
            return out
        arr = dyn_obstacle_list
        if len(arr) and np.ndim(arr[0]) == 1:    # flat list of positions
            for j, pos in enumerate(arr[: self.max_dyn_obs]):
                out[0, j] = pos[:2]
            return out
        for t, positions in enumerate(arr[: self.N_hor + 1]):
            for j, pos in enumerate(positions[: self.max_dyn_obs]):
                out[t, j] = np.asarray(pos, np.float32)[:2]
        return out

    # -------------------------------------------------------------------- run
    def run_step(self, ref_path: List[tuple],
                 static_obstacles: List[List[tuple]],
                 dynamic_obstacles: Union[List[tuple], List[List[tuple]], None],
                 mode: str = "work"):
        """One DWA step; returns
        (best_u, best_trajectory, min_cost, all_trajectories, ok_trajectories,
        ok_cost), the reference's return arity (trajectory_tracker.py:304-355).
        """
        self.set_work_mode(mode)
        dist_to_goal = math.hypot(self.state[0] - self.final_goal[0],
                                  self.state[1] - self.final_goal[1])
        if dist_to_goal < self.base_speed * self.N_hor * self.ts:
            self.base_speed = min(2 * dist_to_goal / self.N_hor / self.ts,
                                  self.robot_spec.lin_vel_max)

        last_u = self.past_actions[-1] if self.past_actions else np.zeros(self.nu)
        ref = np.asarray(ref_path, dtype=np.float32)[:, :2]

        start = timeit.default_timer()
        u_all, valid_mask = candidate_grid(self.config, self.robot_spec,
                                           self.grid, np.asarray(last_u))
        res = fetch(self.engine(
            np.asarray(self.state, np.float32), u_all, valid_mask,
            np.asarray(self.final_goal[:2], np.float32), ref,
            np.float32(self.base_speed), self._pad_static(static_obstacles),
            self._pad_dynamic(dynamic_obstacles)))
        best_u, best_traj, costs, valid = (res.best_u, res.best_trajectory,
                                           res.costs, res.valid)
        solver_time = timeit.default_timer() - start

        all_traj = [t for t, v in zip(res.all_trajectories, valid) if v]
        ok_mask = valid & np.isfinite(costs)
        ok_traj = [t for t, m in zip(res.all_trajectories, ok_mask) if m]
        ok_cost = costs[ok_mask].tolist()

        self.state = best_traj[0, :]
        self.past_states.append(self.state)
        self.past_actions.append(best_u)
        self.cost_timelist.append(float(res.min_cost))
        self.solver_time_timelist.append(solver_time)

        return best_u, best_traj, float(res.min_cost), all_traj, ok_traj, ok_cost
