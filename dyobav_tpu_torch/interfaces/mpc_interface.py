"""MPC tracker adapter, the port of `dyobav_tpu.interfaces.mpc_interface`
(reference `interfaces/mpc_interface.MpcInterface`, mpc_interface.py:20-107):
turns the geometric map and the predicted-obstacle lists into the solver's
flat constraint parameters and drives the tracker with the uniform
`set_current_state` / `update_global_path` / `run_step` protocol.

`device` (None: the current CUDA device; raises without one) is where the
tracker's solves run; the constraint assembly is numpy on the host.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration)
from ..maps.geometric import GeometricMap
from ..motion.models import UnicycleModel
from ..trackers.mpc_tracker import TrajectoryTracker
from ..utils import geometry as geo


def _resolve_cfgs(config, robot_config):
    if isinstance(config, str):
        return (MpcConfiguration.from_yaml(config),
                CircularRobotSpecification.from_yaml(config))
    return ((config or MpcConfiguration()),
            (robot_config or CircularRobotSpecification()))


class MpcInterface:
    def __init__(self, config: MpcConfiguration | str | None,
                 current_state: np.ndarray, geo_map: GeometricMap,
                 verbose: bool = False,
                 robot_config: CircularRobotSpecification | None = None,
                 solver_config: SolverConfiguration | None = None,
                 use_multistart: bool = True, device=None):
        self.config_mpc, self.config_robot = _resolve_cfgs(config,
                                                           robot_config)
        self.traj_tracker = TrajectoryTracker(
            self.config_mpc, self.config_robot, solver_config,
            use_multistart=use_multistart, verbose=verbose, device=device)
        self.traj_tracker.load_motion_model(
            UnicycleModel(self.config_robot.ts))
        self.state = current_state
        self.geo_map = geo_map
        self.prepared = False

    def set_current_state(self, current_state: np.ndarray):
        self.state = current_state
        self.traj_tracker.set_current_state(current_state)

    def update_map(self, geo_map: GeometricMap):
        self.geo_map = geo_map

    def update_global_path(self, new_global_path: List[tuple]):
        self.traj_tracker.load_init_states(self.state,
                                           np.array(new_global_path[-1]))
        self.traj_tracker.set_work_mode("work")
        self.traj_tracker.set_ref_trajectory(new_global_path)
        self.ref_path = new_global_path
        self.ref_traj = self.traj_tracker.ref_traj
        self.base_speed = self.traj_tracker.base_speed
        self.prepared = True

    def run_step(self, mode, full_dyn_obstacle_list: list | None = None,
                 map_updated: bool = True
                 ) -> Tuple[List[np.ndarray], List[np.ndarray], float,
                            List[List[tuple]], np.ndarray]:
        """Returns (actions, pred_states, cost, closest_obstacle_list,
        current_refs), the reference arity (mpc_interface.py:52-70)."""
        if not self.prepared:
            raise ValueError("MpcInterface is not prepared. "
                             "Call update_global_path() first.")
        stc_constraints, closest_obstacle_list = self.get_stc_constraints()
        dyn_constraints = self.get_dyn_constraints(full_dyn_obstacle_list)
        actions, self.pred_states, current_refs, cost = \
            self.traj_tracker.run_step(stc_constraints, dyn_constraints,
                                       mode=mode)
        self.state = self.traj_tracker.state
        return (actions, self.pred_states, cost, closest_obstacle_list,
                current_refs)

    def get_stc_constraints(self) -> Tuple[list, List[List[tuple]]]:
        n_stc_obs = self.config_mpc.Nstcobs * self.config_mpc.nstcobs
        stc_constraints = [0.0] * n_stc_obs
        map_obstacle_list = self.get_closest_n_stc_obstacles()
        for i, obs in enumerate(map_obstacle_list):
            b, a0, a1 = geo.polygon_halfspace_representation(np.array(obs))
            n_edges = self.config_mpc.nstcobs // 3
            row = (list(b[:n_edges]) + [0.0] * max(0, n_edges - len(b))
                   + list(a0[:n_edges]) + [0.0] * max(0, n_edges - len(a0))
                   + list(a1[:n_edges]) + [0.0] * max(0, n_edges - len(a1)))
            stc_constraints[i * self.config_mpc.nstcobs:
                            (i + 1) * self.config_mpc.nstcobs] = row
        return stc_constraints, map_obstacle_list

    def get_dyn_constraints(self, full_dyn_obstacle_list=None) -> list:
        params_per = (self.config_mpc.N_hor + 1) * self.config_mpc.ndynobs
        dyn_constraints = [0.0] * self.config_mpc.Ndynobs * params_per
        if full_dyn_obstacle_list is not None:
            for i, dyn_obstacle in enumerate(
                    full_dyn_obstacle_list[: self.config_mpc.Ndynobs]):
                flat = list(itertools.chain(*dyn_obstacle))
                dyn_constraints[i * params_per:(i + 1) * params_per] = flat
        return dyn_constraints

    def get_closest_n_stc_obstacles(self) -> List[List[tuple]]:
        full_obs_list = self.geo_map.processed_obstacle_list
        dists_to_obs = []
        for obs in full_obs_list:
            a = np.array(obs)
            b = np.vstack([a[1:], a[:1]])
            d = geo.lineseg_dists(np.asarray(self.state[None, :2]), a, b)
            dists_to_obs.append(float(d.min()))
        n = self.config_mpc.Nstcobs
        if len(full_obs_list) <= n:
            return list(full_obs_list)
        selected = np.argpartition(dists_to_obs, n)[:n]
        return [full_obs_list[i] for i in selected]
