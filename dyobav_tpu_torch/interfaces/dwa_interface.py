"""DWA tracker adapter, the port of `dyobav_tpu.interfaces.dwa_interface`
(reference `interfaces/dwa_interface.DwaInterface`, dwa_interface.py:20-69).

`device` (None: the current CUDA device; raises without one) is where the
tracker's candidate search runs.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..configs import CircularRobotSpecification, DwaConfiguration
from ..maps.geometric import GeometricMap
from ..motion.models import UnicycleModel
from ..trackers.dwa_tracker import TrajectoryTracker


class DwaInterface:
    def __init__(self, config: DwaConfiguration | str | None,
                 current_state: np.ndarray, geo_map: GeometricMap,
                 verbose: bool = False,
                 robot_config: CircularRobotSpecification | None = None,
                 device=None):
        if isinstance(config, str):
            self.config_dwa = DwaConfiguration.from_yaml(config)
            self.config_robot = CircularRobotSpecification.from_yaml(config)
        else:
            self.config_dwa = config or DwaConfiguration()
            self.config_robot = robot_config or CircularRobotSpecification()
        self.traj_tracker = TrajectoryTracker(self.config_dwa, self.config_robot,
                                              verbose=verbose, device=device)
        self.traj_tracker.load_motion_model(UnicycleModel(self.config_robot.ts))
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

    def run_step(self, mode, dyn_obstacle_list=None, map_updated=None
                 ) -> Tuple[np.ndarray, np.ndarray, float, List, List, List]:
        if not self.prepared:
            raise ValueError("DwaInterface is not prepared. "
                             "Call update_global_path() first.")
        static_obstacles = self.geo_map.processed_obstacle_list
        action, self.pred_states, cost, all_traj, ok_traj, ok_cost = \
            self.traj_tracker.run_step(self.ref_path, static_obstacles,
                                       dyn_obstacle_list, mode=mode)
        self.state = self.traj_tracker.state
        return action, self.pred_states, cost, all_traj, ok_traj, ok_cost
