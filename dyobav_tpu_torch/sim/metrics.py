"""Evaluation metrics, the port of `dyobav_tpu.sim.metrics` (reference
`src/main_pre.py:20-53`): collision check, action smoothness, static and
dynamic clearance, path deviation, on the port's own host geometry.
"""
from __future__ import annotations

import math
import statistics
from typing import List

import numpy as np

from ..utils.geometry import point_in_polygon, polygon_distance

HUMAN_SIZE = 0.2


def check_collision(state: np.ndarray, static_obstacles: List[List[tuple]],
                    dynamic_obstacles: List[tuple]) -> bool:
    pos = np.asarray(state[:2], dtype=np.float64)
    for obstacle in static_obstacles:
        if point_in_polygon(pos, np.asarray(obstacle, dtype=np.float64)):
            return True
    for obstacle in dynamic_obstacles:
        if math.hypot(pos[0] - obstacle[0], pos[1] - obstacle[1]) <= HUMAN_SIZE:
            return True
    return False


def calc_action_smoothness(action_list: List[np.ndarray]) -> List[float]:
    actions = np.asarray(action_list, dtype=np.float64)
    return [float(statistics.mean(np.abs(np.diff(actions[:, 0], n=2)))),
            float(statistics.mean(np.abs(np.diff(actions[:, 1], n=2))))]


def calc_minimal_obstacle_distance(trajectory: List[tuple],
                                   obstacles: List[List[tuple]]) -> float:
    polys = [np.asarray(obs, dtype=np.float64) for obs in obstacles]
    return min(min(polygon_distance(np.asarray(pos[:2], dtype=np.float64),
                                    poly)
                   for poly in polys)
               for pos in trajectory)


def calc_minimal_dynamic_obstacle_distance(state: np.ndarray,
                                           obstacles: List[tuple]) -> float:
    return min(float(np.linalg.norm(np.asarray(state[:2])
                                    - np.asarray(obstacle[:2])))
               for obstacle in obstacles)


def calc_deviation_distance(ref_traj: List[tuple],
                            actual_traj: List[tuple]) -> List[float]:
    ref = np.asarray([r[:2] for r in ref_traj], dtype=np.float64)
    devs = []
    for pos in actual_traj:
        d = np.hypot(ref[:, 0] - pos[0], ref[:, 1] - pos[1])
        devs.append(float(d.min()))
    return [float(statistics.mean(devs)), float(max(devs))]
