"""Simulation harness: scenario presets and map loading.

The part of `dyobav_tpu.sim.harness` the batched simulation's scenario
constructors need: `scenario(index)` and `MainBase.__init__` / `_load_map`
(configurations, the pixel-to-world transform, the predictor's map channel
`ref_map`, the occupancy and geometric maps, the navigation graph).  The
per-scenario episode loop (`run`,
`run_once`, agent and interface preparation) is not ported yet and raises
NotImplementedError (ROADMAP.md, queue A item 8).
"""
from __future__ import annotations

import math
import os
import random

import numpy as np

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration, WarehouseSimConfiguration)
from ..interfaces.map_interface import MapInterface
from ..maps.png import read_png
from ..maps.transforms import ScaleOffsetReverseTransform

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_NOT_PORTED = ("the per-scenario episode loop of MainBase is not ported yet; "
               "only scenario presets and map loading are (ROADMAP.md, "
               "queue A item 8)")


def scenario(index: int):
    """The three hardcoded warehouse scenarios (main_base.py:38-70):
    (human_starts, human_paths, robot_start_point, robot_path) in sim px."""
    if index == 0:
        return ([np.array([160.0, 50.0])], [[9, 32, 16]],
                np.array([235.0, 100.0, -math.pi / 2]), [16, 32])
    if index == 1:
        return ([np.array([110.0, 20.0])], [[1, 2, 9, 32]],
                np.array([160.0, 160.0, math.pi / 2]), [12, 11, 10, 9, 8])
    if index == 2:
        return ([np.array([235.0, 0.0])], [[15, 16, 27]],
                np.array([255.0, 20.0, -math.pi / 2]), [20, 21, 22, 23])
    raise ValueError(f"Invalid scenario index: {index}")


class MainBase:
    HUMAN_SIZE = 0.2
    HUMAN_VMAX = 1.5
    HUMAN_STAGGER = 0.5

    def __init__(self, max_num_run: int = 1, max_run_time_step: int = 120,
                 scenario_index: int = 0, evaluation: bool = False,
                 data_dir: str | None = None, seed: int | None = None,
                 sim_config: WarehouseSimConfiguration | None = None,
                 config_mpc: MpcConfiguration | None = None,
                 config_robot: CircularRobotSpecification | None = None,
                 solver_config: SolverConfiguration | None = None,
                 verbose: bool = False):
        self.max_num_run = max_num_run
        self.max_run_time_step = max_run_time_step
        self.eval = evaluation
        self.vb = verbose
        self.rng = random.Random(seed)
        self.scenario_index = scenario_index
        (self.HUMAN_STARTS, self.HUMAN_PATHS,
         self.ROBOT_START_POINT, self.ROBOT_PATH) = scenario(scenario_index)

        self.sim_config = sim_config or WarehouseSimConfiguration()
        self.config_mpc = config_mpc or MpcConfiguration()
        self.config_robot = config_robot or CircularRobotSpecification()
        self.solver_config = solver_config

        self.data_dir = data_dir or os.path.join(REPO_ROOT, "data",
                                                 self.sim_config.map_dir)

        # Grayscale reference map (the predictor's map channel), if present:
        # the mean of label.png's RGB.
        label_path = os.path.join(self.data_dir, "label.png")
        self.ref_map = None
        if os.path.exists(label_path):
            rgb = read_png(label_path)[:, :, :3].astype(np.float64)
            self.ref_map = rgb.sum(axis=2) / 3.0

        sc = self.sim_config
        self.ct2real = ScaleOffsetReverseTransform(
            scale=sc.scale2real, offsetx_after=sc.corner_coords[0],
            offsety_after=sc.corner_coords[1], y_reverse=not sc.image_axis,
            y_max_before=sc.sim_height)
        self.map_extent = (
            sc.corner_coords[0],
            sc.corner_coords[0] + sc.sim_width * sc.scale2real,
            sc.corner_coords[1],
            sc.corner_coords[1] + sc.sim_height * sc.scale2real)

        self._load_map()

    def _load_map(self):
        mi = MapInterface(self.data_dir)
        self.occ_map = mi.get_occ_map_from_pgm(self.sim_config.map_file, 120,
                                               inversed_pixel=True)
        self.geo_map = mi.cvt_occ2geo(
            self.occ_map,
            inflate_margin=self.config_robot.vehicle_width
            + self.config_robot.vehicle_margin)
        self.geo_map.coords_cvt(self.ct2real)
        self.net_graph = mi.get_graph_from_json(self.sim_config.graph_file)

    def _not_ported(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    _prepare_agents = _prepare_interfaces = _not_ported
    run_one_step = run_once = run = _not_ported
