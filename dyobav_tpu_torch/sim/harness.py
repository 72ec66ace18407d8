"""Simulation / evaluation harness, the port of `dyobav_tpu.sim.harness`.

The counterpart of the reference's `src/main_base.py` (MainBase :73-506):
scenario definitions, agent and interface preparation, per-step
orchestration of predict → cluster → constrain → solve → step → metrics,
and the episode loop with headless metric aggregation.  The batched
simulation's scenario constructors use only `scenario(index)` and the map
loading of `MainBase.__init__`.

The trackers (the MPC solves or the DWA search) and the SWTA net of the
mmp predictor run on `device`: None resolves to the current CUDA device
when the interfaces are prepared and raises without one; pass
`device="cpu"` to run on the CPU.  The cvmp and kfmp predictors run on the
host.
"""
from __future__ import annotations

import math
import os
import random
import timeit
from typing import List, Tuple, Union

import numpy as np

from ..configs import (CircularRobotSpecification, DwaConfiguration,
                       MpcConfiguration, SolverConfiguration,
                       WarehouseSimConfiguration)
from ..interfaces.dwa_interface import DwaInterface
from ..interfaces.map_interface import MapInterface
from ..interfaces.mpc_interface import MpcInterface
from ..maps.png import read_png
from ..maps.transforms import ScaleOffsetReverseTransform
from ..motion.agents import Human, Robot
from ..ops.cluster import fit_cluster2gaussian, fit_dbscan_np
from ..ops.engine import resolve_device
from ..predictors.cvmp import CvmpInterface
from ..predictors.kfmp import KfmpInterface
from . import metrics

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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
                 config_dwa: DwaConfiguration | None = None,
                 solver_config: SolverConfiguration | None = None,
                 mmp_checkpoint: str | None = None,
                 verbose: bool = False, device=None):
        self.max_num_run = max_num_run
        self.mmp_checkpoint = mmp_checkpoint
        self.max_run_time_step = max_run_time_step
        self.eval = evaluation
        self.vb = verbose
        self.device = device
        self.rng = random.Random(seed)
        self.scenario_index = scenario_index
        (self.HUMAN_STARTS, self.HUMAN_PATHS,
         self.ROBOT_START_POINT, self.ROBOT_PATH) = scenario(scenario_index)

        self.sim_config = sim_config or WarehouseSimConfiguration()
        self.config_mpc = config_mpc or MpcConfiguration()
        self.config_robot = config_robot or CircularRobotSpecification()
        self.config_dwa = config_dwa or DwaConfiguration()
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
        if evaluation:
            self._load_metrics()

    # ------------------------------------------------------------------ setup
    def _load_metrics(self):
        self.collision_results: List[bool] = []
        self.smoothness_results: List[list] = []
        self.clearance_results: List[float] = []
        self.clearance_dyn_results: List[float] = []
        self.deviation_results: List[list] = []
        self.solve_time_list: List[float] = []
        self.predict_time_list: List[float] = []
        self.solver_status_list: List[str] = []
        # Per-run triage (additive over the reference's lumped fail flag):
        # outcome type, steps used, distress escalations.
        self.outcome_results: List[dict] = []

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

    def _prepare_agents(self) -> Tuple[Robot, List[Human]]:
        robot_start = np.array(self.ct2real(self.ROBOT_START_POINT))
        human_starts = [np.array(self.ct2real(h)) for h in self.HUMAN_STARTS]
        robot_path = [tuple(self.ct2real(list(x))) for x in
                      self.net_graph.return_given_nodelist(self.ROBOT_PATH)]
        human_paths = [[tuple(self.ct2real(list(x)))
                        for x in self.net_graph.return_given_nodelist(p)]
                       for p in self.HUMAN_PATHS]

        robot = Robot(state=robot_start, ts=self.config_robot.ts,
                      radius=self.config_robot.vehicle_width / 2, rng=self.rng)
        robot.set_path(robot_path)
        humans = [Human(np.concatenate([h, [0.0]]), self.config_robot.ts,
                        radius=self.HUMAN_SIZE, stagger=self.HUMAN_STAGGER,
                        rng=self.rng)
                  for h in human_starts]
        for human, path in zip(humans, human_paths):
            human.set_path(path)
        return robot, humans

    def _prepare_interfaces(self, robot: Robot, predictor_type: str | None,
                            tracker_type: str):
        """Build only what the requested (tracker, predictor) pair needs, on
        the harness's device."""
        if tracker_type not in ("mpc", "dwa"):
            raise ValueError("Tracker type is not supported.")
        device = resolve_device(self.device)
        if tracker_type == "mpc":
            tracker = MpcInterface(self.config_mpc, robot.state, self.geo_map,
                                   robot_config=self.config_robot,
                                   solver_config=self.solver_config,
                                   verbose=self.vb, device=device)
        else:
            tracker = DwaInterface(self.config_dwa, robot.state, self.geo_map,
                                   robot_config=self.config_robot,
                                   verbose=self.vb, device=device)
        tracker.update_global_path(robot.path)

        predictor = None
        if predictor_type == "kfmp":
            predictor = KfmpInterface(self.config_mpc, Q=np.eye(4),
                                      R=np.eye(2))
        elif predictor_type == "cvmp":
            predictor = CvmpInterface(self.config_mpc)
        elif predictor_type == "mmp":
            from ..predictors.mmp import MmpInterface
            predictor = MmpInterface(checkpoint_path=self.mmp_checkpoint,
                                     device=device)
        elif predictor_type is not None:
            raise ValueError("Predictor type is not supported.")
        return tracker, predictor

    # ------------------------------------------------------------- prediction
    def run_baseline_prediction(self, interface, human_list: List[Human]):
        """KF/CV predictor fan-out over humans (main_base.py:210-264)."""
        curr_mu = [h.state[:2].tolist() for h in human_list]
        curr_std = [[self.HUMAN_SIZE, self.HUMAN_SIZE] for _ in human_list]
        mu_list_list = None
        std_list_list = None
        for i, human in enumerate(human_list):
            past = [x.tolist()[:2] for x in human.past_traj]
            positions, uncertainty = interface.get_motion_prediction(past)
            if i == 0:
                mu_list_list = [[p] for p in positions]
                std_list_list = [[s] for s in uncertainty]
            else:
                for t, (p, s) in enumerate(zip(positions, uncertainty)):
                    mu_list_list[t].append(p)
                    std_list_list[t].append(s)
        mu_list_list.insert(0, curr_mu)
        std_list_list.insert(0, curr_std)
        return mu_list_list, std_list_list

    def run_wta_prediction(self, interface, human_list: List[Human]):
        """SWTA prediction + CGF (main_base.py:175-208): the net on the
        interface's device, the clustering on the host."""
        curr_mu = [h.state[:2].tolist() for h in human_list]
        curr_std = [[self.HUMAN_SIZE, self.HUMAN_SIZE] for _ in human_list]
        hypos_list_all = None
        for i, human in enumerate(human_list):
            past_nn = [self.ct2real(x.tolist(), False)[:2]
                       for x in human.past_traj]
            hypos = interface.get_motion_prediction(
                past_nn, self.ref_map, self.config_mpc.N_hor,
                self.sim_config.scale2nn, batch_size=5)
            if i == 0:
                hypos_list_all = hypos
            else:
                hypos_list_all = [np.concatenate((x, y), axis=0)
                                  for x, y in zip(hypos_list_all, hypos)]
        hypos_list_all = [self.ct2real.cvt_coords(x[:, 0], x[:, 1])
                          for x in hypos_list_all]
        hypos_clusters_list = []
        mu_list_list = [curr_mu]
        std_list_list = [curr_std]
        for t in range(self.config_mpc.N_hor):
            clusters = fit_dbscan_np(hypos_list_all[t], eps=1.0, min_sample=2)
            mu_list, std_list = fit_cluster2gaussian(clusters, enlarge=2,
                                                     extra_margin=0)
            hypos_clusters_list.append(clusters)
            mu_list_list.append([list(m) for m in mu_list])
            std_list_list.append([list(s) for s in std_list])
        return mu_list_list, std_list_list, hypos_clusters_list

    # ------------------------------------------------------------------- step
    def run_one_step(self, robot: Robot, human_list: List[Human],
                     tracker_interface: Union[MpcInterface, DwaInterface],
                     predictor_interface=None, verbose: bool = False):
        """One simulation step (main_base.py:267-346)."""
        mmp_start = timeit.default_timer()
        hypos_clusters_list = None
        is_mpc = isinstance(tracker_interface, MpcInterface)
        if predictor_interface is None:
            # No predictor: humans enter as fixed-position obstacles (the
            # reference feeds raw states here, which its MPC path cannot
            # consume; normalized to the MPC tracker's expected shape).  The
            # DWA takes their flat positions.
            if is_mpc:
                r = self.HUMAN_SIZE
                dyn_obs_list = [[[h.state[0], h.state[1], r, r, 0, 1]]
                                * (self.config_mpc.N_hor + 1)
                                for h in human_list]
            else:
                dyn_obs_list = [h.state[:2].tolist() for h in human_list]
            mu_list_list = std_list_list = None
        elif isinstance(predictor_interface, (KfmpInterface, CvmpInterface)):
            mu_list_list, std_list_list = self.run_baseline_prediction(
                predictor_interface, human_list)
        else:
            mu_list_list, std_list_list, hypos_clusters_list = \
                self.run_wta_prediction(predictor_interface, human_list)
        mmp_time = timeit.default_timer() - mmp_start
        self._last_predict_time = mmp_time

        if predictor_interface is not None and is_mpc:
            n_obs = max(len(m) for m in mu_list_list)
            dyn_obs_list = [[[0, 0, 0, 0, 0, 1]] * (self.config_mpc.N_hor + 1)
                            for _ in range(n_obs)]
            for Tt, (mus, stds) in enumerate(zip(mu_list_list,
                                                 std_list_list)):
                for Nn, (mu, std) in enumerate(zip(mus, stds)):
                    dyn_obs_list[Nn][Tt] = [mu[0], mu[1], std[0], std[1], 0, 1]
        elif predictor_interface is not None:
            # The DWA scores its rollout against the predicted positions of
            # every step.
            dyn_obs_list = mu_list_list

        tracker_interface.set_current_state(robot.state)
        start = timeit.default_timer()
        if is_mpc:
            actions, pred_states, cost, the_obs_list, current_refs = \
                tracker_interface.run_step("work", dyn_obs_list,
                                           map_updated=True)
            action = actions[0]
            others = [current_refs]
        else:
            the_obs_list = None
            action, pred_states, cost, all_traj, ok_traj, ok_cost = \
                tracker_interface.run_step("work", dyn_obs_list)
            others = [all_traj, ok_traj, ok_cost]
        solve_time = timeit.default_timer() - start

        if action[0] < 0:          # no-backward safety override (:320-321)
            action = np.zeros_like(np.asarray(action))
        robot.one_step(action=action)
        for human in human_list:
            human.run_step(self.HUMAN_VMAX)

        static_obstacles = self.geo_map.processed_obstacle_list
        dynamic_obstacles = [h.state[:2].tolist() for h in human_list]
        dyn_clearance = metrics.calc_minimal_dynamic_obstacle_distance(
            robot.state, dynamic_obstacles)
        collision = metrics.check_collision(robot.state, static_obstacles,
                                            dynamic_obstacles)
        if collision:
            # Cause split for outcome triage: static wall squeeze or
            # pedestrian proximity.
            self._last_collision_cause = (
                "static" if metrics.check_collision(robot.state,
                                                    static_obstacles, [])
                else "dynamic")
        complete = (False if collision else
                    tracker_interface.traj_tracker.check_termination_condition(
                        robot.state, action, robot.path[-1]))

        if verbose:
            print(f"Actions:({action[0]:.4f}, {action[1]:.4f}); "
                  f"Robot state: {[round(float(x), 4) for x in robot.state]}; "
                  f"Cost {cost:.4f}; Pred time {mmp_time*1000:.1f} ms; "
                  f"Solve time {solve_time*1000:.1f} ms")

        if self.eval:
            return collision, complete, solve_time, dyn_clearance
        return (action, pred_states, cost, mu_list_list, std_list_list,
                hypos_clusters_list, the_obs_list, others)

    # ------------------------------------------------------------------- runs
    def run_once(self, robot, human_list, tracker_interface,
                 predictor_interface=None, num_run: int = 1, plotter=None):
        """One episode.  With `verbose` every step prints a line, in an
        evaluation too (a step of one robot takes seconds on the card);
        a demo renders each step on `plotter` (`sim.plotter.Plotter`)."""
        dyn_clearance_temp = []
        collision = complete = False
        for kt in range(self.max_run_time_step):
            if self.eval:
                collision, complete, solve_time, dyn_clearance = \
                    self.run_one_step(robot, human_list, tracker_interface,
                                      predictor_interface, verbose=self.vb)
                self.solve_time_list.append(solve_time)
                self.predict_time_list.append(self._last_predict_time)
                dyn_clearance_temp.append(dyn_clearance)
                if collision:
                    self.collision_results.append(True)
                    break
                if complete:
                    self.collision_results.append(False)
                    break
            else:
                out = self.run_one_step(robot, human_list, tracker_interface,
                                        predictor_interface, verbose=self.vb)
                if plotter is not None:
                    (action, pred_states, cost, mu_list_list, std_list_list,
                     _, the_obs_list, others) = out
                    plotter.render_step(kt, self, robot, human_list,
                                        tracker_interface, action, cost,
                                        pred_states, mu_list_list,
                                        std_list_list, the_obs_list, others)
                if tracker_interface.traj_tracker.idle:
                    break

        if not self.eval:
            return
        if not complete and not collision:
            self.collision_results.append(True)     # timeout counts as failure
        tracker = tracker_interface.traj_tracker
        # The DWA tracker neither escalates nor reports solver statuses.
        statuses = getattr(tracker, "solver_status_timelist", [])
        self.outcome_results.append({
            "outcome": ("collision" if collision
                        else "success" if complete else "timeout"),
            **({"collision_cause": getattr(self, "_last_collision_cause",
                                           None)} if collision else {}),
            "steps": kt + 1,
            "escalations": getattr(tracker, "escalation_count", 0),
            "bad_statuses": sum(s != "Converged" for s in statuses),
        })
        # Per-step solver exit statuses (MPC tracker only): the production
        # convergence rate (multistart + distress escalation) beside the
        # eval metrics.
        self.solver_status_list += statuses

        if not self.collision_results[-1]:
            self.smoothness_results.append(metrics.calc_action_smoothness(
                tracker.past_actions))
            self.clearance_results.append(
                metrics.calc_minimal_obstacle_distance(
                    [s[:2] for s in robot.past_traj],
                    self.geo_map.processed_obstacle_list))
            self.deviation_results.append(metrics.calc_deviation_distance(
                ref_traj=tracker_interface.ref_traj,
                actual_traj=[s[:2] for s in robot.past_traj]))
            self.clearance_dyn_results.append(min(dyn_clearance_temp))

    def run(self, tracker_type: str, predictor_type: str | None = None,
            plotter=None):
        tracker_type = tracker_type.lower()
        predictor_type = predictor_type.lower() if predictor_type else None
        n_runs = self.max_num_run if self.eval else 1
        for rep in range(n_runs):
            robot, human_list = self._prepare_agents()
            tracker_intf, predictor_intf = self._prepare_interfaces(
                robot, predictor_type, tracker_type)
            self.run_once(robot, human_list, tracker_intf, predictor_intf,
                          rep, plotter=plotter)
            # The last episode's agents and interfaces, for the caller.
            self.episode = (robot, human_list, tracker_intf, predictor_intf)
            if self.eval:
                print(f"\rRun {rep + 1}/{n_runs} done; "
                      f"result={'fail' if self.collision_results[-1] else 'ok'}")

    def results_summary(self) -> dict:
        """Aggregate evaluation metrics (main_base.py:483-506)."""
        if not self.eval or not self.collision_results:
            return {}
        solve = np.array(self.solve_time_list[10:] or self.solve_time_list)
        out = {
            "solve_time_mean_s": float(np.mean(solve)),
            "solve_time_max_s": float(np.max(solve)),
            **({"converged_rate": float(np.mean(
                [s == "Converged" for s in self.solver_status_list]))}
               if self.solver_status_list else {}),
            "success_rate": float(
                (len(self.collision_results) - sum(self.collision_results))
                / len(self.collision_results)),
            "outcomes": self.outcome_results,
        }
        if self.smoothness_results:
            out["smoothness_mean"] = np.mean(
                np.array(self.smoothness_results), axis=0).tolist()
            out["clearance_mean"] = float(np.mean(self.clearance_results))
            out["clearance_dyn_mean"] = float(np.mean(
                self.clearance_dyn_results))
            dev = np.array(self.deviation_results)
            out["deviation_mean"] = float(np.mean(dev[:, 0]))
            out["deviation_std"] = float(np.std(dev[:, 0]))
            out["deviation_max"] = float(np.max(dev[:, 1]))
        return out

    def print_results(self):
        summary = self.results_summary()
        if not summary:
            return
        print("=" * 50)
        print("Solve time mean:", round(summary["solve_time_mean_s"], 3))
        print("Solve time max:", round(summary["solve_time_max_s"], 3))
        print("Success rate:", summary["success_rate"])
        if "smoothness_mean" in summary:
            print("Smoothness mean:", summary["smoothness_mean"])
            print("Clearance mean:", round(summary["clearance_mean"], 3))
            print("Clearance mean (dyn):",
                  round(summary["clearance_dyn_mean"], 3))
            print("Deviation mean:", round(summary["deviation_mean"], 3))
            print("Deviation std:", round(summary["deviation_std"], 3))
            print("Deviation max:", round(summary["deviation_max"], 3))
        print("=" * 50)
