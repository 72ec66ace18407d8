"""Host-side scenario tensor preparation for the batched simulator, the
port of `dyobav_tpu.sim.scenarios`.

Builds fixed-size `sim.batch.Scenario`s from the warehouse map: either the
reference's three hardcoded scenes or randomized (start, goal,
pedestrian-seed) sweeps over the navigation graph.  The fields are numpy
arrays (float32 / int32, the JAX package's values exactly, from the same
seed); pass `device` to get tensors there, or hand the Scenario to
`build_batch_sim`'s `run`, which moves it.  The fleet constructors are not
ported yet (ROADMAP.md, queue A item 10).
"""
from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np

from ..trackers.mpc_tracker import TrajectoryTracker
from ..utils.geometry import polygon_halfspace_representation
from .batch import FAR_COORD, Scenario, scenario_to_device
from .harness import MainBase, scenario as preset_scenario

_FLEET = ("the fleet scenario constructors are not ported yet (ROADMAP.md, "
          "queue A item 10)")


def _halfspace_tensor(obstacles: List[List[tuple]], n_edges: int,
                      max_obs: int) -> tuple:
    """All obstacles -> (max_obs, 3*n_edges) halfspaces + (max_obs, 4, 2)
    polygons, FAR-padded so padded slots are inert."""
    stc = np.zeros((max_obs, 3 * n_edges), np.float32)
    polys = np.full((max_obs, 4, 2), FAR_COORD, np.float32)
    for i, obs in enumerate(obstacles[:max_obs]):
        arr = np.asarray(obs, np.float64)
        b, a0, a1 = polygon_halfspace_representation(arr)
        stc[i, :min(n_edges, len(b))] = b[:n_edges]
        stc[i, n_edges:n_edges + min(n_edges, len(a0))] = a0[:n_edges]
        stc[i, 2 * n_edges:2 * n_edges + min(n_edges, len(a1))] = a1[:n_edges]
        if arr.shape[0] >= 4:
            polys[i] = arr[:4]
        else:
            polys[i, :arr.shape[0]] = arr
            polys[i, arr.shape[0]:] = arr[-1]
    return stc, polys


def build_scenario(base: MainBase, scenario_index: int | None = None,
                   robot_path_nodes: Sequence[int] | None = None,
                   human_path_nodes: Sequence[Sequence[int]] | None = None,
                   robot_start: np.ndarray | None = None,
                   human_starts: Sequence[np.ndarray] | None = None,
                   ref_pad: int = 256, wp_pad: int = 8,
                   max_obs: int = 64, device=None) -> Scenario:
    """One Scenario from a MainBase-loaded map (world coordinates)."""
    cfg = base.config_mpc
    robot_cfg = base.config_robot
    if scenario_index is not None:
        h_starts_px, h_paths, r_start_px, r_path = preset_scenario(scenario_index)
        robot_start = np.array(base.ct2real(r_start_px))
        human_starts = [np.array(base.ct2real(h))[:2] for h in h_starts_px]
        robot_path_nodes = r_path
        human_path_nodes = h_paths

    robot_path = [tuple(base.ct2real(list(x)))
                  for x in base.net_graph.return_given_nodelist(robot_path_nodes)]
    human_paths = [[tuple(base.ct2real(list(x)))
                    for x in base.net_graph.return_given_nodelist(p)]
                   for p in human_path_nodes]

    base_speed = robot_cfg.lin_vel_max * 0.8
    ref = TrajectoryTracker.get_ref_traj(cfg.ts, robot_path, robot_start,
                                         base_speed)
    ref_arr = np.zeros((ref_pad, 3), np.float32)
    n_ref = min(len(ref), ref_pad)
    ref_arr[:n_ref] = np.asarray(ref[:n_ref], np.float32)
    ref_arr[n_ref:] = ref_arr[n_ref - 1]

    stc, polys = _halfspace_tensor(base.geo_map.processed_obstacle_list,
                                   cfg.nstcobs // 3, max_obs)

    H = len(human_starts)
    paths_arr = np.full((H, wp_pad, 2), FAR_COORD, np.float32)
    path_len = np.zeros((H,), np.int32)
    for i, path in enumerate(human_paths):
        L = min(len(path), wp_pad)
        paths_arr[i, :L] = np.asarray(path[:L], np.float32)
        paths_arr[i, L:] = paths_arr[i, L - 1]
        path_len[i] = L

    goal = np.array([robot_path[-1][0], robot_path[-1][1], 0.0], np.float32)
    sc = Scenario(
        robot_start=np.asarray(robot_start, np.float32), goal=goal,
        ref_traj=ref_arr, ref_len=np.asarray(n_ref, np.int32),
        all_stc=stc, all_polys=polys,
        human_starts=np.asarray(human_starts, np.float32),
        human_paths=paths_arr, human_path_len=path_len)
    return sc if device is None else scenario_to_device(sc, device)


def _random_id_walk(rng, net_graph, length: int,
                    max_turn_deg: float | None = None) -> list:
    """Random non-revisiting graph walk; with `max_turn_deg`, successive
    segments may turn by at most that angle.  Warehouse schedules command
    forward-progress routes, and near-reversal turns are kinematically
    untrackable for the unicycle (ang_vel_max 0.5 rad/s)."""
    nodes = list(net_graph.nodes)
    coord = lambda i: np.asarray(net_graph.get_node_coord(i), np.float64)
    ids = [rng.choice(nodes)]
    while len(ids) <= length:
        nbrs = [x for x in net_graph.adj[ids[-1]] if x not in ids]
        if max_turn_deg is not None and len(ids) >= 2:
            v1 = coord(ids[-1]) - coord(ids[-2])

            def turn_ok(nid):
                v2 = coord(nid) - coord(ids[-1])
                denom = max(float(np.linalg.norm(v1) * np.linalg.norm(v2)),
                            1e-9)
                c = float(np.dot(v1, v2)) / denom
                return math.degrees(math.acos(min(1.0, max(-1.0, c)))) \
                    <= max_turn_deg
            nbrs = [x for x in nbrs if turn_ok(x)]
        if not nbrs:
            break
        ids.append(rng.choice(nbrs))
    return ids


def random_scenarios(base: MainBase, n: int, n_humans: int = 1,
                     seed: int = 0, min_path_nodes: int = 2,
                     walk_len: int = 3, max_turn_deg: float = 120.0,
                     device=None, **kw) -> Scenario:
    """A batch of randomized (start, goal, pedestrian) scenarios stacked
    into one Scenario with a leading batch axis.

    Robot walks are turn-limited to `max_turn_deg` (None disables);
    pedestrian walks are unconstrained (omnidirectional model)."""
    rng = random.Random(seed)

    scenarios = []
    attempts = 0
    while len(scenarios) < n and attempts < 20 * n:
        attempts += 1
        r_ids = _random_id_walk(rng, base.net_graph, walk_len, max_turn_deg)
        if len(r_ids) < max(2, min_path_nodes):
            continue
        h_paths = []
        h_starts = []
        for _ in range(n_humans):
            h_ids = _random_id_walk(rng, base.net_graph, walk_len)
            h_paths.append(h_ids)
            x, y = base.net_graph.get_node_coord(h_ids[0])
            h_starts.append(np.array(base.ct2real([x, y]))[:2])
        sx, sy = base.net_graph.get_node_coord(r_ids[0])
        start_world = np.array(base.ct2real([sx, sy]) + [0.0])
        # Face the first path segment.
        n1 = np.array(base.ct2real(list(base.net_graph.get_node_coord(r_ids[1]))))
        start_world[2] = math.atan2(n1[1] - start_world[1],
                                    n1[0] - start_world[0])
        scenarios.append(build_scenario(
            base, robot_path_nodes=r_ids[1:], human_path_nodes=h_paths,
            robot_start=start_world, human_starts=h_starts, **kw))
    if len(scenarios) < n:   # top up by repeating (rare)
        scenarios += scenarios[: n - len(scenarios)]
    batch = Scenario(*[np.stack([s[i] for s in scenarios])
                       for i in range(len(scenarios[0]))])
    return batch if device is None else scenario_to_device(batch, device)


def synthetic_fleet_scenario(*args, **kwargs):
    raise NotImplementedError(_FLEET)


build_fleet_scenario = random_fleet_scenarios = synthetic_fleet_scenario
