"""Schedule-driven multi-robot global path planner, the port of
`dyobav_tpu.planners.global_plan` without pandas.

Mirrors `pkg_path_plan/global_path_plan.GlobalPathPlanner`
(global_path_plan.py:9-119): detailed schedules (node_id + ETA per robot)
or rough schedules (start/end node + EDT) resolved through Dijkstra.  A
schedule is a list of rows, each a dict from column name to value, where
the JAX class holds a `pandas.DataFrame`; a CSV file is read with the
`csv` module, each cell parsed as an int, else a float, else kept as text
(an empty cell is NaN, as pandas reads it).
"""
from __future__ import annotations

import csv
from typing import Any, Dict, List, Tuple

from ..maps.graph import NetGraph
from .dijkstra import DijkstraPathPlanner


def _cell(text: str):
    if text == "":
        return float("nan")
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


class GlobalPathPlanner:
    def __init__(self) -> None:
        self.schedule: List[dict] | None = None
        self.robot_plan_dict: Dict[Any, List[dict]] = {}
        self._robot_ids: list = []
        self.G: NetGraph | None = None
        self.with_detail = False

    @property
    def robot_ids(self) -> list:
        return self._robot_ids

    def _index(self) -> None:
        self._robot_ids = list(dict.fromkeys(r["robot_id"]
                                             for r in self.schedule))
        for robot_id in self._robot_ids:
            self.robot_plan_dict[robot_id] = [
                r for r in self.schedule if r["robot_id"] == robot_id]

    def load_schedule_from_rows(self, new_schedule: List[dict]):
        """Add rows (dicts with `robot_id` and either `node_id` + `ETA` or
        `start_node`, `end_node` + `EDT`): the JAX class's
        `load_schedule_from_dataframe`."""
        new_schedule = [dict(r) for r in new_schedule]
        columns = set().union(*new_schedule) if new_schedule else set()
        if "ETA" in columns:
            self.with_detail = True
        elif "EDT" in columns:
            self.with_detail = False
        else:
            raise ValueError("The schedule should include ETA or EDT.")
        self.schedule = (self.schedule or []) + new_schedule
        self._index()

    def load_schedule(self, file_path: str, csv_sep: str = ",",
                      header: int = 0):
        """Rows from a CSV file whose line `header` (0-based) names the
        columns; the lines after it are the rows."""
        with open(file_path, newline="") as f:
            lines = list(csv.reader(f, delimiter=csv_sep))
        names = lines[header]
        self.load_schedule_from_rows(
            [dict(zip(names, map(_cell, line)))
             for line in lines[header + 1:] if line])

    def load_graph(self, G: NetGraph):
        self.G = G

    def remove_schedule(self, robot_id: Any):
        self.schedule = [r for r in self.schedule or []
                         if r["robot_id"] != robot_id]
        self.robot_plan_dict.pop(robot_id, None)
        self._index()

    def set_path(self, robot_id: Any, path_node_list: list, time_list=None):
        if time_list is None:
            time_list = [None] * len(path_node_list)
        new_schedule = [{"robot_id": robot_id, "node_id": n, "ETA": t}
                        for n, t in zip(path_node_list, time_list)]
        self.remove_schedule(robot_id)
        self.load_schedule_from_rows(new_schedule)

    def get_robot_schedule(self, robot_id: Any, time_offset: float = 0.0
                           ) -> Tuple[list, list]:
        if self.with_detail:
            plan = self.robot_plan_dict[robot_id]
            return [r["node_id"] for r in plan], [r["ETA"] for r in plan]
        if self.G is None:
            raise ValueError("The graph is not loaded.")
        plan = self.robot_plan_dict[robot_id]
        source = plan[0]["start_node"]
        target = plan[0]["end_node"]
        edt = plan[0]["EDT"]
        path_nodes, section_lengths = self.get_shortest_path(self.G, source,
                                                             target)
        total = sum(section_lengths) or 1.0
        cumulative = 0.0
        path_times = [time_offset]
        for seg in section_lengths:
            cumulative += seg
            path_times.append(time_offset + cumulative / total * edt)
        return path_nodes, path_times

    @staticmethod
    def get_shortest_path(graph: NetGraph, source: Any, target: Any,
                          algorithm: str = "dijkstra"):
        if algorithm != "dijkstra":
            raise NotImplementedError(f"Algorithm {algorithm} not implemented.")
        planner = DijkstraPathPlanner(graph)
        _, paths = planner.k_shortest_paths(source, target, k=1,
                                            get_coords=False)
        shortest = paths[0]
        section_lengths = [graph.adj[u][v]["weight"]
                           for u, v in zip(shortest[:-1], shortest[1:])]
        return shortest, section_lengths
