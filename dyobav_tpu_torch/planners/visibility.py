"""Visibility-graph local path planning in polygon C-space, the port's copy
of `dyobav_tpu.planners.visibility` (numpy, on the port's
`utils.geometry.point_in_polygon`).

Replaces the reference's external `extremitypathfinder` dependency
(`pkg_path_plan/path_plan_cspace/visibility.VisibilityPathFinder`,
visibility.py:4-49) with a self-contained visibility graph: nodes are the
(inflated) obstacle vertices plus start/goal; an edge exists when the
straight segment stays inside the boundary and strictly outside every
obstacle; shortest path via Dijkstra over edge lengths.
"""
from __future__ import annotations

import heapq
import math
from typing import List, Tuple

import numpy as np

from ..utils.geometry import point_in_polygon


def _segments_properly_intersect(p1, p2, q1, q2) -> bool:
    """True iff segments p1p2 and q1q2 cross at an interior point."""
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(v) < 1e-12:
            return 0
        return 1 if v > 0 else -1

    o1, o2 = orient(p1, p2, q1), orient(p1, p2, q2)
    o3, o4 = orient(q1, q2, p1), orient(q1, q2, p2)
    return o1 != o2 and o3 != o4 and 0 not in (o1, o2, o3, o4)


class VisibilityPathFinder:
    def __init__(self, boundary_coords: List[tuple],
                 obstacle_list: List[List[tuple]], verbose: bool = False):
        self.boundary = np.asarray(boundary_coords, dtype=np.float64)
        self.obstacles = [np.asarray(o, dtype=np.float64) for o in obstacle_list]
        self.vb = verbose
        self._prepare()

    def _prepare(self):
        # Node set: obstacle vertices nudged outward along the vertex normal
        # so edges grazing a corner don't count as crossing it.
        self.nodes: List[np.ndarray] = []
        for poly in self.obstacles:
            center = poly.mean(axis=0)
            for v in poly:
                d = v - center
                n = np.linalg.norm(d)
                nudged = v + (d / n * 1e-6 if n > 1e-12 else 0.0)
                if point_in_polygon(nudged, self.boundary):
                    self.nodes.append(nudged)

    def _segment_free(self, a: np.ndarray, b: np.ndarray) -> bool:
        for poly in self.obstacles:
            m = poly.shape[0]
            for i in range(m):
                if _segments_properly_intersect(a, b, poly[i], poly[(i + 1) % m]):
                    return False
            if point_in_polygon((a + b) / 2.0, poly):
                return False
        return True

    def get_ref_path(self, start_pos: tuple, end_pos: tuple) -> List[tuple]:
        """Shortest collision-free polyline from start to end."""
        start = np.asarray(start_pos[:2], dtype=np.float64)
        end = np.asarray(end_pos[:2], dtype=np.float64)
        nodes = [start] + self.nodes + [end]
        n = len(nodes)
        s_idx, e_idx = 0, n - 1

        adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                if self._segment_free(nodes[i], nodes[j]):
                    d = float(np.linalg.norm(nodes[i] - nodes[j]))
                    adj[i].append((j, d))
                    adj[j].append((i, d))

        dist = [math.inf] * n
        prev = [-1] * n
        dist[s_idx] = 0.0
        heap = [(0.0, s_idx)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist[u]:
                continue
            if u == e_idx:
                break
            for v, w in adj[u]:
                nd = d + w
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(heap, (nd, v))
        if not math.isfinite(dist[e_idx]):
            raise RuntimeError("No collision-free path found.")
        path = []
        u = e_idx
        while u != -1:
            path.append(tuple(nodes[u]))
            u = prev[u]
        return path[::-1]


class LocalPathPlanner:
    """Mirrors `pkg_path_plan/local_path_plan.LocalPathPlanner` (:9-44)."""

    def __init__(self, graph_map, verbose: bool = False):
        self.path_planner = VisibilityPathFinder(
            graph_map.processed_boundary_coords,
            graph_map.processed_obstacle_list, verbose=verbose)

    def get_ref_path(self, start: tuple, end: tuple):
        from .paths import PathNodeList
        self.ref_path = PathNodeList.from_tuples(
            self.path_planner.get_ref_path(start, end))
        return self.ref_path

    def get_ref_path_waypoints(self, waypoints: List[tuple]):
        from .paths import PathNodeList
        if len(waypoints) < 2:
            raise ValueError("Waypoints must have at least two points")
        self.ref_path = PathNodeList.from_tuples([waypoints[0]])
        for start, end in zip(waypoints[:-1], waypoints[1:]):
            seg = self.path_planner.get_ref_path(start, end)
            self.ref_path.extend(PathNodeList.from_tuples(seg[1:]))
        return self.ref_path
