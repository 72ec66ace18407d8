"""Graph path planning: Dijkstra + Yen's k-shortest paths, the port of
`dyobav_tpu.planners.dijkstra` on the port's networkx-free
`maps.graph.NetGraph`.

Mirrors `pkg_path_plan/path_plan_graph/dijkstra.DijkstraPathPlanner`
(dijkstra.py:8-120): k-shortest simple paths on a weighted graph via
Yen's algorithm with spur-node edge removal.  `single_source_dijkstra` is
networkx's heap Dijkstra to one target step for step: the fringe breaks
ties between equal distances by push order, a node's predecessor changes
only on a strictly shorter distance, and neighbours are scanned in the
graph's adjacency order.  So among paths of equal length it returns the
one networkx returns, on the same graph edited in the same order.
"""
from __future__ import annotations

from heapq import heappop, heappush
from itertools import count
from typing import Any, List, Tuple

from ..maps.graph import NetGraph


class NoPath(Exception):
    """No path between the two nodes (networkx's `NetworkXNoPath`)."""


def single_source_dijkstra(G: NetGraph, source, target,
                           weight: str = "weight") -> Tuple[float, list]:
    """(length, nodes) of a shortest path from `source` to `target`; an
    edge without `weight` weighs 1.  Raises NoPath."""
    if source not in G.nodes:
        raise KeyError(f"Node {source} not found in graph")
    if source == target:
        return 0, [target]
    dist, seen, pred = {}, {source: 0}, {}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        if v == target:
            break
        for u, e in G.adj[v].items():
            vu = d + e.get(weight, 1)
            if u in dist:
                if vu < dist[u]:
                    raise ValueError("Contradictory paths found: negative "
                                     "weights?")
            elif u not in seen or vu < seen[u]:
                seen[u] = vu
                heappush(fringe, (vu, next(c), u))
                pred[u] = v
    if target not in dist:
        raise NoPath(f"No path to {target}.")
    path = [target]
    while path[-1] in pred:
        path.append(pred[path[-1]])
    return dist[target], path[::-1]


class DijkstraPathPlanner:
    def __init__(self, graph: NetGraph):
        self.G = graph

    def _path_length(self, G: NetGraph, path_nodes: list,
                     weight_key: str = "weight") -> float:
        length = 0.0
        for u, v in zip(path_nodes[:-1], path_nodes[1:]):
            length += G.adj[u][v][weight_key]
        return length

    def _k_shortest(self, source, target, k: int = 1,
                    weight_key: str = "weight"
                    ) -> Tuple[List[float], List[List[Any]]]:
        if source == target:
            return [0.0], [[source]]
        G = self.G.copy()
        length, path = single_source_dijkstra(G, source, target,
                                              weight=weight_key)
        lengths, paths = [length], [path]
        candidates: list = []
        counter = 0
        for _ in range(1, k):
            prev = paths[-1]
            for j in range(len(prev) - 1):
                spur_node = prev[j]
                root_path = prev[:j + 1]
                removed = []
                for p in paths:
                    if len(p) > j and root_path == p[:j + 1] and G.has_edge(p[j], p[j + 1]):
                        attr = dict(G.adj[p[j]][p[j + 1]])
                        G.remove_edge(p[j], p[j + 1])
                        removed.append((p[j], p[j + 1], attr))
                for node in root_path[:-1]:
                    for v, attr in list(G.adj[node].items()):
                        G.remove_edge(node, v)
                        removed.append((node, v, dict(attr)))
                try:
                    spur_len, spur_path = single_source_dijkstra(
                        G, spur_node, target, weight=weight_key)
                    total = root_path[:-1] + spur_path
                    total_len = self._path_length(self.G, root_path,
                                                  weight_key) + spur_len
                    heappush(candidates, (total_len, counter, total))
                    counter += 1
                except (NoPath, KeyError):
                    pass
                finally:
                    for u, v, attr in removed:
                        G.add_edge(u, v, **attr)
            if not candidates:
                break
            total_len, _, total = heappop(candidates)
            if total not in paths:
                lengths.append(total_len)
                paths.append(total)
        return lengths, paths

    def k_shortest_paths(self, source, target, k: int = 1,
                         weight_key: str = "weight",
                         position_key: str = "position",
                         get_coords: bool = True
                         ) -> Tuple[List[float], List[list]]:
        lengths, raw_paths = self._k_shortest(source, target, k, weight_key)
        if not get_coords:
            return lengths, raw_paths
        paths = []
        for raw in raw_paths:
            path = []
            for node_id in raw:
                x, y = self.G.nodes[node_id][position_key][:2]
                path.append((x, y, node_id))
            paths.append(path)
        return lengths, paths
