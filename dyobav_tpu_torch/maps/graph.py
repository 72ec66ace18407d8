"""Navigation graph: node positions, adjacency and helpers.

The port's counterpart of `dyobav_tpu.maps.graph.NetGraph`, which
subclasses `networkx.Graph`.  This one is a plain class with the part of
that surface the scenario constructors use: `nodes`, `adj`, `edges`,
`get_node_coord`, `return_given_nodelist`, `return_random_nodelist`,
`load_from_json`.  Node order and each node's neighbour order are
networkx's (insertion order of `add_node`, then of `add_edges_from`, both
ends of every edge), because `sim.scenarios.random_scenarios` draws from
`list(graph.nodes)` and `graph.adj[i]` with a seeded `random.Random`: any
other order gives other scenarios from the same seed.
"""
from __future__ import annotations

import json
import math
import random
from typing import Any, Dict, List


class NetGraph:
    POSITION_KEY = "position"

    def __init__(self, node_dict: Dict[Any, tuple] | None = None,
                 edge_list: List[tuple] | None = None):
        self.nodes: Dict[int, dict] = {}     # id -> attributes
        self.adj: Dict[int, dict] = {}       # id -> {neighbour: attributes}
        if node_dict:
            for node_id, pos in node_dict.items():
                self.add_node(int(node_id), **{self.POSITION_KEY: tuple(pos)})
        if edge_list:
            self.add_edges_from(edge_list)

    def add_node(self, node_id, **attr) -> None:
        if node_id not in self.nodes:
            self.nodes[node_id] = {}
            self.adj[node_id] = {}
        self.nodes[node_id].update(attr)

    def add_edges_from(self, edge_list) -> None:
        for edge in edge_list:
            u, v = edge[0], edge[1]
            attr = dict(edge[2]) if len(edge) > 2 else {}
            self.add_node(u)
            self.add_node(v)
            data = self.adj[u].get(v, {})
            data.update(attr)
            self.adj[u][v] = data
            self.adj[v][u] = data

    @property
    def edges(self) -> List[tuple]:
        """Each undirected edge once, in networkx's order."""
        seen, out = set(), []
        for u, nbrs in self.adj.items():
            out += [(u, v) for v in nbrs if v not in seen]
            seen.add(u)
        return out

    @classmethod
    def load_from_json(cls, json_path: str) -> "NetGraph":
        with open(json_path) as jf:
            map_dict = json.load(jf)
        return cls(map_dict["node_dict"], map_dict["edge_list"])

    def save_to_json(self, json_path: str) -> None:
        payload = {
            "node_dict": {str(n): list(self.get_node_coord(n))
                          for n in self.nodes},
            "edge_list": [list(e) for e in self.edges],
        }
        with open(json_path, "w") as jf:
            json.dump(payload, jf, indent=2)

    def set_distance_weight(self) -> None:
        for u, v in self.edges:
            x1, y1 = self.nodes[u][self.POSITION_KEY]
            x2, y2 = self.nodes[v][self.POSITION_KEY]
            self.adj[u][v]["weight"] = math.hypot(x1 - x2, y1 - y2)

    def get_node_coord(self, node_id) -> tuple:
        pos = self.nodes[node_id][self.POSITION_KEY]
        return pos[0], pos[1]

    def return_given_nodelist(self, graph_node_ids: list) -> List[tuple]:
        return [self.get_node_coord(i) for i in graph_node_ids]

    def return_random_nodelist(self, start_node_id, num_traversed_nodes: int,
                               rng: random.Random | None = None) -> List[tuple]:
        rng = rng or random
        node_ids = [start_node_id]
        nodelist = [self.get_node_coord(start_node_id)]
        for _ in range(num_traversed_nodes):
            neighbors = [x for x in self.adj[node_ids[-1]]
                         if x not in node_ids]
            if not neighbors:
                return nodelist
            next_id = rng.choice(neighbors)
            node_ids.append(next_id)
            nodelist.append(self.get_node_coord(next_id))
        return nodelist
