"""Navigation graph: node positions, adjacency and helpers.

The port's counterpart of `dyobav_tpu.maps.graph.NetGraph`, which
subclasses `networkx.Graph`.  This one is a plain class with the part of
that surface the scenario constructors and the planners use: `nodes`, `adj`,
`edges`, `add_edge`, `remove_edge`, `has_edge`, `copy`, `get_node_coord`,
`return_given_nodelist`, `return_random_nodelist`, `load_from_json`,
`plot_netgraph`.  Node order and each node's neighbour order are
networkx's (insertion order of `add_node`, then of `add_edges_from`, both
ends of every edge; an edge removed and added again goes last; `copy`
rebuilds the adjacency as `networkx.Graph.copy` does), because
`sim.scenarios.random_scenarios` draws from `list(graph.nodes)` and
`graph.adj[i]` with a seeded `random.Random`, and
`planners.dijkstra` breaks ties between equal-length paths by that order:
any other order gives other scenarios from the same seed, and other paths.
"""
from __future__ import annotations

import json
import math
import random
from typing import Any, Dict, List

import numpy as np


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

    def add_edge(self, u, v, **attr) -> None:
        self.add_edges_from([(u, v, attr)])

    def remove_edge(self, u, v) -> None:
        del self.adj[u][v]
        if u != v:
            del self.adj[v][u]

    def has_edge(self, u, v) -> bool:
        return u in self.adj and v in self.adj[u]

    def copy(self) -> "NetGraph":
        """An independent copy, built in `networkx.Graph.copy`'s order."""
        g = type(self)()
        for n, d in self.nodes.items():
            g.add_node(n, **d)
        g.add_edges_from((u, v, dict(d)) for u, nbrs in self.adj.items()
                         for v, d in nbrs.items())
        return g

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

    def plot_netgraph(self, ax, node_style="x", node_text: bool = True,
                      edge_color="r") -> None:
        """Draw the nodes (a marker and, with `node_text`, the id each) and
        the edges (one line collection, as `networkx.draw_networkx_edges`
        draws an undirected graph) on a caller's matplotlib `ax`."""
        from matplotlib.collections import LineCollection

        for n in self.nodes:
            x, y = self.get_node_coord(n)
            ax.plot(x, y, node_style)
            if node_text:
                ax.text(x, y, str(n))
        segments = [(self.get_node_coord(u), self.get_node_coord(v))
                    for u, v in self.edges]
        if not segments:
            return
        lines = LineCollection(segments, colors=edge_color, linewidths=1.0,
                               linestyle="solid", antialiaseds=(1,))
        lines.set_zorder(1)
        ax.add_collection(lines)
        (minx, miny), (maxx, maxy) = (np.min(segments, axis=(0, 1)),
                                      np.max(segments, axis=(0, 1)))
        padx, pady = 0.05 * (maxx - minx), 0.05 * (maxy - miny)
        ax.update_datalim([(minx - padx, miny - pady),
                           (maxx + padx, maxy + pady)])
        ax.autoscale_view()
        ax.tick_params(axis="both", which="both", bottom=False, left=False,
                       labelbottom=False, labelleft=False)
