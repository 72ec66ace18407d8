"""Typed path/trajectory containers (mirrors `pkg_path_plan/_path.py`), the
port's copy of `dyobav_tpu.planners.paths`.

PathNode (:58-89): (x, y [, id]); PathNodeList (:91-128): list-like with
numpy conversion and node-id lookup; TrajectoryNode(List) (:130-171): adds
heading.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class PathNode:
    def __init__(self, x: float, y: float, node_id: Optional[int] = None):
        self.x = float(x)
        self.y = float(y)
        self.id = node_id

    def __call__(self) -> Tuple[float, float]:
        return (self.x, self.y)

    def __getitem__(self, idx):
        return (self.x, self.y)[idx]

    def __eq__(self, other):
        return tuple(self()) == tuple(other())

    def __repr__(self):
        return f"PathNode({self.x}, {self.y}, id={self.id})"

    def rescale(self, scale: float) -> "PathNode":
        return PathNode(self.x * scale, self.y * scale, self.id)


class PathNodeList(list):
    @classmethod
    def from_tuples(cls, tuples: List[tuple]) -> "PathNodeList":
        return cls([PathNode(*t[:2]) for t in tuples])

    def to_tuples(self) -> List[tuple]:
        return [n() for n in self]

    def numpy(self) -> np.ndarray:
        return np.array([n() for n in self], dtype=np.float64)

    def get_node_coords(self, node_id) -> Optional[tuple]:
        for n in self:
            if n.id == node_id:
                return n()
        return None

    def rescale(self, scale: float) -> "PathNodeList":
        return PathNodeList([n.rescale(scale) for n in self])


class TrajectoryNode(PathNode):
    def __init__(self, x: float, y: float, theta: float,
                 node_id: Optional[int] = None):
        super().__init__(x, y, node_id)
        self.theta = float(theta)

    def __call__(self):
        return (self.x, self.y, self.theta)


class TrajectoryNodeList(list):
    @classmethod
    def from_tuples(cls, tuples: List[tuple]) -> "TrajectoryNodeList":
        return cls([TrajectoryNode(*t[:3]) for t in tuples])

    def numpy(self) -> np.ndarray:
        return np.array([n() for n in self], dtype=np.float64)
