"""Geometric (polygon) map with inflation and coordinate conversion (the
port's copy of `dyobav_tpu.maps.geometric`; `plot` draws on a caller's
matplotlib axes and imports nothing).

Mirrors `basic_map/map_geometric.GeometricMap` (map_geometric.py:35-122);
polygon offsetting is the dependency-free `utils.geometry.offset_polygon`
instead of pyclipper — exact miter joins for convex polygons, exact
Euclidean (distance-field) offsets for general simple polygons including
non-convex boundary deflation.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from ..utils.geometry import offset_polygon


class GeometricMap:
    """Boundary + obstacle polygons; optionally inflated by a robot margin."""

    def __init__(self, boundary_coords: List[tuple],
                 obstacle_list: List[List[tuple]],
                 inflate_margin: float | None = None):
        if not isinstance(boundary_coords, list) or not isinstance(obstacle_list, list):
            raise TypeError("Boundary/obstacles must be lists of coordinates.")
        if len(boundary_coords[0]) != 2 or (obstacle_list and len(obstacle_list[0][0]) != 2):
            raise TypeError("All coordinates must be 2-dimensional.")
        self.boundary_coords = [tuple(c) for c in boundary_coords]
        self.obstacle_list = [[tuple(c) for c in obs] for obs in obstacle_list]
        if inflate_margin is not None:
            # Deflate the boundary, inflate the obstacles (map_geometric.py:49-51).
            deflated = offset_polygon(np.array(self.boundary_coords),
                                      -inflate_margin)
            if deflated.shape[0] < 3:
                raise ValueError(
                    "Boundary deflation by the robot margin leaves no free "
                    "space (inradius smaller than the margin).")
            self.processed_boundary_coords = [tuple(v) for v in deflated]
            self.processed_obstacle_list = [
                [tuple(v) for v in offset_polygon(np.array(obs), inflate_margin)]
                for obs in self.obstacle_list]
        else:
            self.processed_boundary_coords = None
            self.processed_obstacle_list = None

    def __call__(self, inflated: bool = True
                 ) -> Tuple[List[tuple], List[List[tuple]]]:
        if inflated:
            if self.processed_boundary_coords is None:
                raise ValueError("No inflated map available.")
            return self.processed_boundary_coords, self.processed_obstacle_list
        return self.boundary_coords, self.obstacle_list

    def coords_cvt(self, ct: Callable) -> "GeometricMap":
        """Apply a coordinate transform to every vertex (map_geometric.py:71-76)."""
        self.boundary_coords = [tuple(ct(list(x))) for x in self.boundary_coords]
        self.obstacle_list = [[tuple(ct(list(x))) for x in y] for y in self.obstacle_list]
        if self.processed_boundary_coords is not None:
            self.processed_boundary_coords = [
                tuple(ct(list(x))) for x in self.processed_boundary_coords]
            self.processed_obstacle_list = [
                [tuple(ct(list(x))) for x in y] for y in self.processed_obstacle_list]
        return self

    def get_occupancy_map(self, cell_size: float = 0.1) -> np.ndarray:
        """Rasterize polygons back to a grid (free=255, occupied=0).

        Pure-numpy replacement for the reference's matplotlib-canvas
        rasterization (map_geometric.py:78-104).
        """
        bnd = np.array(self.boundary_coords)
        x0, y0 = bnd.min(axis=0)
        x1, y1 = bnd.max(axis=0)
        W = max(2, int(np.ceil((x1 - x0) / cell_size)))
        H = max(2, int(np.ceil((y1 - y0) / cell_size)))
        xs = x0 + (np.arange(W) + 0.5) * cell_size
        ys = y0 + (np.arange(H) + 0.5) * cell_size
        gx, gy = np.meshgrid(xs, ys)
        occupied = np.zeros((H, W), dtype=bool)
        for obs in self.obstacle_list:
            poly = np.array(obs)
            inside = np.ones((H, W), dtype=bool)
            n = poly.shape[0]
            # Convex polygon: point is inside iff on the same side of every
            # edge; orientation determined by the polygon's signed area.
            area = 0.5 * np.sum(poly[:, 0] * np.roll(poly[:, 1], -1)
                                - np.roll(poly[:, 0], -1) * poly[:, 1])
            sign = 1.0 if area > 0 else -1.0
            for i in range(n):
                p, q = poly[i], poly[(i + 1) % n]
                cross = (q[0] - p[0]) * (gy - p[1]) - (q[1] - p[1]) * (gx - p[0])
                inside &= (sign * cross) >= 0
            occupied |= inside
        return np.where(occupied, 0, 255).astype(np.uint8)

    def plot(self, ax, inflated: bool = True,
             original_plot_args: dict | None = None,
             inflated_plot_args: dict | None = None):
        """Draw the boundary (a line) and the obstacles (filled) on a
        caller's matplotlib `ax`, the inflated map first."""
        original_plot_args = original_plot_args or {"c": "k"}
        inflated_plot_args = inflated_plot_args or {"c": "r", "alpha": 0.3}
        if inflated and self.processed_boundary_coords is not None:
            pb = np.array(self.processed_boundary_coords
                          + [self.processed_boundary_coords[0]])
            ax.plot(pb[:, 0], pb[:, 1], **inflated_plot_args)
            for coords in self.processed_obstacle_list:
                po = np.array(coords + [coords[0]])
                ax.fill(po[:, 0], po[:, 1], **inflated_plot_args)
        pb = np.array(self.boundary_coords + [self.boundary_coords[0]])
        ax.plot(pb[:, 0], pb[:, 1], **original_plot_args)
        for coords in self.obstacle_list:
            po = np.array(coords + [coords[0]])
            ax.fill(po[:, 0], po[:, 1], **original_plot_args)
