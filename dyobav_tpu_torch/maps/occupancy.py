"""Occupancy-grid map (image-backed) and conversion to a geometric map.

Mirrors the reference `basic_map/map_occupancy.OccupancyMap` surface
(map_occupancy.py:10-76): callable returning binary/gray/raw images, plus
`get_geometric_map` extracting per-obstacle bounding rectangles with
nested-obstacle pruning.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .blob import get_bounding_polygons


class OccupancyMap:
    def __init__(self, map_image: np.ndarray, occupancy_threshold: int = 120):
        map_image = self._validate(map_image)
        self._width = map_image.shape[1]
        self._height = map_image.shape[0]
        self._background = map_image
        if map_image.shape[2] == 3:
            self._gray = map_image.astype(np.float64).mean(axis=2)
        else:
            self._gray = map_image[:, :, 0].astype(np.float64)
        # Convention (reference map pipeline): after `process_map_image`,
        # occupied cells are bright (255) and free cells dark (0).
        self._binary = self._gray > occupancy_threshold

    @staticmethod
    def _validate(map_image: np.ndarray) -> np.ndarray:
        if not isinstance(map_image, np.ndarray):
            raise TypeError("A map image must be a numpy array.")
        if map_image.ndim == 2:
            map_image = map_image[:, :, np.newaxis]
        if map_image.ndim != 3:
            raise TypeError(f"A map image must have 2/3 dims; got {map_image.ndim}.")
        if map_image.shape[2] == 4:
            map_image = map_image[:, :, :3]
        if map_image.shape[2] not in (1, 3):
            raise TypeError(f"A map image must have 1/3/4 channels; got {map_image.shape[2]}.")
        return map_image

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    def __call__(self, binary_scale: bool = False, gray_scale: bool = True) -> np.ndarray:
        if binary_scale:
            return self._binary
        if gray_scale:
            return self._gray
        return self._background

    def get_geometric_map(self, bounding_degree: int = 4
                          ) -> Tuple[List[tuple], List[List[tuple]]]:
        """Boundary rectangle + per-obstacle min-area rectangles.

        Matches `map_occupancy.get_geometric_map` (map_occupancy.py:49-72):
        boundary = full image rect; obstacles = bounded blobs, with
        obstacles nested inside another obstacle's core removed.
        """
        del bounding_degree  # only rectangles supported, as in the reference
        boundary_coords = [(0.0, 0.0), (0.0, float(self.height)),
                           (float(self.width), float(self.height)),
                           (float(self.width), 0.0)]
        rects = get_bounding_polygons(self._binary)

        def core_band(coords: np.ndarray):
            sx = np.sort(coords[:, 0])
            sy = np.sort(coords[:, 1])
            return sx[1], sx[2], sy[1], sy[2]

        kept: List[np.ndarray] = []
        for i, coords in enumerate(rects):
            x_l, x_r = coords[:, 0].min(), coords[:, 0].max()
            y_lo, y_hi = coords[:, 1].min(), coords[:, 1].max()
            nested = False
            for j, other in enumerate(rects):
                if i == j:
                    continue
                ox_l, ox_r, oy_lo, oy_hi = core_band(other)
                if x_l > ox_l and x_r < ox_r and y_lo > oy_lo and y_hi < oy_hi:
                    nested = True
                    break
            if not nested:
                kept.append(coords)
        obstacle_list = [x.tolist() for x in kept]
        return boundary_coords, obstacle_list
