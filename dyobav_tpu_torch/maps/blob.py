"""Obstacle blob extraction: occupied regions → min-area bounding rectangles.

The reference pipeline (`basic_map/map_tools/blob_bounding.py`) runs
skimage `find_contours` → scipy `ConvexHull` → rotating-calipers min-area
rectangle.  skimage is not available here; since the blobs of interest are
filled regions, connected-component labeling (scipy.ndimage) → convex hull
of component pixels → min-area rectangle is behaviorally equivalent and
simpler.  The rotating-calipers search over hull-edge angles follows the
same classic algorithm the reference cites.
"""
from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage

from ..utils.geometry import convex_hull


def min_area_rect(hull_points: np.ndarray) -> np.ndarray:
    """Smallest-area bounding rectangle of a convex hull → (4, 2) vertices.

    Rotating calipers over the hull edge angles (the reference's
    `get_bounding_rectangle`, blob_bounding.py:32-89, same maths).
    """
    pts = np.asarray(hull_points, dtype=np.float64)
    if pts.shape[0] < 3:
        # Degenerate blob: return the (possibly flat) bounding box.
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        return np.array([[mn[0], mn[1]], [mx[0], mn[1]],
                         [mx[0], mx[1]], [mn[0], mx[1]]])
    edges = pts[1:] - pts[:-1]
    angles = np.unique(np.abs(np.mod(np.arctan2(edges[:, 1], edges[:, 0]),
                                     np.pi / 2)))
    c, s = np.cos(angles), np.sin(angles)
    # Rotation matrices (k, 2, 2): rotate points into each candidate frame.
    rot = np.stack([np.stack([c, -s], axis=1),
                    np.stack([s, c], axis=1)], axis=1)
    proj = rot @ pts.T                        # (k, 2, n)
    min_xy = proj.min(axis=2)                 # (k, 2)
    max_xy = proj.max(axis=2)
    areas = np.prod(max_xy - min_xy, axis=1)
    k = int(np.argmin(areas))
    (x1, y1), (x2, y2) = max_xy[k], min_xy[k]
    r = rot[k]
    corners = np.array([[x1, y2], [x2, y2], [x2, y1], [x1, y1]])
    return corners @ r                        # rotate back (r is orthonormal)


def get_bounding_polygons(occupied: np.ndarray,
                          min_pixels: int = 2) -> List[np.ndarray]:
    """All occupied blobs of a binary image → list of (4, 2) rectangles in
    (x, y) pixel coordinates (the reference's x-y swap of row/col,
    blob_bounding.py:92-97)."""
    labels, n = ndimage.label(occupied)
    polygons: List[np.ndarray] = []
    for idx in range(1, n + 1):
        rows, cols = np.where(labels == idx)
        if rows.size < min_pixels:
            continue
        pts = np.stack([cols, rows], axis=1).astype(np.float64)  # (x, y)
        hull = convex_hull(pts)
        polygons.append(min_area_rect(hull))
    return polygons
