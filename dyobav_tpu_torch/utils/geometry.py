"""2-D geometry, the port of `dyobav_tpu.utils.geometry`.

The host-side helpers for map preprocessing (numpy) run once per map or
scenario, outside the solver; their outputs are the fixed-size padded
tensors the batched simulation reads.  `lineseg_dists`, which the JAX file
evaluates through `jnp`, is plain numpy here.  The six point primitives at
the top (`dist_to_points_sq` ... `angle_between_vectors`) are torch
functions on their inputs' device; the solver's own indicators are batched
in `ops/costs.py`.
"""
from __future__ import annotations

import numpy as np
import torch


def dist_to_points_sq(point: torch.Tensor, points: torch.Tensor
                      ) -> torch.Tensor:
    """Squared distances from one point (d,) to m points (m, d) -> (m,).

    Ref: `mpc_helper.dist_to_points_square` (mpc_helper.py:5-15).
    """
    diff = points - point[None, :]
    return torch.sum(diff * diff, dim=-1)


def dist_to_linesegs(point: torch.Tensor, seg_a: torch.Tensor,
                     seg_b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance from one point (2,) to m segments (m,2),(m,2) ->
    (m,), with `mpc_helper.dist_to_lineseg`'s 1e-16 degenerate-segment
    guard (mpc_helper.py:17-36)."""
    d = seg_b - seg_a                                     # (m, 2)
    t_hat = torch.sum((point[None, :] - seg_a) * d, dim=-1) / (
        torch.sum(d * d, dim=-1) + 1e-16)
    t = torch.clamp(t_hat, 0.0, 1.0)
    closest = seg_a + t[:, None] * d
    return torch.linalg.norm(closest - point[None, :], dim=-1)


def inside_ellipses(point_xy: torch.Tensor, cx: torch.Tensor,
                    cy: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                    ang: torch.Tensor) -> torch.Tensor:
    """Signed inside-indicator for m rotated ellipses -> (m,): >0 inside,
    with the reference's 1e-6 radius regularizer
    (`mpc_helper.inside_ellipses`, mpc_helper.py:38-52)."""
    dx = point_xy[0] - cx
    dy = point_xy[1] - cy
    c, s = torch.cos(ang), torch.sin(ang)
    u = (dx * c + dy * s) / (rx + 1e-6)
    v = (dx * s - dy * c) / (ry + 1e-6)
    return 1.0 - u * u - v * v


def inside_cvx_polygon(point_xy: torch.Tensor, b: torch.Tensor,
                       a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """Product-of-hinges inside-indicator of one convex polygon given as
    half-spaces `b - a0 x - a1 y > 0`: positive iff strictly inside
    (`mpc_helper.inside_cvx_polygon`, mpc_helper.py:54-75)."""
    residual = b - a0 * point_xy[0] - a1 * point_xy[1]
    return torch.prod(torch.clamp(residual, min=0.0), dim=-1)


def outside_cvx_polygon(point_xy: torch.Tensor, b: torch.Tensor,
                        a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """Sum-of-squared-violations outside-indicator, 0 inside
    (`mpc_helper.outside_cvx_polygon`, mpc_helper.py:77-98)."""
    residual = b - a0 * point_xy[0] - a1 * point_xy[1]
    return torch.sum(torch.clamp(residual, max=0.0) ** 2, dim=-1)


def angle_between_vectors(l1: torch.Tensor, l2: torch.Tensor
                          ) -> torch.Tensor:
    """Signed angle (radians) between vectors given as 2x2 point pairs
    (`mpc_helper.angle_between_vectors`, mpc_helper.py:100-110)."""
    v1 = l1[1] - l1[0]
    v2 = l2[1] - l2[0]
    cos_angle = torch.dot(v1, v2) / (
        torch.linalg.norm(v1) * torch.linalg.norm(v2) + 1e-6)
    sign = torch.sign(v2[0] * v1[1] - v2[1] * v1[0])
    return torch.arccos(torch.clamp(cos_angle, -1.0, 1.0)) * sign


def lineseg_dists(points: np.ndarray, seg_a: np.ndarray,
                  seg_b: np.ndarray) -> np.ndarray:
    """Distances from (k, 2) points to (m, 2)->(m, 2) segments: (k, m)."""
    points = np.atleast_2d(points)
    d = seg_b - seg_a                                     # (m, 2)
    len_sq = np.sum(d * d, axis=-1) + 1e-16               # (m,)
    rel = points[:, None, :] - seg_a[None, :, :]          # (k, m, 2)
    t = np.clip(np.sum(rel * d[None, :, :], axis=-1) / len_sq, 0.0, 1.0)
    closest = seg_a[None, :, :] + t[..., None] * d[None, :, :]
    return np.linalg.norm(points[:, None, :] - closest, axis=-1)


def polygon_halfspace_representation(polygon: np.ndarray):
    """Convex polygon (n,2) → half-space representation (b, a0, a1) lists.

    Each facet satisfies `a0·x + a1·y <= b` for interior points, matching the
    reference's `polygon_halfspace_representation` (utils_geo.py:35-62) which
    solves, per hull facet, the plane through the centered facet vertices and
    offsets by the hull center.  Implemented without scipy's ConvexHull: for
    2-D a monotone-chain hull + direct edge-normal construction is exact and
    dependency-free.
    """
    pts = np.asarray(polygon, dtype=np.float64)
    hull = convex_hull(pts)
    center = hull.mean(axis=0)
    b_list, a0_list, a1_list = [], [], []
    n = hull.shape[0]
    for i in range(n):
        p, q = hull[i], hull[(i + 1) % n]
        edge = q - p
        # Outward normal for a CCW hull is (edge_y, -edge_x).
        normal = np.array([edge[1], -edge[0]])
        norm = np.linalg.norm(normal)
        if norm < 1e-12:
            continue
        # Scale so that  normal·(p - center) == 1, mirroring the reference's
        # affine solve F A = 1 about the hull center; then b = A·center + 1.
        offset = float(normal @ (p - center))
        if abs(offset) < 1e-12:
            continue
        a = normal / offset
        b_list.append(float(a @ center) + 1.0)
        a0_list.append(float(a[0]))
        a1_list.append(float(a[1]))
    return b_list, a0_list, a1_list


def convex_hull(points: np.ndarray) -> np.ndarray:
    """2-D convex hull (Andrew's monotone chain), CCW order, (h,2)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if pts.shape[0] <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points_sorted):
        chain: list = []
        for p in points_sorted:
            while len(chain) >= 2 and cross2(chain[-2], chain[-1], p) <= 0:
                chain.pop()
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def inflate_convex_polygon(polygon: np.ndarray, margin: float) -> np.ndarray:
    """Offset a convex polygon outward by `margin` (negative = deflate).

    Miter-join offsetting via intersection of adjacent shifted edges — the
    dependency-free replacement for the reference's pyclipper `Inflator`
    (`map_geometric.py:10-32`).  Exact for the convex rectangles produced by
    the blob-bounding stage.
    """
    hull = convex_hull(np.asarray(polygon, dtype=np.float64))
    n = hull.shape[0]
    if n < 3 or margin > 0 and _polygon_area(hull) < 1e-9:
        # Degenerate blob (point or segment): offset to a proper rectangle,
        # as pyclipper's closed-polygon offsetting would.
        if margin <= 0:
            return hull
        pts = np.asarray(polygon, dtype=np.float64)
        if n >= 2:
            p, q = hull[0], hull[-1] if n > 1 else hull[0]
            far = np.argmax(np.linalg.norm(pts - pts[0], axis=1))
            p, q = pts[0], pts[far]
        else:
            p = q = pts[0]
        d = q - p
        nrm = np.linalg.norm(d)
        t = d / nrm if nrm > 1e-12 else np.array([1.0, 0.0])
        nvec = np.array([-t[1], t[0]])
        return np.array([
            p - margin * t - margin * nvec, q + margin * t - margin * nvec,
            q + margin * t + margin * nvec, p - margin * t + margin * nvec,
        ])
    shifted = []
    for i in range(n):
        p, q = hull[i], hull[(i + 1) % n]
        edge = q - p
        normal = np.array([edge[1], -edge[0]])
        nrm = np.linalg.norm(normal)
        if nrm < 1e-12:
            continue
        normal = normal / nrm
        shifted.append((p + margin * normal, q + margin * normal))
    out = []
    m = len(shifted)
    for i in range(m):
        (p1, q1), (p2, q2) = shifted[i], shifted[(i + 1) % m]
        d1, d2 = q1 - p1, q2 - p2
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:  # collinear edges: keep the shared endpoint
            out.append(q1)
            continue
        t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / denom
        out.append(p1 + t * d1)
    return np.array(out)


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def is_convex_polygon(polygon: np.ndarray, tol: float = 1e-9) -> bool:
    """True iff the simple polygon (n,2) is convex (either orientation).

    Consecutive-edge cross products must all share one sign; exactly
    collinear vertices are allowed.
    """
    poly = np.asarray(polygon, dtype=np.float64)
    if poly.shape[0] < 4:
        return True
    e = np.roll(poly, -1, axis=0) - poly
    cross = e[:, 0] * np.roll(e[:, 1], -1) - e[:, 1] * np.roll(e[:, 0], -1)
    scale = max(float(np.abs(cross).max()), 1.0)
    return bool(np.all(cross >= -tol * scale) or np.all(cross <= tol * scale))


def signed_polygon_distance(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Signed Euclidean distance from (m,2) points to a simple polygon:
    negative inside, positive outside (vectorized numpy, host-side)."""
    pts = np.asarray(points, dtype=np.float64)
    poly = np.asarray(polygon, dtype=np.float64)
    a = poly
    b = np.roll(poly, -1, axis=0)
    d = b - a                                              # (n, 2)
    len_sq = np.sum(d * d, axis=-1) + 1e-30
    rel = pts[:, None, :] - a[None, :, :]                  # (m, n, 2)
    t = np.clip(np.einsum("mnk,nk->mn", rel, d) / len_sq, 0.0, 1.0)
    closest = a[None] + t[..., None] * d[None]
    dist = np.sqrt(np.sum((pts[:, None, :] - closest) ** 2, axis=-1)).min(axis=1)
    # Inside test: even-odd crossing number, vectorized over points.
    x, y = pts[:, 0, None], pts[:, 1, None]
    xi, yi = a[None, :, 0], a[None, :, 1]
    xj, yj = b[None, :, 0], b[None, :, 1]
    crosses = ((yi > y) != (yj > y)) & (
        x < (xj - xi) * (y - yi) / (yj - yi + 1e-30) + xi)
    inside = np.sum(crosses, axis=1) % 2 == 1
    return np.where(inside, -dist, dist)


def _simplify_ring(ring: np.ndarray, tol: float) -> np.ndarray:
    """Douglas–Peucker simplification of a closed ring (n,2) → (k,2)."""
    pts = np.asarray(ring, dtype=np.float64)
    if pts.shape[0] <= 4:
        return pts
    # Anchor the ring at its two mutually farthest-ish points (farthest from
    # centroid, then farthest from that) so closure doesn't bias the split.
    c = pts.mean(axis=0)
    i0 = int(np.argmax(np.sum((pts - c) ** 2, axis=1)))
    pts = np.roll(pts, -i0, axis=0)
    i1 = int(np.argmax(np.sum((pts - pts[0]) ** 2, axis=1)))

    def dp(seg: np.ndarray) -> list:
        if seg.shape[0] <= 2:
            return [seg[0]]
        a, b = seg[0], seg[-1]
        d = lineseg_dists(seg[1:-1], a[None], b[None])[:, 0]
        k = int(np.argmax(d))
        if d[k] <= tol:
            return [a]
        return dp(seg[:k + 2]) + dp(seg[k + 1:])

    first = dp(pts[:i1 + 1])
    second = dp(np.concatenate([pts[i1:], pts[:1]], axis=0))
    return np.array(first + second)


def offset_polygon(polygon: np.ndarray, margin: float,
                   resolution: float | None = None) -> np.ndarray:
    """Offset an arbitrary SIMPLE polygon by `margin` (negative = deflate).

    The general-polygon replacement for the reference's pyclipper `Inflator`
    (`basic_map/map_geometric.py:10-32`, `JT_MITER` / `ET_CLOSEDPOLYGON`):

      * Convex inputs take the exact miter-join path
        (`inflate_convex_polygon`) — identical to pyclipper's JT_MITER for
        the blob-bounding rectangles, whose 90° corners never reach the
        miter limit.
      * Non-convex inputs (and non-convex deflation, e.g. the boundary
        C-space at `map_geometric.py:49-51`) use the exact EUCLIDEAN offset:
        the `margin` level-set of the signed distance field, extracted with
        contourpy and Douglas–Peucker-simplified.  This handles reflex
        vertices, notch collapse, and self-intersection cleanup by
        construction, and is the geometrically correct C-space for a
        circular-footprint robot (round joins; pyclipper's miter join
        overshoots convex corners).  Like the reference, which keeps
        `Execute(...)[0]`, the largest output contour is returned.

    Returns (k, 2) vertices (CCW), or an empty (0, 2) array if the polygon
    vanishes (deflation larger than the inradius).
    """
    poly = np.asarray(polygon, dtype=np.float64)
    if abs(margin) < 1e-12:
        return poly.copy()
    if is_convex_polygon(poly):
        return inflate_convex_polygon(poly, margin)

    import contourpy

    lo = poly.min(axis=0) - (abs(margin) + 1e-6) * 1.5
    hi = poly.max(axis=0) + (abs(margin) + 1e-6) * 1.5
    extent = float(np.max(hi - lo))
    if resolution is None:
        # Resolve corners to ~margin/16 but bound the grid to ~1500² cells.
        resolution = max(min(extent / 512.0, abs(margin) / 16.0),
                         extent / 1500.0)
    xs = np.arange(lo[0], hi[0] + resolution, resolution)
    ys = np.arange(lo[1], hi[1] + resolution, resolution)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    sdist = signed_polygon_distance(pts, poly).reshape(gy.shape)

    gen = contourpy.contour_generator(xs, ys, sdist)
    rings = [np.asarray(r) for r in gen.lines(margin)]
    rings = [r for r in rings if r.shape[0] >= 4]
    if not rings:
        return np.zeros((0, 2))
    ring = max(rings, key=_polygon_area)
    if np.allclose(ring[0], ring[-1]):
        ring = ring[:-1]
    ring = _simplify_ring(ring, tol=resolution * 0.75)
    # Canonical CCW orientation.
    x, y = ring[:, 0], ring[:, 1]
    if float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)) < 0:
        ring = ring[::-1]
    return ring


def point_in_polygon(point: np.ndarray, polygon: np.ndarray) -> bool:
    """Ray-casting point-in-polygon (host-side; replaces shapely contains)."""
    x, y = float(point[0]), float(point[1])
    poly = np.asarray(polygon, dtype=np.float64)
    n = poly.shape[0]
    inside = False
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi
            if x < x_cross:
                inside = not inside
        j = i
    return inside


def polygon_distance(point: np.ndarray, polygon: np.ndarray) -> float:
    """Distance from point to polygon (0 if inside); replaces shapely."""
    if point_in_polygon(point, polygon):
        return 0.0
    poly = np.asarray(polygon, dtype=np.float64)
    a = poly
    b = np.roll(poly, -1, axis=0)
    d = lineseg_dists(np.asarray(point, dtype=np.float64)[None, :2], a, b)
    return float(d.min())
