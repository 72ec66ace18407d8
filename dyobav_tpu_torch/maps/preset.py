"""Preset synthetic maps for tests and demos, the port's own copy of
`dyobav_tpu.maps.preset` (plain Python, no framework).

The counterpart of the reference's `basic_map/preset_maps/`
(`test_maps.py`: six synthetic test maps + a dynamic variant;
`scene_maps.py`: FTD/crosswalk/crossing scenes).  Each factory returns
(boundary_coords, obstacle_list) ready for `GeometricMap`.
"""
from __future__ import annotations

import math
from typing import List, Tuple

MapSpec = Tuple[List[tuple], List[List[tuple]]]


def empty_map(width: float = 10.0, height: float = 10.0) -> MapSpec:
    return ([(0, 0), (width, 0), (width, height), (0, height)], [])


def single_block(width: float = 10.0, height: float = 10.0) -> MapSpec:
    b, _ = empty_map(width, height)
    cx, cy = width / 2, height / 2
    return b, [[(cx - 1, cy - 1), (cx + 1, cy - 1),
                (cx + 1, cy + 1), (cx - 1, cy + 1)]]


def corridor(width: float = 12.0, height: float = 6.0,
             gap: float = 2.0) -> MapSpec:
    """Two blocks leaving a central corridor of the given gap."""
    b, _ = empty_map(width, height)
    y0 = (height - gap) / 2
    y1 = (height + gap) / 2
    return b, [
        [(4.0, 0.5), (8.0, 0.5), (8.0, y0), (4.0, y0)],
        [(4.0, y1), (8.0, y1), (8.0, height - 0.5), (4.0, height - 0.5)],
    ]


def slalom(width: float = 16.0, height: float = 8.0) -> MapSpec:
    b, _ = empty_map(width, height)
    obs = []
    for i, x in enumerate([4.0, 8.0, 12.0]):
        if i % 2 == 0:
            obs.append([(x - 0.6, 0.5), (x + 0.6, 0.5),
                        (x + 0.6, height * 0.6), (x - 0.6, height * 0.6)])
        else:
            obs.append([(x - 0.6, height * 0.4), (x + 0.6, height * 0.4),
                        (x + 0.6, height - 0.5), (x - 0.6, height - 0.5)])
    return b, obs


def crossing(width: float = 12.0, height: float = 12.0,
             road: float = 3.0) -> MapSpec:
    """Four corner blocks forming a crossing (scene_maps-style)."""
    b, _ = empty_map(width, height)
    m = (width - road) / 2
    obs = []
    for x0, y0 in [(0, 0), (width - m, 0), (0, height - m),
                   (width - m, height - m)]:
        obs.append([(x0, y0), (x0 + m, y0), (x0 + m, y0 + m), (x0, y0 + m)])
    return b, obs


def rotated_block(width: float = 10.0, height: float = 10.0,
                  angle: float = math.pi / 6) -> MapSpec:
    b, _ = empty_map(width, height)
    cx, cy = width / 2, height / 2
    c, s = math.cos(angle), math.sin(angle)
    corners = [(-1.2, -0.8), (1.2, -0.8), (1.2, 0.8), (-1.2, 0.8)]
    poly = [(cx + c * x - s * y, cy + s * x + c * y) for x, y in corners]
    return b, [poly]


# --------------------------------------------------------------------------
# Scene maps — the reference's preset_maps/scene_maps.py:1-46, verbatim
# geometry.  The FTD boundary is NON-convex (E-shaped), exercising the
# general polygon-offset path in GeometricMap.
# --------------------------------------------------------------------------

def ftd_map() -> MapSpec:
    """FTD (Factory Traffic Dataset) scene (scene_maps.py:11-17)."""
    boundary = [(0, 0), (10.0, 0), (10.0, 2.5), (6.0, 2.5), (6.0, 4.5),
                (10.0, 4.5), (10.0, 6.5), (6.0, 6.5), (6.0, 10.0),
                (4.0, 10.0), (4.0, 6.5), (0, 6.5), (0, 4.5), (4.0, 4.5),
                (4.0, 2.5), (0, 2.5)]
    obstacles = [[(5.3, 2.3), (5.3, 4.5), (5.7, 4.5), (5.7, 2.5)]]
    return boundary, obstacles


def crosswalk_map(with_static_obs: bool = True):
    """Crosswalk over a lane connecting two sidewalks
    (scene_maps.py:19-30).  Returns (boundary, obstacles, crossing_area)."""
    boundary = [(0.0, 0.0), (16.0, 0.0), (16.0, 10.0), (0.0, 10.0)]
    obstacles = [[(0.0, 1.5), (0.0, 1.6), (9.0, 1.6), (9.0, 1.5)],
                 [(0.0, 8.4), (0.0, 8.5), (9.0, 8.5), (9.0, 8.4)],
                 [(11.0, 1.5), (11.0, 1.6), (16.0, 1.6), (16.0, 1.5)],
                 [(11.0, 8.4), (11.0, 8.5), (16.0, 8.5), (16.0, 8.4)]]
    if with_static_obs:
        obstacles.append([(3.0, 3.3), (3.0, 3.7), (4.0, 3.7), (4.0, 3.3)])
    crossing_area = [(9.0, 1.5), (11.0, 1.5), (11.0, 8.5), (9.0, 8.5)]
    return boundary, obstacles, crossing_area


def crossing_map():
    """Four-corner road crossing with sidewalks and crossing areas
    (scene_maps.py:32-45).  Returns (boundary, obstacles, sidewalks,
    crossing_areas)."""
    boundary = [(0, 0), (12, 0), (12, 16), (0, 16)]
    obstacles = [[(0, 0), (0, 3), (3, 3), (3, 0)],
                 [(0, 9), (0, 12), (3, 12), (3, 9)],
                 [(9, 9), (9, 12), (12, 12), (12, 9)],
                 [(9, 0), (9, 3), (12, 3), (12, 0)]]
    sidewalks = [[(0, 3), (0, 4), (4, 4), (4, 0), (3, 0), (3, 3)],
                 [(0, 8), (0, 9), (3, 9), (3, 12), (4, 12), (4, 8)],
                 [(8, 8), (8, 12), (9, 12), (9, 9), (12, 9), (12, 8)],
                 [(8, 0), (8, 4), (12, 4), (12, 3), (9, 3), (9, 0)]]
    crossing_areas = [[(4, 3), (4, 4), (8, 4), (8, 3)],
                      [(3, 4), (3, 8), (4, 8), (4, 4)],
                      [(4, 8), (4, 9), (8, 9), (8, 8)],
                      [(8, 4), (8, 8), (9, 8), (9, 4)]]
    return boundary, obstacles, sidewalks, crossing_areas


PRESETS = {
    "empty": empty_map,
    "single_block": single_block,
    "corridor": corridor,
    "slalom": slalom,
    "crossing": crossing,
    "rotated_block": rotated_block,
    "ftd": ftd_map,
    "crosswalk": lambda **kw: crosswalk_map(**kw)[:2],
    "crossing_scene": lambda **kw: crossing_map()[:2],
}


def get_preset(name: str, **kwargs) -> MapSpec:
    if name not in PRESETS:
        raise KeyError(f"Unknown preset map {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)
