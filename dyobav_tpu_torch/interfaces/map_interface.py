"""Map IO adapter: raw files -> map objects (the port's copy of
`dyobav_tpu.interfaces.map_interface`).

The JAX package can run the threshold/border pass through its C++
map-compiler library; this copy always runs the numpy pass
(`maps.pgm.process_map_image`), which gives the same image.
"""
from __future__ import annotations

import os

from ..maps.geometric import GeometricMap
from ..maps.graph import NetGraph
from ..maps.occupancy import OccupancyMap
from ..maps.pgm import process_map_image, read_pgm


class MapInterface:
    def __init__(self, raw_map_dir: str):
        """raw_map_dir: directory holding the map files (absolute, or
        relative to the current working directory)."""
        self.raw_map_dir = raw_map_dir

    def get_occ_map_from_pgm(self, pgm_fname: str, occupancy_threshold: int,
                             inversed_pixel: bool = False) -> OccupancyMap:
        image = read_pgm(os.path.join(self.raw_map_dir, pgm_fname))
        processed = process_map_image(image, inversed_pixel=inversed_pixel)
        return OccupancyMap(processed, occupancy_threshold)

    def cvt_occ2geo(self, occ_map: OccupancyMap,
                    inflate_margin: float) -> GeometricMap:
        boundary, obstacles = occ_map.get_geometric_map()
        return GeometricMap(boundary, obstacles, inflate_margin=inflate_margin)

    def get_graph_from_json(self, json_fname: str) -> NetGraph:
        return NetGraph.load_from_json(
            os.path.join(self.raw_map_dir, json_fname))
