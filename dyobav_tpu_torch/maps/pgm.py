"""PGM (P5) map-image IO.

Replaces the reference's byte-at-a-time reader
(`interfaces/map_interface.py:44-88`) with a vectorized numpy parse, and
reproduces its post-processing exactly: optional pixel inversion,
thresholding at 10, and closing the image border.
"""
from __future__ import annotations

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """Parse a binary PGM (P5) file → uint8 array (H, W).

    Handles the optional comment line after the magic number (the reference
    assumes exactly one comment line; we accept any number).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            raise ValueError(f"Not a binary PGM (P5) file: magic={magic!r}")

        def next_token_line():
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            return line

        dims = next_token_line().split()
        width, height = int(dims[0]), int(dims[1])
        depth = int(next_token_line())
        if depth > 255:
            raise NotImplementedError("16-bit PGM not supported")
        raster = np.frombuffer(f.read(width * height), dtype=np.uint8)
    return raster.reshape(height, width).copy()


def process_map_image(image: np.ndarray, inversed_pixel: bool = False) -> np.ndarray:
    """Binarize + border-close, matching `read_pgm_and_process`
    (map_interface.py:75-88): invert, threshold at 10 → {0, 255}, and zero
    the outermost pixel ring.
    """
    the_map = image.astype(np.int32)
    if inversed_pixel:
        the_map = 255 - the_map
    the_map = np.where(the_map > 10, 255, 0)
    the_map[:, [0, -1]] = 0
    the_map[[0, -1], :] = 0
    return the_map.astype(np.uint8)
