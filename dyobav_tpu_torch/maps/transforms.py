"""Coordinate transforms: pixel/sim frame ↔ real-world (ROS-style) frame.

Mirrors `basic_map/map_tf.py`: scale + offset + optional axis reversal
(ScaleOffsetReverseTransform, map_tf.py:82-152), plus generic affine and
frame-to-frame transforms (map_tf.py:46-79).
"""
from __future__ import annotations

import copy
import threading
from enum import Enum
from typing import Tuple, Union

import numpy as np


class FrameType(Enum):
    WORLD = 0
    LOCAL = 1
    UNKNOWN = 2


class Frame:
    """2-D orthogonal coordinate frame: origin + angle (map_tf.py:15-29)."""

    def __init__(self, origin: Tuple[float, float] = (0.0, 0.0),
                 angle: float = 0.0):
        self.x, self.y = origin
        self.angle = angle

    def frame_type(self, unknown: bool = False) -> FrameType:
        if unknown:
            return FrameType.UNKNOWN
        if self.x == 0 and self.y == 0 and self.angle == 0:
            return FrameType.WORLD
        return FrameType.LOCAL


class WorldFrame(Frame):
    """Singleton world frame (double-checked-lock, map_tf.py:31-44)."""

    _instance = None
    _lock = threading.Lock()

    def __new__(cls):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = super().__new__(cls)
        return cls._instance


def frame2frame_transform(state, src: Frame, dst: Frame) -> np.ndarray:
    """Transform a state between frames (map_tf.py:69-79)."""
    return affine_transform(state, dst.angle - src.angle,
                            (dst.x - src.x, dst.y - src.y))


class ScaleOffsetReverseTransform:
    def __init__(self, scale: float = 1.0, offsetx_after: float = 0.0,
                 offsety_after: float = 0.0, x_reverse: bool = False,
                 y_reverse: bool = False, x_max_before: float = 0.0,
                 y_max_before: float = 0.0):
        self.k = (scale, scale)
        self.b = (offsetx_after, offsety_after)
        self.xr = bool(x_reverse)
        self.yr = bool(y_reverse)
        self.xm = x_max_before
        self.ym = y_max_before

    def __call__(self, state: Union[list, tuple, np.ndarray],
                 forward: bool = True) -> Union[list, np.ndarray]:
        """Transform the first two components of a state; extra components
        (e.g. heading) pass through unchanged."""
        tr = list(state) if isinstance(state, tuple) else copy.copy(state)
        if forward:
            x, y = tr[0], tr[1]
            if self.xr:
                x = self.xm - x
            if self.yr:
                y = self.ym - y
            tr[0] = x * self.k[0] + self.b[0]
            tr[1] = y * self.k[1] + self.b[1]
        else:
            x = (state[0] - self.b[0]) / self.k[0]
            y = (state[1] - self.b[1]) / self.k[1]
            if self.xr:
                x = self.xm - x
            if self.yr:
                y = self.ym - y
            tr[0], tr[1] = x, y
        return tr

    def cvt_coord_x(self, x: np.ndarray, forward: bool = True) -> np.ndarray:
        if forward:
            if self.xr:
                x = self.xm - x
            return self.k[0] * x + self.b[0]
        out = (x - self.b[0]) / self.k[0]
        return self.xm - out if self.xr else out

    def cvt_coord_y(self, y: np.ndarray, forward: bool = True) -> np.ndarray:
        if forward:
            if self.yr:
                y = self.ym - y
            return self.k[1] * y + self.b[1]
        out = (y - self.b[1]) / self.k[1]
        return self.ym - out if self.yr else out

    def cvt_coords(self, x: np.ndarray, y: np.ndarray,
                   forward: bool = True) -> np.ndarray:
        """Transform coordinate arrays → (n, 2)."""
        cx = self.cvt_coord_x(np.asarray(x, dtype=np.float64), forward)
        cy = self.cvt_coord_y(np.asarray(y, dtype=np.float64), forward)
        return np.stack([cx, cy], axis=-1)


def affine_transform(state, rotation: float, translation: tuple | None = None,
                     scale: float = 1.0) -> np.ndarray:
    """2-D rotation+scale+translation of a state's position components."""
    tr = np.array(state, dtype=np.float64).reshape(-1)
    t = np.array(translation if translation is not None else (0.0, 0.0))
    c, s = np.cos(rotation), np.sin(rotation)
    R = np.array([[c, -s], [s, c]])
    tr[:2] = scale * (R @ tr[:2]) + t
    return tr
