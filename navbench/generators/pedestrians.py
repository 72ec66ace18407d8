"""Pedestrian histories on the warehouse map: the generator of the
`pedestrians` traffic mixes.

Call i of a run gets `lanes` histories of `obsv_len` positions, one a
control period apart, each a pedestrian walking the map's free space
(gray > 127.5) at a speed drawn from [speed_min, speed_max] m/s, its
heading drifting by `turn_sigma` rad a step and redrawn where the next
position would leave the free space.  Everything is drawn from (seed, i),
so a call's inputs are known without keeping them.
"""
from __future__ import annotations

import numpy as np


class PedestrianHistories:
    def __init__(self, traffic: dict, map_cfg: dict, gray: np.ndarray,
                 seed: int):
        self.t, self.m, self.seed = traffic, map_cfg, int(seed)
        self.free = np.asarray(gray) > 127.5
        self.ys, self.xs = np.nonzero(self.free)

    def _on_free(self, p) -> bool:
        H, W = self.free.shape
        return (0 <= p[0] < W and 0 <= p[1] < H
                and bool(self.free[int(p[1]), int(p[0])]))

    def to_world(self, px: np.ndarray) -> np.ndarray:
        """Map pixels (x right, y down) to world metres."""
        m = self.m
        k, (bx, by) = m["scale2real"], m["corner_coords"]
        y = px[..., 1]
        if not m["image_axis"]:
            y = m["sim_height"] - y
        return np.stack([px[..., 0] * k + bx, y * k + by], -1)

    def call(self, i: int) -> np.ndarray:
        """(lanes, obsv_len, humans, 2) world-frame histories of call i."""
        t = self.t
        rng = np.random.default_rng([self.seed, int(i)])
        L, H = t["lanes"], t["humans"]
        dt, k = t["period_s"], self.m["scale2real"]
        out = np.zeros((L, t["obsv_len"], H, 2))
        for lane in range(L):
            for h in range(H):
                j = rng.integers(len(self.xs))
                p = np.array([self.xs[j], self.ys[j]], np.float64) \
                    + rng.uniform(0, 1, 2)
                heading = rng.uniform(0, 2 * np.pi)
                step = rng.uniform(t["speed_min"], t["speed_max"]) * dt / k
                for s in range(t["obsv_len"]):
                    out[lane, s, h] = p
                    heading += rng.normal(0, t["turn_sigma"])
                    for _ in range(16):
                        q = p + step * np.array([np.cos(heading),
                                                 np.sin(heading)])
                        if self._on_free(q):
                            p = q
                            break
                        heading = rng.uniform(0, 2 * np.pi)
        return self.to_world(out).astype(np.float32)
