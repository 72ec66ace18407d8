"""A WSD-format training set of pedestrian walks on the warehouse map: the
generator of the `walks` traffic mixes.

Frozen copy of `dyobav_tpu_torch/models/data.write_synthetic_wsd` (the
1.77 M-sample WSD set is not in the repository): `videos` folders, each
with the map's `label.png` and a `data.csv` (t, id, index, x, y in pixels)
of `pedestrians` walks of `frames` frames at `speed_px` a frame on the free
space, the heading drifting and turning at walls, drawn from the seed.
`index` reads the CSVs back and builds the reference recipe's samples
(windows of obsv_len past positions, a target 1..pred_offset_max steps
ahead) in the order of the directory, the pedestrian ids and time.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..yardstick.png import gray_map


def write(root: str, label_png: str, traffic: dict, seed: int) -> str:
    free = gray_map(label_png) > 127.5
    H, W = free.shape
    ys, xs = np.nonzero(free)
    rng = np.random.default_rng(seed)
    speed = traffic["speed_px"]

    def on_free(q):
        return 0 <= q[0] < W and 0 <= q[1] < H and free[int(q[1]), int(q[0])]

    for v in range(traffic["videos"]):
        vdir = os.path.join(root, f"video_{v:03d}")
        os.makedirs(vdir, exist_ok=True)
        shutil.copyfile(label_png, os.path.join(vdir, "label.png"))
        rows = []
        for pid in range(traffic["pedestrians"]):
            k = rng.integers(len(xs))
            p = np.array([xs[k], ys[k]], np.float64) + rng.uniform(0, 1, 2)
            heading = rng.uniform(0, 2 * np.pi)
            for t in range(traffic["frames"]):
                rows.append((t, pid, t, p[0], p[1]))
                heading += rng.normal(0, 0.2)
                for _ in range(16):
                    q = p + speed * np.array([np.cos(heading),
                                              np.sin(heading)])
                    if on_free(q):
                        p = q
                        break
                    heading = rng.uniform(0, 2 * np.pi)
        np.savetxt(os.path.join(vdir, "data.csv"), np.array(rows),
                   delimiter=",", header="t,id,index,x,y", comments="",
                   fmt=["%d", "%d", "%d", "%.4f", "%.4f"])
    return root


def index(root: str, obsv_len: int, pred_offset_max: int):
    """(trajs (S, obsv_len, 2), offsets (S,), labels (S, 2)) float32."""
    trajs, offsets, labels = [], [], []
    for video in sorted(os.listdir(root)):
        csv = os.path.join(root, video, "data.csv")
        if not os.path.exists(csv):
            continue
        raw = np.genfromtxt(csv, delimiter=",", names=True)
        for pid in np.unique(raw["id"]):
            rows = raw[raw["id"] == pid]
            order = np.argsort(rows["t"])
            xy = np.stack([rows["x"][order], rows["y"][order]], 1)
            for start in range(xy.shape[0] - obsv_len + 1):
                for off in range(1, pred_offset_max + 1):
                    tgt = start + obsv_len - 1 + off
                    if tgt >= xy.shape[0]:
                        break
                    trajs.append(xy[start:start + obsv_len].astype(np.float32))
                    offsets.append(off)
                    labels.append(xy[tgt].astype(np.float32))
    return (np.stack(trajs), np.array(offsets, np.float32), np.stack(labels))
