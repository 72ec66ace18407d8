"""Training-data pipeline for the SWTA predictor, the port of
`dyobav_tpu.models.data`.

The shipped WSD dataset (`data/WSD_1t20_*`) holds raw per-video trajectory
CSVs (t, id, index, x, y) and each video's `label.png`.  `WsdDataset`
builds the reference's index (sliding windows of `obsv_len` past positions
and one future position at every offset 1..pred_offset_max per
trajectory); `DataHandler` splits it 80/20 and batches it with
`np.random.default_rng(seed)`, as the JAX package does, so both packages
draw the same split and the same batches from one seed.

Batches are host-side (traj, offset, label, video) records; the 7-channel
rasterization runs on the device (`models.heatmap.traj_to_input_batch`).

The 1.77 M-sample training set is not in the repository:
`write_synthetic_wsd` writes a dataset in its format from a seed (walks on a
map's free space) for tests and smoke runs.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Sample:
    video: str          # video folder name (holds label.png)
    traj: np.ndarray    # (obsv_len, 2) past positions (px)
    offset: int         # prediction offset T (steps ahead)
    label: np.ndarray   # (2,) future position (px)


class WsdDataset:
    """Warehouse-simulation dataset over raw per-video trajectory CSVs."""

    def __init__(self, root_dir: str, obsv_len: int = 5,
                 pred_offset_max: int = 20):
        self.root_dir = root_dir
        self.obsv_len = obsv_len
        self.pred_offset_max = pred_offset_max
        self.samples: List[Sample] = []
        self._map_cache: Dict[str, np.ndarray] = {}
        self._build_index()

    def _build_index(self):
        for video in sorted(os.listdir(self.root_dir)):
            vdir = os.path.join(self.root_dir, video)
            csv_path = os.path.join(vdir, "data.csv")
            if not os.path.isdir(vdir) or not os.path.exists(csv_path):
                continue
            raw = np.genfromtxt(csv_path, delimiter=",", names=True)
            for pid in np.unique(raw["id"]):
                rows = raw[raw["id"] == pid]
                order = np.argsort(rows["t"])
                xy = np.stack([rows["x"][order], rows["y"][order]], axis=1)
                T, L = xy.shape[0], self.obsv_len
                for start in range(T - L + 1):
                    past = xy[start:start + L]
                    for off in range(1, self.pred_offset_max + 1):
                        tgt = start + L - 1 + off
                        if tgt >= T:
                            break
                        self.samples.append(Sample(
                            video=video, traj=past.astype(np.float32),
                            offset=off, label=xy[tgt].astype(np.float32)))

    def __len__(self) -> int:
        return len(self.samples)

    def ref_map(self, video: str) -> np.ndarray:
        """The video's `label.png` (8-bit RGBA, read by `maps.png`) as the
        grayscale map channel: the float64 RGB sum / 3, in float32."""
        if video not in self._map_cache:
            from ..maps.png import read_png
            img = read_png(os.path.join(self.root_dir, video, "label.png"))
            img = img[:, :, :3].astype(np.float64).sum(axis=2) / 3.0
            self._map_cache[video] = img.astype(np.float32)
        return self._map_cache[video]

    def image_shape(self) -> Tuple[int, int]:
        return self.ref_map(self.samples[0].video).shape


class DataHandler:
    """Shuffled train/val split + infinite batch iterator
    (data_handler.py:10-63 semantics: random 80/20 split, epoch reshuffle)."""

    def __init__(self, dataset: WsdDataset, batch_size: int = 20,
                 val_fraction: float = 0.2, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(dataset))
        n_val = int(len(dataset) * val_fraction)
        self.val_idx = idx[:n_val]
        self.train_idx = idx[n_val:]
        self.rng = rng
        self._pos = 0
        self._order = self.rng.permutation(self.train_idx)

    def batches_per_epoch(self) -> int:
        return max(1, len(self.train_idx) // self.batch_size)

    def _gather(self, indices) -> dict:
        samples = [self.ds.samples[i] for i in indices]
        return {
            "traj": np.stack([s.traj for s in samples]),
            "offset": np.array([s.offset for s in samples], np.float32),
            "label": np.stack([s.label for s in samples]),
            "video": [s.video for s in samples],
        }

    def next_batch(self) -> dict:
        if self._pos + self.batch_size > len(self._order):
            self._order = self.rng.permutation(self.train_idx)
            self._pos = 0
        batch = self._gather(self._order[self._pos:self._pos + self.batch_size])
        self._pos += self.batch_size
        return batch

    def val_batches(self, max_batches: int = 10):
        for i in range(0, min(len(self.val_idx),
                              max_batches * self.batch_size), self.batch_size):
            yield self._gather(self.val_idx[i:i + self.batch_size])


def rasterize_batch(batch: dict, ds: WsdDataset,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Batch records -> (B, obsv_len + 2, H, W) float32 inputs (NCHW) +
    (B, 2) labels, as numpy arrays.  One rasterization on `device` (None:
    the current CUDA device; raises without one) per map group: with a
    single warehouse map, one call for the whole batch."""
    import torch

    from ..ops.engine import resolve_device
    from .heatmap import traj_to_input_batch

    device = resolve_device(device)
    videos = batch["video"]
    H, W = ds.image_shape()
    out = np.zeros((len(videos), ds.obsv_len + 2, H, W), np.float32)
    by_video: Dict[str, List[int]] = {}
    for i, v in enumerate(videos):
        by_video.setdefault(v, []).append(i)
    for video, idxs in by_video.items():
        stack = traj_to_input_batch(
            torch.as_tensor(batch["traj"][idxs], device=device),
            torch.as_tensor(ds.ref_map(video), device=device),
            torch.as_tensor(batch["offset"][idxs], device=device),
            obsv_len=ds.obsv_len)
        out[np.asarray(idxs)] = stack.cpu().numpy()
    return out, batch["label"]


def write_synthetic_wsd(root: str, label_png: str, n_videos: int = 2,
                        n_peds: int = 4, n_frames: int = 40, seed: int = 0,
                        speed: float = 2.0) -> str:
    """Write a WSD-format dataset under `root` and return `root`:
    `n_videos` folders `video_<v>`, each with a copy of `label_png` and a
    `data.csv` (t, id, index, x, y in pixels) of `n_peds` pedestrians
    walking `n_frames` frames at `speed` px a frame on the map's free space
    (grayscale above 127.5), with a heading that drifts and turns at walls,
    all drawn from `seed`."""
    from ..maps.png import read_png

    gray = read_png(label_png)[:, :, :3].astype(np.float64).sum(axis=2) / 3.0
    free = gray > 127.5
    H, W = free.shape
    ys, xs = np.nonzero(free)
    rng = np.random.default_rng(seed)

    def on_free(q):
        return (0 <= q[0] < W and 0 <= q[1] < H
                and free[int(q[1]), int(q[0])])

    for v in range(n_videos):
        vdir = os.path.join(root, f"video_{v:03d}")
        os.makedirs(vdir, exist_ok=True)
        shutil.copyfile(label_png, os.path.join(vdir, "label.png"))
        rows = []
        for pid in range(n_peds):
            k = rng.integers(len(xs))
            p = np.array([xs[k], ys[k]], np.float64) + rng.uniform(0, 1, 2)
            heading = rng.uniform(0, 2 * np.pi)
            for t in range(n_frames):
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
