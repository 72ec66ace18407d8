"""Multimodal (SWTA network) motion predictor, the port of
`dyobav_tpu.predictors.mmp`.

`MmpInterface.get_motion_prediction(input_traj, ref_image, pred_offset,
rescale, batch_size)` returns one (num_hypos, 2) array per horizon offset,
in pixels.  All offsets are rasterized in one call (they share 6 of the 7
channels) and run through the net as one batch.  The obstacle snap, which
the reference recomputes as a full-map distance field per predicted point
(`utils_np.get_closest_edge_point`), is a nearest-edge lookup table built
once per map (scipy's exact distance transform) and a gather per point.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..configs import WtaNetConfiguration
from ..models.heatmap import pad_traj, traj_to_input_stack
from ..models.wta_net import full_f32, load_checkpoint
from ..ops.engine import resolve_device, to_host

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ObstacleSnapper:
    """Per-map snap table: for every occupied cell, the nearest free-edge
    cell, computed once."""

    def __init__(self, occupancy: np.ndarray):
        from scipy import ndimage

        occ = np.asarray(occupancy, dtype=np.float64)
        occ = occ / max(occ.max(), 1e-9)
        occupied = occ > 0
        # Edge = boundary ring of the dilated obstacle mask
        # (utils_np.py:131-133 uses dilation + roberts edge filter).
        dilated = ndimage.binary_dilation(occupied, np.ones((3, 3)))
        eroded = ndimage.binary_erosion(dilated)
        edge = dilated & ~eroded
        self.occupied = occupied
        self.nearest = None         # (2, H, W): row/col of nearest edge cell
        if edge.any():
            _, self.nearest = ndimage.distance_transform_edt(
                ~edge, return_indices=True)

    def tables(self) -> Optional[np.ndarray]:
        """(3, H, W) gather tables (nearest row, nearest col, occupied mask)
        for the snap inside `sim.batch.make_wta_predictor`."""
        if self.nearest is None:
            return None
        return np.stack([self.nearest[0], self.nearest[1],
                         self.occupied.astype(self.nearest.dtype)])

    def snap(self, points: np.ndarray) -> np.ndarray:
        """Move points lying inside obstacles to the nearest edge (order
        preserved, unlike the reference, which reorders snapped points)."""
        if self.nearest is None:
            return points
        pts = np.array(points, dtype=np.float64)
        H, W = self.occupied.shape
        cols = np.clip(pts[:, 0].astype(int), 0, W - 1)
        rows = np.clip(pts[:, 1].astype(int), 0, H - 1)
        inside = self.occupied[rows, cols]
        pts[inside, 0] = self.nearest[1][rows, cols][inside]
        pts[inside, 1] = self.nearest[0][rows, cols][inside]
        return pts


class MmpInterface:
    """The SWTA predictor behind the reference's `MmpInterface` API, on
    `device` (None: the current CUDA device; raises without one)."""

    def __init__(self, config: WtaNetConfiguration | None = None,
                 checkpoint_path: Optional[str] = None, net=None,
                 device=None):
        self.config = config or WtaNetConfiguration()
        self.device = resolve_device(device)
        if net is None:
            path = checkpoint_path or os.path.join(REPO_ROOT,
                                                   self.config.model_path)
            net = load_checkpoint(path, self.device, self.config)
        self.net = net
        self._snapper: ObstacleSnapper | None = None
        self._snapper_src: np.ndarray | None = None
        self._dev_map: torch.Tensor | None = None
        self._dev_map_src: np.ndarray | None = None

    def _get_snapper(self, ref_image: np.ndarray) -> ObstacleSnapper:
        # Keyed on object identity, holding the keyed array so that a
        # collected id can never alias another map.
        if self._snapper is None or self._snapper_src is not ref_image:
            self._snapper = ObstacleSnapper(255.0 - np.asarray(ref_image))
            self._snapper_src = ref_image
        return self._snapper

    def inference(self, images: torch.Tensor) -> np.ndarray:
        """(B, 7, H, W) input stacks -> (B, num_hypos, dim_out) hypotheses
        as numpy, in full float32."""
        with torch.no_grad(), full_f32():
            return to_host(self.net(images.to(self.device)))

    def get_motion_prediction(self, input_traj: List[tuple],
                              ref_image: np.ndarray, pred_offset: int,
                              rescale: float = 1.0, batch_size: int = 5
                              ) -> List[np.ndarray] | None:
        """One (num_hypos, 2) array per offset 1..pred_offset (px).
        `batch_size` is accepted for the reference's API: every offset
        runs in one batch."""
        if input_traj is None:
            return None
        traj = [[c * rescale for c in p[:2]] for p in input_traj]
        traj = np.asarray(pad_traj(traj, self.config.obsv_len), np.float32)
        if self._dev_map is None or self._dev_map_src is not ref_image:
            self._dev_map = torch.as_tensor(np.asarray(ref_image),
                                            dtype=torch.float32,
                                            device=self.device)
            self._dev_map_src = ref_image
        offsets = torch.arange(1, pred_offset + 1, dtype=torch.float32,
                               device=self.device)
        stack = traj_to_input_stack(
            torch.as_tensor(traj, device=self.device), self._dev_map,
            offsets, obsv_len=self.config.obsv_len)
        hypos = self.inference(stack)                        # (T, M, 2)
        snapper = self._get_snapper(ref_image)
        return [snapper.snap(hypos[t]) / rescale for t in range(pred_offset)]
