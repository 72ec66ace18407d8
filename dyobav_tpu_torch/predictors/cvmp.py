"""Constant-velocity motion predictor (the baseline predictor), the port of
`dyobav_tpu.predictors.cvmp` (reference `cvmp_interface.CvmpInterface`,
cvmp_interface.py:14-60): the mean velocity over the last <= 5 observed
points, extrapolated N_hor steps, with a fixed unit uncertainty.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..configs import MpcConfiguration


class CvmpInterface:
    def __init__(self, config: MpcConfiguration | None = None,
                 n_hor: int | None = None):
        self.config = config or MpcConfiguration()
        self.n_hor = n_hor if n_hor is not None else self.config.N_hor

    def get_motion_prediction(self, input_traj: List[tuple], ref_image=None,
                              pred_offset=None, rescale: float = 1.0,
                              batch_size=None) -> Tuple[List[list], List[list]]:
        if input_traj is None:
            return None
        traj = input_traj[-5:] if len(input_traj) > 5 else input_traj
        traj = [[x * rescale for x in y] for y in traj]
        if len(traj) > 1:
            vx = float(np.mean([traj[i + 1][0] - traj[i][0]
                                for i in range(len(traj) - 1)]))
            vy = float(np.mean([traj[i + 1][1] - traj[i][1]
                                for i in range(len(traj) - 1)]))
        else:
            vx = vy = 0.0
        positions = [[traj[-1][0] + vx * (i + 1), traj[-1][1] + vy * (i + 1)]
                     for i in range(self.n_hor)]
        uncertainty = [[1.0, 1.0]] * len(positions)
        return positions, uncertainty
