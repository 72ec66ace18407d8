"""Kalman-filter motion predictor (the baseline predictor), the port of
`dyobav_tpu.predictors.kfmp` (reference `kfmp_interface.KfmpInterface`,
kfmp_interface.py:14-60): a constant-velocity Kalman filter over the
observed points, extrapolated N_hor steps, with the filter's position
variances as the uncertainty.  Numpy on the host.

The filter's covariance carries over from one call to the next, as in the
reference: one interface serves every step of an episode.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..configs import MpcConfiguration
from ..motion.kalman import KalmanFilter, model_CV


class KfmpInterface:
    def __init__(self, config: MpcConfiguration | None = None,
                 Q: np.ndarray | None = None, R: np.ndarray | None = None,
                 state_space=None, n_hor: int | None = None, ts: float | None = None):
        config = config or MpcConfiguration()
        self.config = config
        ts = ts if ts is not None else config.ts
        n_hor = n_hor if n_hor is not None else config.N_hor
        self.state_space = state_space if state_space is not None else model_CV(ts)
        self.kf = KalmanFilter(self.state_space, P0=np.eye(4),
                               Q=Q if Q is not None else np.eye(4),
                               R=R if R is not None else np.eye(2),
                               pred_offset=n_hor)

    def get_motion_prediction(self, input_traj: List[tuple], ref_image=None,
                              pred_offset=None, rescale: float = 1.0,
                              batch_size=None) -> Tuple[List[list], List[list]]:
        if input_traj is None:
            return None
        traj = [[x * rescale for x in y] for y in input_traj]
        if len(traj) > 1:
            init = np.array([traj[0][0], traj[0][1],
                             traj[1][0] - traj[0][0],
                             traj[1][1] - traj[0][1]]).reshape(4, 1)
        else:
            init = np.array([traj[0][0], traj[0][1], 0.0, 0.0]).reshape(4, 1)
        self.kf.set_init_state(init)
        _, P = self.kf.inference(np.array(traj))
        positions = self.kf.Xs[:2, len(traj):].T.tolist()
        uncertainty = [[P[0, 0], P[1, 1]]] * len(positions)
        return positions, uncertainty
