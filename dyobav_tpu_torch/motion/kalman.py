"""Linear Kalman filter and constant-velocity / acceleration / turn state
spaces, the port of `dyobav_tpu.motion.kalman` (reference
`src/zfilter.py`: KalmanFilter :5-78, model factories :80-123).

The state-space factories and the stateful `KalmanFilter`, which the Kalman
predictor runs on the host, are numpy copies.  The filter core,
`kf_filter_and_extrapolate`, is a torch function on the tensors' device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def model_CV(ts: float = 1.0) -> List[np.ndarray]:
    """Constant-velocity state space [A, B, C, D] (zfilter.py:80-87)."""
    A = np.array([[1, 0, ts, 0], [0, 1, 0, ts], [0, 0, 1, 0], [0, 0, 0, 1]], float)
    B = np.zeros((4, 1))
    C = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], float)
    D = np.zeros((2, 1))
    return [A, B, C, D]


def model_CA(ts: float = 1.0) -> List[np.ndarray]:
    """Constant-acceleration state space (zfilter.py:89-96)."""
    A = np.array([[1, 0, ts, 0], [0, 1, 0, ts], [0, 0, 1, 0], [0, 0, 0, 1]], float)
    B = np.array([[0, 0], [0, 0], [ts, 0], [0, ts]], float)
    C = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], float)
    D = np.zeros((2, 2))
    return [A, B, C, D]


def model_CT(ts: float, state: np.ndarray, omega: float) -> List[np.ndarray]:
    """Coordinated-turn (constant speed) linearization (zfilter.py:98-123)."""
    v, phi = state[2], state[3]
    A = np.array([
        [1, 0, ts * np.cos(phi), -v * ts * np.sin(phi)],
        [0, 1, ts * np.sin(phi), v * ts * np.cos(phi)],
        [0, 0, 1, 0],
        [0, 0, 0, 1]], float)
    B = np.array([
        [-v * ts * np.sin(phi), v * (np.cos(phi) - np.cos(phi + omega * ts)) / omega],
        [v * ts * np.cos(phi), v * (np.sin(phi) - np.sin(phi + omega * ts)) / omega],
        [0, 0],
        [0, ts]], float)
    C = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], float)
    D = np.zeros((2, 2))
    return [A, B, C, D]


def kf_filter_and_extrapolate(traj: torch.Tensor, A: torch.Tensor,
                              C: torch.Tensor, P0: torch.Tensor,
                              Q: torch.Tensor, R: torch.Tensor,
                              x0: torch.Tensor, n_pred: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run predict/update over an observed trajectory, then extrapolate.

    Functional core of `KalmanFilter.inference` (zfilter.py:68-78): the
    update phase consumes traj[1:], then `n_pred` pure predictions follow
    (without evolving P, as the reference does).

    Args:
        traj: (T, 2) observed positions.  x0: (4,) initial state.
    Returns:
        (n_pred, 2) predicted positions and the final covariance (4, 4).
    """
    x, P = x0, P0
    for y in traj[1:]:
        x = A @ x
        P = A @ P @ A.T + Q
        S = R + C @ P @ C.T
        K = P @ C.T @ torch.linalg.inv(S)
        x = x + K @ (y - C @ x)
        P = P - K @ S @ K.T
    preds = []
    for _ in range(n_pred):
        x = A @ x
        preds.append(x[:2])
    return torch.stack(preds), P


class KalmanFilter:
    """Stateful API mirroring the reference (zfilter.py:5-78)."""

    def __init__(self, state_space: List[np.ndarray], P0: np.ndarray,
                 Q: np.ndarray, R: np.ndarray, pred_offset: int = 10):
        self.ss = state_space
        self.P = np.asarray(P0, float)
        self.Q = np.asarray(Q, float)
        self.R = np.asarray(R, float)
        self.offset = pred_offset
        self.ns = self.ss[0].shape[0]
        self.nu = self.ss[1].shape[1]

    def set_init_state(self, init_state: np.ndarray):
        self.X = np.asarray(init_state, float).reshape(self.ns, 1)
        self.Xs = self.X.copy()

    def predict(self, U, evolve_P: bool = True):
        A, B = self.ss[0], self.ss[1]
        self.X = A @ self.X + B @ U
        if evolve_P:
            self.P = A @ self.P @ A.T + self.Q
        return self.X

    def update(self, U, Y):
        C, D = self.ss[2], self.ss[3]
        Yh = C @ self.X + D @ U
        S = self.R + C @ self.P @ C.T
        K = self.P @ C.T @ np.linalg.inv(S)
        self.X = self.X + K @ (Y - Yh)
        self.P = self.P - K @ S @ K.T
        return self.X, K, S, Yh

    def one_step(self, U, Y):
        self.predict(U)
        self.update(U, Y)
        self.Xs = np.concatenate([self.Xs, self.X], axis=1)
        return self.X

    def inference(self, traj: np.ndarray):
        """Filter over the trajectory then extrapolate `offset` steps."""
        traj = np.asarray(traj, float)
        for i in range(traj.shape[0] - 1 + self.offset):
            if i < traj.shape[0] - 1:
                self.one_step(np.zeros((self.nu, 1)), traj[i + 1].reshape(2, 1))
            else:
                self.predict(np.zeros((self.nu, 1)), evolve_P=False)
                self.Xs = np.concatenate([self.Xs, self.X], axis=1)
        return self.X, self.P
