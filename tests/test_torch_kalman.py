"""The port's Kalman filter (`dyobav_tpu_torch.motion.kalman`) and Kalman
predictor (`predictors.kfmp`) against the JAX package's, on seeded inputs.

The state-space factories and the stateful filter are numpy copies: they
must agree to 1e-12.  `kf_filter_and_extrapolate` is a torch function held
to the JAX one (both float32) within 1e-5 of the trajectory's scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.motion import kalman as jk
from dyobav_tpu.predictors.kfmp import KfmpInterface as JKfmp
from dyobav_tpu_torch.motion import kalman as tk
from dyobav_tpu_torch.predictors.kfmp import KfmpInterface as TKfmp

torch.set_num_threads(1)


def _walk(seed: int, T: int) -> np.ndarray:
    """A noisy constant-velocity walk of T points (m)."""
    rng = np.random.default_rng(seed)
    start, vel = rng.uniform(-10, 10, 2), rng.uniform(-0.4, 0.4, 2)
    return start + vel * np.arange(T)[:, None] + rng.normal(0, 0.05, (T, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_spaces_and_filter_match_jax(seed):
    rng = np.random.default_rng(seed)
    ts = float(rng.uniform(0.1, 0.5))
    state = rng.uniform(-1, 1, 4)
    omega = float(rng.uniform(0.2, 1.0))
    for tm, jm in ((tk.model_CV(ts), jk.model_CV(ts)),
                   (tk.model_CA(ts), jk.model_CA(ts)),
                   (tk.model_CT(ts, state, omega),
                    jk.model_CT(ts, state, omega))):
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    traj = _walk(seed, 8)
    Q = np.diag(rng.uniform(0.5, 2.0, 4))
    R = np.diag(rng.uniform(0.5, 2.0, 2))
    filters = [mod.KalmanFilter(mod.model_CV(ts), np.eye(4), Q, R,
                                pred_offset=6) for mod in (tk, jk)]
    outs = []
    for kf in filters:
        kf.set_init_state(np.array([*traj[0], 0.0, 0.0]))
        X, P = kf.inference(traj)
        outs.append((X, P, kf.Xs))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert outs[0][2].shape == (4, len(traj) + 6)


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_and_extrapolate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    traj = _walk(seed, 10).astype(np.float32)
    A, _, C, _ = tk.model_CV(0.2)
    P0 = np.eye(4) * rng.uniform(0.5, 2.0)
    Q, R = np.eye(4) * 0.1, np.eye(2) * 0.5
    x0 = np.array([*traj[0], 0.0, 0.0])
    args = [x.astype(np.float32) for x in (A, C, P0, Q, R, x0)]
    pj, Pj = jk.kf_filter_and_extrapolate(
        jnp.asarray(traj), *[jnp.asarray(a) for a in args], n_pred=20)
    pt, Pt = tk.kf_filter_and_extrapolate(
        torch.tensor(traj), *[torch.tensor(a) for a in args], n_pred=20)
    assert pt.shape == (20, 2) and Pt.shape == (4, 4)
    scale = max(1.0, float(np.abs(traj).max()))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=0, atol=1e-5)
    # The stateful filter (float64) lands on the same extrapolation.
    kf = tk.KalmanFilter(tk.model_CV(0.2), P0, Q, R, pred_offset=20)
    kf.set_init_state(x0)
    kf.inference(traj.astype(np.float64))
    np.testing.assert_allclose(pt.numpy(), kf.Xs[:2, len(traj):].T,
                               rtol=0, atol=1e-4 * scale)


def test_kfmp_prediction_matches_jax_over_calls():
    """One interface per side over the growing past of a walk: the filter's
    covariance carries over between calls, as in the reference."""
    traj = _walk(3, 12)
    tp, jp = TKfmp(Q=np.eye(4), R=np.eye(2)), JKfmp(Q=np.eye(4), R=np.eye(2))
    assert tp.get_motion_prediction(None) is None
    for k in range(1, len(traj) + 1):
        past = traj[:k].tolist()
        (pos_t, unc_t), (pos_j, unc_j) = (tp.get_motion_prediction(past),
                                          jp.get_motion_prediction(past))
        assert len(pos_t) == len(unc_t) == 20
        np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-12)
        np.testing.assert_allclose(unc_t, unc_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp.kf.P, jp.kf.P, rtol=0, atol=1e-12)
    # A walk's prediction heads on along its velocity.
    assert np.linalg.norm(np.array(pos_t[-1]) - traj[-1]) > 1.0
