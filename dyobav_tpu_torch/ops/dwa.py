"""Dynamic-Window-Approach engine, the port of `dyobav_tpu.ops.dwa`.

The reference DWA (`pkg_dwa_tracker/trajectory_tracker.py:94-355`) runs a
Python double loop over the (v, ω) window, rolling out and scoring each
candidate with numpy.  Here the whole candidate grid (n_v x n_w, 6 x 12 at
the shipped robot) is one batched rollout and one batched cost on the
engine's device: the candidates are the leading dim, the horizon a Python
loop of N_hor unicycle steps.  A fixed-size padded grid keeps the shapes
the same at every step.

Cost semantics match the reference exactly, including:
  * per-obstacle hard collision (< 0.05 m) -> inf,
  * the sqrt(i+1) later-step weighting in the per-step dynamic cost and its
    off-by-one pairing of rollout point i with prediction step i+1
    (trajectory_tracker.py:162-176),
  * the "stuck" rule rewriting ω of a slow best candidate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import CircularRobotSpecification, DwaConfiguration
from .costs import _clip
from .engine import resolve_device

# Sentinel coordinate for padded obstacles: far enough that every distance
# test is inert, small enough to stay exact in float32.
FAR = 1.0e6


class DwaGridSpec(NamedTuple):
    """Static grid dimensions derived from config (padded upper bounds)."""
    n_v: int
    n_w: int


def grid_spec(cfg: DwaConfiguration, robot: CircularRobotSpecification) -> DwaGridSpec:
    # Window width is min(2*acc*ts, full velocity range); arange needs +2 to
    # cover endpoint/rounding behavior.
    full_v = (robot.lin_vel_max - robot.lin_vel_min) / cfg.vel_resolution
    acc_v = 2.0 * robot.lin_acc_max * cfg.ts / cfg.vel_resolution
    full_w = 2.0 * robot.ang_vel_max / cfg.ang_resolution
    acc_w = 2.0 * robot.ang_acc_max * cfg.ts / cfg.ang_resolution
    return DwaGridSpec(n_v=int(min(full_v, acc_v)) + 2,
                       n_w=int(min(full_w, acc_w)) + 2)


class DwaResult(NamedTuple):
    best_u: torch.Tensor            # (2,)
    best_trajectory: torch.Tensor   # (N_hor+1, 3) incl. the current state row
    min_cost: torch.Tensor          # scalar
    all_trajectories: torch.Tensor  # (n_cand, N_hor+1, 3)
    costs: torch.Tensor             # (n_cand,) inf for colliding/padded
    valid: torch.Tensor             # (n_cand,) grid-membership mask


def _norm(x: torch.Tensor) -> torch.Tensor:
    """2-norm over the last dim, as `jnp.linalg.norm` computes it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _seg_dists(points: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Distances (..., P, E) from points (..., P, 2) to the segments a -> b
    (..., E, 2); leading dims broadcast."""
    d = b - a
    len_sq = torch.sum(d * d, dim=-1) + 1e-16
    rel = points[..., :, None, :] - a[..., None, :, :]
    t = _clip(torch.sum(rel * d[..., None, :, :], dim=-1)
              / len_sq[..., None, :], 0.0, 1.0)
    closest = a[..., None, :, :] + t[..., None] * d[..., None, :, :]
    return _norm(points[..., :, None, :] - closest)


def build_dwa_engine(cfg: DwaConfiguration, robot: CircularRobotSpecification,
                     max_static_obs: int = 64, max_dyn_obs: int = 16,
                     device=None):
    """Returns (step, grid spec), step with the signature
    step(state, u_all, valid, goal, ref_path, base_speed, static_obs,
    dyn_obs_steps) -> DwaResult of tensors on the engine's device.

    `device` (None: the current CUDA device; raises without one) is where
    the inputs are moved and the search runs.
    u_all / valid: the host-built float64-exact candidate grid and its
        membership mask; build them with `candidate_grid(cfg, robot, spec,
        last_u)` each control step (see `candidate_grid` for why the grid
        is not built on the device).
    static_obs: (max_static_obs, 4, 2) polygon vertices, FAR-padded.
    dyn_obs_steps: (N_hor+1, max_dyn_obs, 2) predicted positions per step,
        FAR-padded (step 0 = current positions).
    ref_path: (n_ref, 2) waypoint path, last point repeated to pad.
    """
    spec = grid_spec(cfg, robot)
    dev = resolve_device(device)
    N = cfg.N_hor
    ts = cfg.ts
    weights = torch.sqrt(torch.arange(1, N + 1, dtype=torch.float32,
                                      device=dev))

    def as_input(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def derivative(s, u):
        return torch.stack([u[:, 0] * torch.cos(s[:, 2]),
                            u[:, 0] * torch.sin(s[:, 2]), u[:, 1]], dim=-1)

    def rollout(state, u):
        """(C, N+1, 3): each candidate's RK4 unicycle rollout, the action
        held over the horizon, the current state first."""
        s = state.expand(u.shape[0], -1)
        traj = [s]
        for _ in range(N):
            k1 = ts * derivative(s, u)
            k2 = ts * derivative(s + 0.5 * k1, u)
            k3 = ts * derivative(s + 0.5 * k2, u)
            k4 = ts * derivative(s + k3, u)
            s = s + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
            traj.append(s)
        return torch.stack(traj, dim=1)

    def inv_cost(dist, q):
        """0 beyond 0.5 m, else q / dist."""
        return torch.where(dist > 0.5, torch.zeros_like(dist),
                           1.0 / torch.clamp(dist, min=1e-9) * q)

    def candidate_costs(trajs, u, goal, ref_path, base_speed, static_obs,
                        dyn_obs_steps):
        """(C,) cost of each candidate, inf on a hard hit."""
        last = trajs[:, -1]                                  # (C, 3)
        # Speed cost (trajectory_tracker.py:178-179).
        cost = torch.abs(u[:, 0] - base_speed) * cfg.q_speed

        # Goal-direction cost (:128-136).
        dx = goal[0] - last[:, 0]
        dy = goal[1] - last[:, 1]
        err = torch.atan2(dy, dx) - last[:, 2]
        cost = cost + torch.abs(torch.atan2(torch.sin(err), torch.cos(err))
                                ) * cfg.q_goal_dir

        # Reference-path deviation of the final point (:181-184).
        d_ref = _seg_dists(last[:, None, :2], ref_path[:-1], ref_path[1:])
        cost = cost + torch.amin(d_ref, dim=(1, 2)) * cfg.q_ref_deviation

        # Static obstacles (:138-148): per-obstacle min distance over the
        # whole trajectory; any < 0.05 -> inf; else q / min if min < 0.5.
        d_stc = _seg_dists(trajs[:, None, :, :2], static_obs,
                           torch.roll(static_obs, -1, dims=1))  # (C, Ms, P, 4)
        obs_min = torch.amin(d_stc, dim=(2, 3))             # (C, Ms)
        hard_hit = torch.any(obs_min < 0.05, dim=1)
        cost = cost + inv_cost(torch.amin(obs_min, dim=1), cfg.q_stc_obstacle)

        # Dynamic obstacles, flat variant on current positions (:150-160).
        d_cur = _norm(trajs[:, :, None, :2] - dyn_obs_steps[0][None, None])
        min_cur = torch.amin(d_cur, dim=(1, 2))
        hard_hit = hard_hit | (min_cur < 0.2)
        cost = cost + inv_cost(min_cur, cfg.q_dyn_obstacle)

        # Per-step variant on predicted positions (:162-176): rollout point
        # i vs prediction step i+1, weighted by sqrt(i+1).
        d_step = _norm(trajs[:, :N, None, :2] - dyn_obs_steps[1:][None])
        min_step = torch.amin(d_step, dim=2) * weights       # (C, N)
        hard_hit = hard_hit | torch.any(min_step < 0.2, dim=1)
        cost = cost + inv_cost(torch.amin(min_step, dim=1),
                               cfg.q_dyn_obstacle)

        return torch.where(hard_hit, torch.full_like(cost, float("inf")),
                           cost)

    def step_fn(state, u_all, valid, goal, ref_path, base_speed, static_obs,
                dyn_obs_steps) -> DwaResult:
        state, u_all, goal, ref_path, base_speed, static_obs, dyn_obs_steps = (
            as_input(x) for x in (state, u_all, goal, ref_path, base_speed,
                                  static_obs, dyn_obs_steps))
        valid = as_input(valid, torch.bool)
        trajs = rollout(state, u_all)
        costs = candidate_costs(trajs, u_all, goal, ref_path, base_speed,
                                static_obs, dyn_obs_steps)
        costs = torch.where(valid, costs, torch.full_like(costs,
                                                          float("inf")))

        best = torch.argmin(costs)                           # first minimum
        best_u = u_all[best]
        # Stuck escape (:345-346): a slow best candidate spins at the
        # maximum angular speed.
        spin = torch.stack([best_u[0], torch.full_like(best_u[0],
                                                       -robot.ang_vel_max)])
        best_u = torch.where(torch.abs(best_u[0]) < cfg.stuck_threshold,
                             spin, best_u)
        # Every candidate invalid or at inf cost (boxed in, or an empty
        # arange window): the reference never updates best_u from its zero
        # init and returns a stop, skipping the stuck rewrite.
        best_u = torch.where(torch.any(torch.isfinite(costs)), best_u,
                             torch.zeros_like(best_u))
        return DwaResult(
            best_u=best_u, best_trajectory=trajs[best], min_cost=costs[best],
            all_trajectories=trajs, costs=costs, valid=valid)

    return step_fn, spec


def candidate_grid(cfg: DwaConfiguration, robot: CircularRobotSpecification,
                   spec: DwaGridSpec, last_u: np.ndarray):
    """(u_all (n_v*n_w, 2), valid (n_v*n_w,)): the float64 host-side grid
    with the reference's exact `np.arange` semantics
    (trajectory_tracker.py:94-108 window + :131-132 loops), as float32.

    The grid is built on the host because the reference's window
    membership is a knife edge: the acceleration window is exactly
    2*acc*ts/resolution grid steps wide, so whether `np.arange` includes the
    top candidate depends on float noise in last_u, and a float32 grid
    makes the opposite call on some steps."""
    ts = cfg.ts
    v_lo = max(robot.lin_vel_min, float(last_u[0]) - robot.lin_acc_max * ts)
    v_hi = min(robot.lin_vel_max, float(last_u[0]) + robot.lin_acc_max * ts)
    w_lo = max(-robot.ang_vel_max, float(last_u[1]) - robot.ang_acc_max * ts)
    w_hi = min(robot.ang_vel_max, float(last_u[1]) + robot.ang_acc_max * ts)
    v = np.arange(v_lo, v_hi, cfg.vel_resolution)
    w = np.arange(w_lo, w_hi, cfg.ang_resolution)
    if len(v) > spec.n_v or len(w) > spec.n_w:
        raise ValueError(f"grid spec too small: ({len(v)},{len(w)}) vs {spec}")
    v_pad = np.full(spec.n_v, v[0] if len(v) else 0.0)
    w_pad = np.full(spec.n_w, w[0] if len(w) else 0.0)
    v_pad[:len(v)] = v
    w_pad[:len(w)] = w
    v_ok = np.arange(spec.n_v) < len(v)
    w_ok = np.arange(spec.n_w) < len(w)
    vv, ww = np.meshgrid(v_pad, w_pad, indexing="ij")
    u_all = np.stack([vv.reshape(-1), ww.reshape(-1)], axis=1)
    valid = (v_ok[:, None] & w_ok[None, :]).reshape(-1)
    return u_all.astype(np.float32), valid
