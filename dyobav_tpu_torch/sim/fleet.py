"""Decentralized multi-robot fleet simulation (scenario-batched), the port of
`dyobav_tpu.sim.fleet`.

The reference's solver consumes other-robot parameters -- current states
`others0` and predicted trajectories `others_pred` (mpc_builder.py:52-53,
cost_fleet_collision mpc_cost.py:65-76) -- but no in-tree harness ever
populates them.  This module closes that loop: R robots per scenario run
receding-horizon NMPC simultaneously, each avoiding the others through
their previous-step predicted trajectories (decentralized,
communicated-plan MPC).

As in `sim.batch`, the batch is written out: every tensor carries the
leading dims (B, R), the solver sees the (B*R) lanes flattened b-major
(lane = b*R + r), and the `lax.scan` over time is a Python loop.  A step
syncs with the host once, in the multistart's `any_lane`.

Slot conventions (matching the reference cost semantics, which skips
`others0` slot 0 in the "current" fleet term -- mpc_builder.py:86-87):
  others0 slot 0      = the ego robot itself (inert by construction),
  others0 slots 1..   = other robots' current states, FAR-padded;
  others_pred slot 0  = FAR (the predictive term uses every slot),
  others_pred 1..     = other robots' predicted trajectories, FAR-padded.
A finished robot parks at its goal and keeps repelling others as a static
plan (its "prediction" broadcasts its parked state).

Random numbers: the pedestrian stagger is drawn up front per scenario from
`torch.Generator().manual_seed(seeds[b])`, as `build_batch_sim` draws it;
the JAX package draws it in-graph from `jax.random`.  Runs of the two
packages therefore agree lane by lane only with `human_stagger=0` or no
pedestrian.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration)
from ..motion.models import unicycle_step
from ..ops import costs
from ..ops.engine import resolve_device
from ..ops.params import tuning_vector
from .batch import (FAR_COORD, HUMAN_SIZE, build_lane_solvers,
                    cv_predict_horizon, draw_stagger, human_waypoint_step,
                    lane_params, point_in_any_quad, polygon_edge_distances,
                    ref_window_select, scenario_to_device)


class FleetScenario(NamedTuple):
    """Fixed-size tensors for one R-robot episode (batch by stacking).  The
    scenario constructors return numpy arrays; `build_fleet_sim`'s `run`
    moves them to its device."""
    robot_starts: torch.Tensor   # (R, 3)
    goals: torch.Tensor          # (R, 3)
    ref_trajs: torch.Tensor      # (R, P, 3) padded constant-speed references
    ref_lens: torch.Tensor       # (R,)
    all_stc: torch.Tensor        # (M, nstcobs) halfspaces of ALL obstacles
    all_polys: torch.Tensor      # (M, 4, 2) obstacle rectangles (FAR-padded)
    human_starts: torch.Tensor   # (H, 2) -- H may be 0
    human_paths: torch.Tensor    # (H, W, 2)
    human_path_len: torch.Tensor # (H,)


class FleetState(NamedTuple):
    """The state of every scenario; all fields carry the lane dim B first.
    Integer fields are int64.  (The JAX package's per-scenario PRNG key has
    no counterpart: the stagger stream is drawn up front.)"""
    robots: torch.Tensor         # (B, R, 3)
    pred: torch.Tensor           # (B, R, N, ns) last predicted states
    u_prev: torch.Tensor         # (B, R, 2)
    u_warm: torch.Tensor         # (B, R, nu*N)
    ref_idx: torch.Tensor        # (B, R)
    done: torch.Tensor           # (B, R) bool
    collided: torch.Tensor       # (B, R) bool (human, robot-robot, static)
    min_inter: torch.Tensor      # (B,) min inter-robot center distance
    min_clearance: torch.Tensor  # (B, R) min robot-human distance so far
    min_static: torch.Tensor     # (B, R) min static-boundary distance
    solver_fails: torch.Tensor   # (B, R) non-converged steps per robot
    overflow_steps: torch.Tensor # (B, R) multistart cold-cap overflows
    u_prev2: torch.Tensor        # (B, R, 2) action two steps back
    n_actions: torch.Tensor      # (B, R) actions applied while active
    sum_jerk: torch.Tensor       # (B, R, 2) sum |d2(v, w)|
    sum_dev: torch.Tensor        # (B, R) sum of per-step min ref distance
    max_dev: torch.Tensor        # (B, R) max of the same
    humans: torch.Tensor         # (B, H, 2)
    human_wp: torch.Tensor       # (B, H)
    human_hist: torch.Tensor     # (B, 5, H, 2)


class FleetResult(NamedTuple):
    success: torch.Tensor        # (B,) all robots done, none collided
    done: torch.Tensor           # (B, R)
    collided: torch.Tensor       # (B, R)
    min_inter_robot: torch.Tensor  # (B,) (inf when R == 1)
    min_clearance: torch.Tensor  # (B, R) vs humans (inf when H == 0)
    final_states: torch.Tensor   # (B, R, 3)
    steps_used: torch.Tensor     # (B,)
    min_static_clearance: torch.Tensor  # (B, R)
    solver_fail_steps: torch.Tensor     # (B, R)
    # Reference eval-protocol metrics (main_pre.py:34-53), per robot.
    smoothness: torch.Tensor     # (B, R, 2) mean |d2v|, |d2w|
    deviation_mean: torch.Tensor # (B, R)
    deviation_max: torch.Tensor  # (B, R)
    escalation_overflow_steps: torch.Tensor  # (B, R)


def build_fleet_sim(cfg: MpcConfiguration,
                    robot_cfg: CircularRobotSpecification,
                    solver_cfg: SolverConfiguration | None = None,
                    n_robots: int = 2, n_steps: int = 120,
                    human_vmax: float = 1.5, human_stagger: float = 0.5,
                    predictor=None, escalate: bool = True,
                    multistart: bool = True, dtype=torch.float32,
                    device=None):
    """Returns run(batch: FleetScenario[B], seeds) -> FleetResult on
    `device` (None: the current CUDA device; raises without one).

    n_robots must be <= cfg.Nother + 1 (the JAX package's guard; slot 0 is
    reserved for the ego, see module docstring).  As there, n_robots =
    cfg.Nother + 1 passes the guard but does not fit the other-robot slots:
    the first step raises.

    Collision and solver semantics match `build_batch_sim`: per-step static
    polygon containment + human proximity + robot-robot disks, and the
    production solve over the flattened B*R lanes (the multistart decision
    rule, or with multistart=False the escalation ladder).
    predictor: optional `hist (B, 5, H, 2) -> (mu (B, N, K, 2), std (B, N,
    K, 2), alpha (B, N, K))`, the contract of `build_batch_sim`, called once
    a step for the B scenarios; default: the constant-velocity prediction
    over the whole history ring.
    """
    if n_robots > cfg.Nother + 1:
        raise ValueError(
            f"n_robots={n_robots} exceeds solver capacity Nother+1="
            f"{cfg.Nother + 1}")
    device = resolve_device(device)
    scfg = solver_cfg or SolverConfiguration()
    N, ns, nu = cfg.N_hor, cfg.ns, cfg.nu
    R = n_robots
    ts = cfg.ts
    base_speed = robot_cfg.lin_vel_max * 0.8      # 'work' mode
    q_vec = torch.as_tensor(tuning_vector(cfg), dtype=dtype, device=device)
    # Collision predicate follows the harness's point-robot convention
    # (humans collide at dist <= HUMAN_SIZE, not + robot radius): the ego
    # point hits the other robot's disk.  The solver's soft fleet cost
    # (safe_distance = vehicle_width) equilibrates passes at about
    # vehicle_width center distance, so this threshold is at 2x margin.
    collide_dist = 0.5 * robot_cfg.vehicle_width

    # Row i lists the other robots' indices for robot i, ascending.
    others_idx = torch.as_tensor(
        np.array([[j for j in range(R) if j != i] for i in range(R)],
                 np.int64).reshape(R, R - 1), device=device)
    pad = cfg.Nother - R                          # FAR slots after them
    not_self = torch.logical_not(torch.eye(R, dtype=torch.bool,
                                           device=device))

    _, cold_solve, solve_batch, solve_batch_ms = build_lane_solvers(
        cfg, robot_cfg, scfg, escalate=escalate, dtype=dtype, device=device)
    predict_fn = (predictor if predictor is not None
                  else lambda hist: cv_predict_horizon(hist, N))
    robot_step = vmap(lambda s, a: unicycle_step(s, a, ts))
    rollout = vmap(lambda s, uu: costs.rollout_states(s, uu.reshape(N, nu),
                                                      ts))

    def per_robot(x):
        """(B, ...) -> (B*R, ...): a scenario's tensor for each robot."""
        return x.repeat_interleave(R, dim=0)

    def far(*shape):
        return torch.full(shape, FAR_COORD, dtype=dtype, device=device)

    def assemble_step(sc: FleetScenario, st: FleetState):
        """Pre-solve work: windows + prediction + the B*R parameter sets."""
        B = st.robots.shape[0]
        windows, ref_idx = ref_window_select(
            sc.ref_trajs.flatten(0, 1), sc.ref_lens.flatten(),
            st.ref_idx.flatten(), st.robots.flatten(0, 1), N,
            cfg.action_steps)
        prediction = tuple(per_robot(x) for x in predict_fn(st.human_hist))
        P = lane_params(cfg, q_vec, base_speed, per_robot(sc.all_polys),
                        per_robot(sc.all_stc), st.robots.flatten(0, 1),
                        per_robot(st.humans), prediction,
                        st.u_prev.flatten(0, 1), windows, dtype)
        # (B, R, Nother, ns) and (B, R, Nother, N, ns).
        others0 = torch.cat([
            st.robots[:, :, None], st.robots[:, others_idx],
            far(B, R, pad, ns)], dim=2)
        others_pred = torch.cat([
            far(B, R, 1, N, ns), st.pred[:, others_idx],
            far(B, R, pad, N, ns)], dim=2)
        P = P._replace(others0=others0.flatten(0, 1),
                       others_pred=others_pred.flatten(0, 1))
        return P, ref_idx.reshape(B, R)

    def apply_step(sc: FleetScenario, st: FleetState, u, solver_ok, overflow,
                   ref_idx, stagger) -> FleetState:
        """Post-solve work (u: (B, R, nu*N))."""
        B, H = st.humans.shape[:2]
        actions = u[..., :2]
        actions = torch.where(actions[..., :1] < 0, torch.zeros_like(actions),
                              actions)                       # no reverse
        robots_new = robot_step(st.robots.flatten(0, 1),
                                actions.flatten(0, 1))
        pred_new = rollout(robots_new, u.flatten(0, 1)).reshape(B, R, N, ns)
        pos_flat = robots_new[:, :2]
        robots_new = robots_new.reshape(B, R, ns)
        pos = robots_new[..., :2]

        # The pedestrian branch is static on H: with none, amin over an
        # empty dim would raise.
        if H > 0:
            humans_new, wp_new = human_waypoint_step(
                st.humans, st.human_wp, sc.human_paths, sc.human_path_len,
                None, human_vmax, human_stagger, ts, stagger=stagger)
            hist_new = torch.cat([st.human_hist[:, 1:], humans_new[:, None]],
                                 1)
            d_humans = torch.amin(torch.linalg.norm(
                pos[:, :, None] - humans_new[:, None], dim=-1), dim=2)
        else:
            humans_new, wp_new = st.humans, st.human_wp
            hist_new = st.human_hist
            d_humans = torch.full((B, R), float("inf"), dtype=dtype,
                                  device=device)

        # Pairwise robot-robot distances (diagonal masked).
        dmat = torch.linalg.norm(pos[:, :, None] - pos[:, None], dim=-1)
        dmat = torch.where(not_self, dmat, torch.full_like(dmat,
                                                           float("inf")))
        d_robot = torch.amin(dmat, dim=2)                    # inf for R == 1
        # Static polygons -- same harness semantics as build_batch_sim.
        polys = per_robot(sc.all_polys)
        d_static = torch.amin(polygon_edge_distances(polys, pos_flat),
                              dim=1).reshape(B, R)
        inside_static = point_in_any_quad(pos_flat, polys).reshape(B, R)
        collided_now = ((d_humans <= HUMAN_SIZE) | (d_robot <= collide_dist)
                        | inside_static)

        # Box termination test, matching the tracker (see sim.batch).
        done_now = (torch.all(torch.abs(pos - sc.goals[..., :2]) <= 0.5,
                              dim=-1)
                    & (torch.abs(actions[..., 0]) < 0.4))

        # Reference eval-protocol accumulators (see sim.batch.apply_step).
        jerk = torch.abs(actions - 2.0 * st.u_prev + st.u_prev2)  # (B, R, 2)
        jerk_valid = st.n_actions >= 2
        dev_all = torch.linalg.norm(
            pos[:, :, None] - sc.ref_trajs[..., :2], dim=-1)     # (B, R, P)
        in_ref = (torch.arange(dev_all.shape[2], device=device)
                  < sc.ref_lens[..., None])
        dev = torch.amin(torch.where(
            in_ref, dev_all, torch.full_like(dev_all, float("inf"))), dim=2)

        frozen = st.done | st.collided
        active = torch.logical_not(frozen)

        def keep(new, old):
            return torch.where(
                frozen.reshape(frozen.shape + (1,) * (new.ndim - 2)), old,
                new)

        warm = torch.cat([u[..., 2:], u[..., -2:]], dim=-1)
        # Parked robots repel as a static plan: broadcast the state they
        # held before this step.
        parked_pred = st.robots[:, :, None].expand(-1, -1, N, -1)
        return FleetState(
            robots=keep(robots_new, st.robots),
            pred=keep(pred_new, parked_pred),
            u_prev=keep(actions, st.u_prev),
            u_warm=keep(warm, st.u_warm),
            ref_idx=keep(ref_idx, st.ref_idx),
            done=st.done | (done_now & active),
            collided=st.collided | (collided_now & active),
            min_inter=torch.minimum(st.min_inter, torch.amin(dmat,
                                                             dim=(1, 2))),
            min_clearance=keep(torch.minimum(st.min_clearance, d_humans),
                               st.min_clearance),
            min_static=keep(torch.minimum(st.min_static, d_static),
                            st.min_static),
            solver_fails=st.solver_fails
            + (active & torch.logical_not(solver_ok)).long(),
            overflow_steps=st.overflow_steps + (active & overflow).long(),
            u_prev2=keep(st.u_prev, st.u_prev2),
            n_actions=st.n_actions + active.long(),
            sum_jerk=torch.where((frozen | ~jerk_valid)[..., None],
                                 st.sum_jerk, st.sum_jerk + jerk),
            sum_dev=keep(st.sum_dev + dev, st.sum_dev),
            max_dev=keep(torch.maximum(st.max_dev, dev), st.max_dev),
            humans=humans_new, human_wp=wp_new, human_hist=hist_new)

    def init_state(sc: FleetScenario) -> FleetState:
        B, H = sc.human_starts.shape[:2]

        def zeros(*shape, dt=dtype):
            return torch.zeros((B,) + shape, dtype=dt, device=device)

        return FleetState(
            robots=sc.robot_starts,
            pred=sc.robot_starts[:, :, None].expand(-1, -1, N, -1),
            u_prev=zeros(R, 2),
            u_warm=torch.tensor([base_speed, 0.0], dtype=dtype,
                                device=device).repeat(N).expand(B, R, -1),
            ref_idx=zeros(R, dt=torch.long),
            done=zeros(R, dt=torch.bool), collided=zeros(R, dt=torch.bool),
            min_inter=zeros() + float("inf"),
            min_clearance=zeros(R) + float("inf"),
            min_static=zeros(R) + float("inf"),
            solver_fails=zeros(R, dt=torch.long),
            overflow_steps=zeros(R, dt=torch.long),
            u_prev2=zeros(R, 2), n_actions=zeros(R, dt=torch.long),
            sum_jerk=zeros(R, 2), sum_dev=zeros(R), max_dev=zeros(R),
            humans=sc.human_starts, human_wp=zeros(H, dt=torch.long),
            human_hist=sc.human_starts[:, None].expand(-1, 5, -1, -1))

    def run(batch: FleetScenario, seeds) -> FleetResult:
        sc = scenario_to_device(batch, device, dtype)
        B, H = sc.human_starts.shape[:2]
        if sc.robot_starts.shape[1] != R:
            raise ValueError(f"the scenarios hold {sc.robot_starts.shape[1]} "
                             f"robots, the sim was built for {R}")
        stag = torch.stack([
            draw_stagger((n_steps, H), human_stagger,
                         torch.Generator().manual_seed(int(s)), dtype)
            for s in torch.as_tensor(seeds).reshape(-1).tolist()]).to(device)
        st = init_state(sc)

        if cold_solve is not None:
            P0, _ = assemble_step(sc, st)
            st = st._replace(u_warm=cold_solve(
                P0, st.u_warm.flatten(0, 1)).u.reshape(B, R, -1))

        steps_used = torch.zeros(B, dtype=torch.long, device=device)
        for k in range(n_steps):
            P, ref_idx = assemble_step(sc, st)
            if multistart:
                # The tracker's decision rule per robot lane over the
                # flattened (B*R) batch.
                res, overflow = solve_batch_ms(P, st.u_warm.flatten(0, 1),
                                               st.u_prev.flatten(0, 1))
                overflow = overflow.reshape(B, R)
            else:
                res = solve_batch(P, st.u_warm.flatten(0, 1))
                overflow = torch.zeros(B, R, dtype=torch.bool, device=device)
            st = apply_step(sc, st, res.u.reshape(B, R, -1),
                            res.converged.reshape(B, R), overflow, ref_idx,
                            stag[:, k])
            steps_used += torch.logical_not(
                torch.all(st.done | st.collided, dim=1)).long()
        return FleetResult(
            success=torch.all(st.done, dim=1)
            & torch.logical_not(torch.any(st.collided, dim=1)),
            done=st.done, collided=st.collided,
            min_inter_robot=st.min_inter,
            min_clearance=st.min_clearance,
            final_states=st.robots, steps_used=steps_used,
            min_static_clearance=st.min_static,
            solver_fail_steps=st.solver_fails,
            smoothness=st.sum_jerk
            / torch.clamp(st.n_actions - 2, min=1)[..., None].to(dtype),
            deviation_mean=st.sum_dev
            / torch.clamp(st.n_actions, min=1).to(dtype),
            deviation_max=st.max_dev,
            escalation_overflow_steps=st.overflow_steps)

    return run
