"""Scenario-batched closed-loop simulation, the port of
`dyobav_tpu.sim.batch`.

The whole control loop -- constant-velocity pedestrian prediction ->
dynamic-obstacle assembly -> local-reference-window selection ->
warm-started NMPC solve -> robot RK4 step -> pedestrian waypoint step ->
collision/termination bookkeeping -- over a batch of randomized warehouse
episodes.  The JAX package writes one scenario's step and `vmap`s it; here
the batch is written out: every function takes tensors with a leading lane
dim B, the `lax.scan` over time is a Python loop, and the two
`lax.cond(jnp.any(...))` gates are host `if`s (one device-to-host sync
each, counted by `ops.engine.any_lane`).

Host-side code only *prepares* fixed-size scenario tensors (map halfspaces,
reference trajectories, pedestrian waypoints) once per batch
(`sim.scenarios`).

Random numbers: the JAX package draws the pedestrian stagger in-graph from
`jax.random` keys, a stream PyTorch cannot reproduce.  Without a
`stagger_stream` this port draws the whole (B, n_steps, H) stream up front,
lane b from a `torch.Generator` seeded with `seeds[b]`, with the same
distribution; unseeded runs of the two packages therefore differ lane by
lane, and parity checks feed both the same `stagger_stream`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration)
from ..motion.models import unicycle_step
from ..ops import costs
from ..ops.engine import (any_lane, escalate_tail, escalation_ladder,
                          gather_slots, merge_slots, profile_configuration,
                          resolve_device)
from ..ops.newton import NewtonResult, make_alm_newton_solver
from ..ops.params import MpcParams, tuning_vector

HUMAN_SIZE = 0.2
FAR_COORD = 1.0e6     # padding sentinel for inert obstacle/waypoint slots


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, R, C), rows (B, W) -> (B, W, C): lane b's rows `rows[b]`."""
    return torch.gather(x, 1, rows[:, :, None].expand(-1, -1, x.shape[2]))


def ref_window_select(ref_traj, ref_len, ref_idx, state, N: int,
                      action_steps: int = 1):
    """The tracker's local-window selection (trajectory_tracker.py:242-270)
    for every lane: ref_traj (B, R, 3), ref_len (B,), ref_idx (B,), state
    (B, 3) -> (window (B, N, 3), idx_next (B,)).

    The candidate window spans [ref_idx - action_steps, ref_idx +
    5*action_steps); rows past `ref_len` are replicated final states by
    scenario construction.  Like `jax.lax.dynamic_slice`, both slices clamp
    their start so the slice fits, while the candidate and row indices are
    counted from the unclamped start.
    """
    W = 6 * action_steps
    R = ref_traj.shape[1]
    dev = ref_traj.device
    lb = torch.clamp(ref_idx - action_steps, min=0)
    cand = _take_rows(ref_traj, torch.clamp(lb, 0, R - W)[:, None]
                      + torch.arange(W, device=dev))
    cand_idx = lb[:, None] + torch.arange(W, device=dev)
    d = torch.hypot(cand[:, :, 0] - state[:, None, 0],
                    cand[:, :, 1] - state[:, None, 1])
    ub = torch.minimum(ref_len, ref_idx + 5 * action_steps)
    d = torch.where(cand_idx < ub[:, None], d,
                    torch.full_like(d, float("inf")))
    idx_next = lb + torch.argmin(d, dim=1)
    start = torch.clamp(idx_next, max=R - N)
    window = _take_rows(ref_traj, torch.clamp(start, 0, R - N)[:, None]
                        + torch.arange(N, device=dev))
    # Pad beyond the true end with the final reference state.
    row_idx = start[:, None] + torch.arange(N, device=dev)
    last = _take_rows(ref_traj, torch.remainder(ref_len - 1, R)[:, None])
    window = torch.where((row_idx < ref_len[:, None])[:, :, None], window,
                         last)
    return window, idx_next


def draw_stagger(shape, stagger_mag: float, generator: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """The reference's stagger noise (basic_agent.py:98-101):
    choice(+-1) * randint(0, 10) / 10 * s, drawn on the CPU."""
    sign = 1 - 2 * torch.randint(0, 2, shape, generator=generator)
    mag = torch.randint(0, 11, shape, generator=generator).to(dtype) / 10.0
    return sign.to(dtype) * mag * stagger_mag


def human_waypoint_step(humans, wp_idx, paths, path_len, generator,
                        vmax: float, stagger_mag: float, ts: float,
                        stagger=None):
    """Pedestrian waypoint-following step with the reference's stagger
    noise: humans (B, H, 2), wp_idx (B, H), paths (B, H, W, 2), path_len
    (B, H) -> (humans, wp_idx).

    Semantics mirror the harness agent (MovingAgent.run_step /
    get_next_goal / get_action): when the current waypoint is within
    vmax*ts it is popped FIRST and the step targets the NEXT node; a human
    that pops its last node stops for good.

    stagger: optional (B, H) precomputed stagger scalars for THIS step
    (already scaled); None draws them from `generator`.
    """
    def waypoint(idx):
        i = idx.clamp(0, paths.shape[2] - 1)[:, :, None, None]
        return torch.gather(paths, 2, i.expand(-1, -1, 1, 2))[:, :, 0, :]

    dist = torch.linalg.norm(waypoint(wp_idx) - humans, dim=-1)
    reach = dist < vmax * ts
    wp_idx = wp_idx + reach.to(wp_idx.dtype)              # pop
    active = wp_idx < path_len                            # any node left?
    dvec = waypoint(wp_idx) - humans
    dire = dvec / torch.clamp(torch.linalg.norm(dvec, dim=-1),
                              min=1e-9)[:, :, None]
    if stagger is None:
        stagger = draw_stagger(tuple(humans.shape[:2]), stagger_mag,
                               generator, humans.dtype).to(humans.device)
    vel = dire * vmax + stagger[:, :, None]
    humans = torch.where(active[:, :, None], humans + ts * vel, humans)
    return humans, wp_idx


def cv_predict_horizon(hist, N: int, n_valid=None):
    """Constant-velocity prediction from the 5-point history ring:
    hist (B, 5, H, 2) -> (mu (B, N, H, 2), std (B, N, H, 2), alpha
    (B, N, H)), matching CvmpInterface semantics (unit std).

    n_valid: optional (B,) count of REAL trailing steps in the ring (<= 4).
    The harness feeds cvmp `traj[-5:]` and averages over len-1 diffs; a
    freshly-started episode has fewer than 5 points, so dividing the
    telescoped (last - first) by 4 would under-estimate the velocity for
    the first 4 steps.  None keeps the full-ring mean."""
    if n_valid is None:
        vel = torch.mean(hist[:, 1:] - hist[:, :-1], dim=1)    # (B, H, 2)
    else:
        denom = torch.clamp(n_valid, 1, hist.shape[1] - 1).to(hist.dtype)
        vel = (hist[:, -1] - hist[:, 0]) / denom[:, None, None]
    steps = torch.arange(1, N + 1, dtype=hist.dtype,
                         device=hist.device)[:, None, None]
    mu = hist[:, -1][:, None] + vel[:, None] * steps
    return mu, torch.ones_like(mu), torch.ones_like(mu[..., 0])


def polygon_edge_distances(all_polys, pt):
    """all_polys (B, M, V, 2), pt (B, 2) -> (B, M) min point-to-boundary
    distance per polygon (FAR slots inert).  Boundary distance only --
    callers that need 0-when-inside combine it with `point_in_any_quad`."""
    a = all_polys
    b = torch.roll(a, -1, dims=2)
    d = b - a
    len_sq = torch.sum(d * d, dim=-1) + 1e-16
    p = pt[:, None, None, :]
    t = torch.clamp(torch.sum((p - a) * d, dim=-1) / len_sq, 0.0, 1.0)
    closest = a + t[..., None] * d
    return torch.amin(torch.linalg.norm(p - closest, dim=-1), dim=2)


def point_in_any_quad(pt, all_polys):
    """pt (B, 2), all_polys (B, M, V, 2) -> (B,) bool: strictly inside any
    convex padded polygon, the counterpart of the harness collision check's
    `Polygon.contains(Point)` (False on the boundary).  Degenerate slots
    (FAR padding, repeated vertices) contribute zero-length edges which are
    skipped, so they can never report containment."""
    a = all_polys
    e = torch.roll(a, -1, dims=2) - a
    px, py = pt[:, None, None, 0], pt[:, None, None, 1]
    cross = e[..., 0] * (py - a[..., 1]) - e[..., 1] * (px - a[..., 0])
    valid = torch.sum(e * e, dim=-1) > 1e-18
    all_pos = torch.all(torch.logical_not(valid) | (cross > 0), dim=2)
    all_neg = torch.all(torch.logical_not(valid) | (cross < 0), dim=2)
    nonempty = torch.any(valid, dim=2)
    return torch.any((all_pos | all_neg) & nonempty, dim=1)


def closest_obstacle_halfspaces(all_polys, all_stc, state, n_top: int):
    """Per-step closest-N halfspace selection: all_polys (B, M, V, 2),
    all_stc (B, M, C), state (B, 3) -> (B, n_top, C).  A stable sort breaks
    distance ties by the lower index, as `jax.lax.top_k` does (all
    FAR-padded slots tie)."""
    dist = polygon_edge_distances(all_polys, state[:, :2])
    idx = torch.sort(dist, dim=1, stable=True).indices[:, :n_top]
    return _take_rows(all_stc, idx)


def assemble_dyn_obstacles(humans, prediction, n_slots: int, n_cols: int,
                           N: int, dtype):
    """humans (B, H, 2) + the (mu, std, alpha) horizon prediction ((B, N, K,
    2), (B, N, K, 2), (B, N, K)) -> the solver's (B, Ndynobs, N+1, 6)
    dynamic-obstacle tensor.  Inactive slots mirror the harness default
    [0,0,0,0,0,1]; step 0 carries the current positions with HUMAN_SIZE
    std."""
    mu_pred, std_pred, alpha_pred = prediction
    B, H = humans.shape[:2]
    K = mu_pred.shape[2]
    if K > n_slots:
        raise ValueError(f"{K} prediction slots exceed the solver's {n_slots}"
                         " dynamic-obstacle slots (Ndynobs)")
    dev = humans.device
    dyn = torch.zeros(B, n_slots, N + 1, n_cols, dtype=dtype, device=dev)
    dyn[..., 5] = 1.0
    dyn[:, :H, 0, :] = torch.cat([
        humans.to(dtype),
        torch.full((B, H, 2), HUMAN_SIZE, dtype=dtype, device=dev),
        torch.zeros(B, H, 1, dtype=dtype, device=dev),
        torch.ones(B, H, 1, dtype=dtype, device=dev)], dim=2)
    dyn[:, :K, 1:, :] = torch.cat([
        mu_pred.transpose(1, 2), std_pred.transpose(1, 2),
        torch.zeros(B, K, N, 1, dtype=dtype, device=dev),
        alpha_pred.transpose(1, 2)[..., None]], dim=3).to(dtype)
    return dyn


def lane_params(cfg: MpcConfiguration, q_vec, base_speed: float, all_polys,
                all_stc, robot, humans, prediction, u_prev, window,
                dtype) -> MpcParams:
    """The solver's MpcParams of every lane (lane dim B first): the robot
    (B, 3), the pedestrians (B, H, 2) and their prediction, the last action,
    the reference window (B, N, 3), the nearest static obstacles of
    `all_polys` / `all_stc`, and the 'work' mode's reference speed and
    weights."""
    B, N = robot.shape[0], cfg.N_hor

    def full(shape, value):
        return torch.full((B,) + shape, value, dtype=dtype,
                          device=robot.device)

    return MpcParams(
        u_prev=u_prev, s0=robot, sN=window[:, -1],
        q=q_vec.expand(B, -1), ref_states=window,
        ref_speed=full((N,), base_speed),
        others0=full((cfg.Nother, cfg.ns), 0.0),
        others_pred=full((cfg.Nother, N, cfg.ns), 0.0),
        stc_obs=closest_obstacle_halfspaces(all_polys, all_stc, robot,
                                            cfg.Nstcobs),
        dyn_obs=assemble_dyn_obstacles(humans, prediction, cfg.Ndynobs,
                                       cfg.ndynobs, N, dtype),
        q_stc=full((N,), 10.0), q_dyn=full((N,), 10.0))


class Scenario(NamedTuple):
    """Fixed-size tensors describing one episode (batch by stacking).  The
    scenario constructors return numpy arrays; `build_batch_sim`'s `run` moves
    them to its device."""
    robot_start: torch.Tensor    # (3,)
    goal: torch.Tensor           # (3,)
    ref_traj: torch.Tensor       # (R, 3) padded constant-speed ref trajectory
    ref_len: torch.Tensor        # () true length of ref_traj
    all_stc: torch.Tensor        # (Mobs, nstcobs) halfspaces of ALL obstacles
    all_polys: torch.Tensor      # (Mobs, 4, 2) obstacle rectangles (FAR-padded)
    human_starts: torch.Tensor   # (H, 2)
    human_paths: torch.Tensor    # (H, W, 2) padded waypoints
    human_path_len: torch.Tensor # (H,)


class SimState(NamedTuple):
    """The state of every lane; all fields carry the lane dim B first.
    Integer fields are int64.  (The JAX package's per-lane PRNG key has no
    counterpart: the stagger stream is drawn up front.)"""
    robot: torch.Tensor          # (B, 3)
    humans: torch.Tensor         # (B, H, 2)
    human_wp: torch.Tensor       # (B, H) waypoint indices
    human_hist: torch.Tensor     # (B, 5, H, 2) past positions, latest last
    u_prev: torch.Tensor         # (B, 2)
    u_warm: torch.Tensor         # (B, nu*N) previous solution (warm start)
    ref_idx: torch.Tensor        # (B,)
    done: torch.Tensor           # (B,) bool: reached goal
    collided: torch.Tensor       # (B,) bool (human proximity OR inside a
                                 #   static polygon, harness semantics)
    collided_static: torch.Tensor  # (B,) bool: the static cause specifically
    min_clearance: torch.Tensor  # (B,) min human distance so far
    min_static: torch.Tensor     # (B,) min static-boundary distance so far
    solver_fails: torch.Tensor   # (B,) steps whose merged solve stayed
                                 #   non-converged
    overflow_steps: torch.Tensor # (B,) steps whose distressed lane fell
                                 #   beyond the multistart cold-slot cap
    u_prev2: torch.Tensor        # (B, 2) action two steps back (for |d2a|)
    n_actions: torch.Tensor      # (B,) actions applied while active
    sum_jerk: torch.Tensor       # (B, 2) sum |d2(v, w)| (smoothness)
    sum_dev: torch.Tensor        # (B,) sum of per-step min distance to ref
    max_dev: torch.Tensor        # (B,) max of the same


class BatchResult(NamedTuple):
    success: torch.Tensor        # (B,) reached goal without collision
    collided: torch.Tensor       # (B,)
    collided_static: torch.Tensor  # (B,) collision cause was a static polygon
    min_clearance: torch.Tensor  # (B,) vs pedestrians
    final_state: torch.Tensor    # (B, 3)
    steps_used: torch.Tensor     # (B,)
    min_static_clearance: torch.Tensor  # (B,) vs inflated static polygons
    solver_fail_steps: torch.Tensor     # (B,) non-converged steps per lane
    # Reference eval-protocol metrics (main_pre.py:34-53, main_base.py:483-506)
    smoothness: torch.Tensor     # (B, 2) mean |d2v|, mean |d2w| per episode
    deviation_mean: torch.Tensor # (B,) mean min-distance to the reference path
    deviation_max: torch.Tensor  # (B,) max of the same
    escalation_overflow_steps: torch.Tensor  # (B,) distressed-but-uncapped steps


def _lanes(P: MpcParams, fn) -> MpcParams:
    return MpcParams(*[fn(x) for x in P])


def build_lane_solvers(cfg: MpcConfiguration,
                       robot_cfg: CircularRobotSpecification,
                       scfg: SolverConfiguration, escalate: bool = True,
                       dtype=torch.float32, device=None):
    """Production solver closures for the batched simulators, each over a
    batch of lanes (P: MpcParams with the lane dim first, U0 (B, nu*N)).

    Returns (solve_warm, cold_solve, solve_batch, solve_batch_multistart):
      solve_warm(P, U0) -> NewtonResult at the warm profile;
      cold_solve -- the same at `scfg.cold_profile` (None when unset), for
        the episode's first no-warm-start solve;
      solve_batch(P, U0) -- warm solve for every lane + the gather-merge
        escalation ladder of `engine.solve_batch_escalated`
        (`engine.escalate_tail`, always from the original guess);
      solve_batch_multistart(P, U0, Uprev) -- the tracker's decision rule.
    """
    device = resolve_device(device)
    u_lo, u_hi = costs.action_bounds(cfg, robot_cfg, dtype, device)
    c_lo, c_hi = costs.acceleration_bounds(cfg, robot_cfg, dtype, device)

    def obj(u_flat, p):
        br = costs.evaluate(u_flat, p, cfg, robot_cfg)
        return br.objective, br.f1, br.f2

    def split(p):
        return costs.split_objective(p, cfg, robot_cfg)

    def make_profile_solver(prof=None):
        stage_cfg = (profile_configuration(scfg, prof) if prof
                     else dataclasses.replace(scfg, cold_profile=None))
        newton = make_alm_newton_solver(obj, u_lo, u_hi, c_lo, c_hi,
                                        stage_cfg, split=split)
        return lambda P, U0: newton(U0, P)

    solve_warm = make_profile_solver()
    cold_solve = (make_profile_solver(scfg.cold_profile)
                  if scfg.cold_profile else None)
    ladder, slots = [], lambda B: []
    if escalate and scfg.cold_profile:
        profiles, slots = escalation_ladder(scfg)
        ladder = [make_profile_solver(p[:5]) for p in profiles]
    res_tol = scfg.escalation_residual_tol

    def solve_batch(P: MpcParams, U0: torch.Tensor) -> NewtonResult:
        runs = [lambda idx, cur, stage=stage: stage(
                    _lanes(P, lambda x: x[idx]), U0[idx])
                for stage in ladder]
        return escalate_tail(solve_warm(P, U0), runs, slots(U0.shape[0]),
                             res_tol, ok_of=lambda r: r.converged)

    # ---- multistart + distress escalation: the TRACKER's decision rule
    # (trackers/mpc_tracker.py of the JAX package) as one batched program.
    # Five candidates per lane (shifted warm start, brake ramp, zeros,
    # swerve left/right), feasibility-gated argmin, and a cold-budget
    # re-solve of every distressed lane's full candidate set.  Budget-only
    # escalation of the single warm guess (solve_batch above) cannot hop
    # basins: when a pedestrian prediction newly blocks the warm basin the
    # lane stays committed and gets pushed off-path.
    N = cfg.N_hor
    nu = cfg.nu
    base_speed = robot_cfg.lin_vel_max * 0.8
    swerve_w = 0.6 * robot_cfg.ang_vel_max
    infeas_bar = scfg.multistart_infeas_factor * scfg.constraint_tol
    G = 5
    # jnp.linspace(a, 0, N) is a * (1 - i / (N - 1)) for i < N - 1, then 0.
    ramp_frac = 1.0 - torch.arange(N - 1, dtype=dtype, device=device) / (N - 1)
    arcs = torch.stack([
        torch.stack([torch.full((N,), base_speed, dtype=dtype, device=device),
                     torch.full((N,), sgn * swerve_w, dtype=dtype,
                                device=device)], dim=1).reshape(-1)
        for sgn in (1.0, -1.0)])                            # (2, nu*N)

    def make_guesses(u_warm, u_prev):
        """u_warm (B, nu*N), u_prev (B, nu) -> (B, G, nu*N)."""
        B = u_warm.shape[0]
        ramp = torch.cat([u_prev[:, :1] * ramp_frac,
                          torch.zeros(B, 1, dtype=dtype, device=device)], 1)
        brake = torch.stack([ramp, torch.zeros_like(ramp)], 2).reshape(B, -1)
        return torch.cat([
            u_warm[:, None], brake[:, None],
            torch.zeros(B, 1, nu * N, dtype=dtype, device=device),
            arcs.expand(B, -1, -1)], dim=1)

    def _best_of(res: NewtonResult, B: int):
        """(B*G, ...) candidate results -> per-lane feasibility-gated best
        and its index; also the (B, G) view."""
        res_g = NewtonResult(*[x.reshape((B, G) + x.shape[1:]) for x in res])
        score = res_g.cost + 1e6 * (res_g.infeasibility > infeas_bar).to(dtype)
        best = torch.argmin(score, dim=1)                  # first minimum
        lanes = torch.arange(B, device=best.device)
        return NewtonResult(*[x[lanes, best] for x in res_g]), best, res_g

    def solve_batch_multistart(P: MpcParams, U0: torch.Tensor,
                               Uprev: torch.Tensor):
        """Returns (result, overflow): `overflow` is a (B,) bool marking
        lanes that were distressed but fell beyond the K = B//2 cold-slot
        cap and kept their warm-profile result (the sims count it per
        lane)."""
        B = U0.shape[0]
        GU = make_guesses(U0, Uprev)                       # (B, G, nu*N)
        res = solve_warm(_lanes(P, lambda x: x.repeat_interleave(G, dim=0)),
                         GU.reshape(B * G, -1))
        sel, best, res_g = _best_of(res, B)
        distress = ((best != 0)
                    | (torch.amax(res_g.infeasibility, dim=1) > infeas_bar)
                    | torch.logical_not(sel.converged))
        if cold_solve is None:
            return sel, torch.zeros(B, dtype=torch.bool, device=U0.device)
        K = max(B // 2, min(B, 8), 1)
        overflow = distress & ((torch.cumsum(distress.to(torch.long), 0) - 1)
                               >= K)
        if not any_lane(distress):
            return sel, overflow
        idx, slot, in_slot = gather_slots(distress, K)
        cres = cold_solve(
            _lanes(P, lambda x: x[idx].repeat_interleave(G, dim=0)),
            GU[idx].reshape(K * G, -1))
        csel, _, _ = _best_of(cres, K)
        # The tracker replaces the solution with the cold-budget best
        # unconditionally on distress.
        return merge_slots(in_slot, slot, sel, csel), overflow

    return solve_warm, cold_solve, solve_batch, solve_batch_multistart


def build_batch_sim(cfg: MpcConfiguration, robot_cfg: CircularRobotSpecification,
                    solver_cfg: SolverConfiguration | None = None,
                    n_humans: int = 1, human_vmax: float = 1.5,
                    human_stagger: float = 0.5, n_steps: int = 120,
                    predictor=None, escalate: bool = True,
                    multistart: bool = True, record_traj: bool = False,
                    stagger_stream=None, dtype=torch.float32, device=None):
    """Returns run(batch: Scenario[B], seeds) -> BatchResult on `device`
    (None: the current CUDA device; raises without one).

    Production-faithful semantics (the sweep runs the SAME operating point
    the per-scenario harness certifies):
      * collision = strictly inside any inflated static polygon OR within
        HUMAN_SIZE of a pedestrian, per step; `min_static_clearance` tracks
        the static boundary distance.
      * lanes that are done or collided keep their state but still go
        through the solve, so the batch keeps its shape.

    n_humans: unused, as in the JAX package: the count is the scenario
    tensors' H.
    predictor: optional function `hist (B, 5, H, 2) -> (mu (B, N, K, 2),
    std (B, N, K, 2), alpha (B, N, K))` in world coordinates producing the
    dynamic-obstacle prediction slots (K <= Ndynobs).  Default: the
    constant-velocity predictor with unit std (one slot per human).
    escalate: False opts out of the escalation ladder (warm profile only;
    the cold pre-solve keeps running).  The ladder only runs on the
    multistart=False path; with multistart=True the per-step decision rule
    is `solve_batch_multistart` (which has its own cold-budget re-solve)
    and `escalate` has no effect.
    multistart: True (default) runs the tracker's full per-step decision
    rule -- 5-candidate multistart with feasibility-gated argmin and
    cold-budget re-solve of distressed lanes; False falls back to
    budget-only escalation of the single warm guess.
    record_traj: also return ((T, B, 3) robot, (T, B, H, 2) pedestrian)
    step histories as a side tuple.
    stagger_stream: optional (B, n_steps, H) precomputed pedestrian stagger
    scalars (already scaled by the stagger magnitude); replaces the draws
    from `seeds` so a lane can be matched against another simulator.
    """
    if not escalate and multistart:
        warnings.warn(
            "build_batch_sim(escalate=False) has no effect while "
            "multistart=True (the multistart path never calls the "
            "escalation ladder); pass multistart=False for an escalate "
            "A/B.", stacklevel=2)
    device = resolve_device(device)
    scfg = solver_cfg or SolverConfiguration()
    N = cfg.N_hor
    ts = cfg.ts
    base_speed = robot_cfg.lin_vel_max * 0.8      # 'work' mode
    q_vec = torch.as_tensor(tuning_vector(cfg), dtype=dtype, device=device)

    # Cold-start escalation (mirrors the tracker's cold bundle): the warm
    # profile is sized for shifted warm starts, which the FIRST solve of an
    # episode does not have.  When cold_profile is set, the step-0 problem
    # is pre-solved once with the escalated budget and its solution seeds
    # the warm-start carry.
    _, cold_solve, solve_batch, solve_batch_ms = build_lane_solvers(
        cfg, robot_cfg, scfg, escalate=escalate, dtype=dtype, device=device)
    robot_step = vmap(lambda s, a: unicycle_step(s, a, ts))

    def assemble_step(sc: Scenario, st: SimState):
        """Pre-solve work: ref window + prediction + params, all lanes."""
        window, ref_idx = ref_window_select(
            sc.ref_traj, sc.ref_len, st.ref_idx, st.robot, N,
            cfg.action_steps)
        if predictor is None:
            # Harness-exact CV velocity: average over the REAL history
            # steps (n_actions so far), not the backfilled ring length.
            prediction = cv_predict_horizon(st.human_hist, N,
                                            n_valid=st.n_actions)
        else:
            prediction = predictor(st.human_hist)
        P = lane_params(cfg, q_vec, base_speed, sc.all_polys, sc.all_stc,
                        st.robot, st.humans, prediction, st.u_prev, window,
                        dtype)
        return P, ref_idx

    def apply_step(sc: Scenario, st: SimState, u, solver_ok, overflow,
                   ref_idx, stagger) -> SimState:
        """Post-solve work: dynamics, collisions, bookkeeping, all lanes."""
        action = u[:, :2]
        action = torch.where(action[:, :1] < 0, torch.zeros_like(action),
                             action)
        robot_new = robot_step(st.robot, action)
        pos = robot_new[:, :2]

        humans_new, wp_new = human_waypoint_step(
            st.humans, st.human_wp, sc.human_paths, sc.human_path_len, None,
            human_vmax, human_stagger, ts, stagger=stagger)
        hist_new = torch.cat([st.human_hist[:, 1:], humans_new[:, None]], 1)

        d_humans = torch.amin(
            torch.linalg.norm(pos[:, None] - humans_new, dim=-1), dim=1)
        d_static = torch.amin(polygon_edge_distances(sc.all_polys, pos), 1)
        inside_static = point_in_any_quad(pos, sc.all_polys)
        collided_now = (d_humans <= HUMAN_SIZE) | inside_static
        # Termination mirrors the tracker's check exactly: np.allclose with
        # atol=0.5 is a per-coordinate BOX test, not a Euclidean disk.
        done_now = (torch.all(torch.abs(pos - sc.goal[:, :2]) <= 0.5, dim=1)
                    & (torch.abs(action[:, 0]) < 0.4))

        # Reference eval-protocol accumulators: action smoothness |d2a|
        # (valid once two prior actions exist) and per-step min distance of
        # the NEW position to the full reference trajectory.
        jerk = torch.abs(action - 2.0 * st.u_prev + st.u_prev2)
        jerk_valid = st.n_actions >= 2
        dev_all = torch.linalg.norm(pos[:, None] - sc.ref_traj[:, :, :2],
                                    dim=-1)
        in_ref = (torch.arange(dev_all.shape[1], device=device)
                  < sc.ref_len[:, None])
        dev = torch.amin(torch.where(
            in_ref, dev_all, torch.full_like(dev_all, float("inf"))), dim=1)

        frozen = st.done | st.collided
        active = torch.logical_not(frozen)

        def keep(new, old):
            return torch.where(
                frozen.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

        return SimState(
            robot=keep(robot_new, st.robot),
            humans=keep(humans_new, st.humans),
            human_wp=keep(wp_new, st.human_wp),
            human_hist=keep(hist_new, st.human_hist),
            u_prev=keep(action, st.u_prev),
            u_warm=keep(torch.cat([u[:, 2:], u[:, -2:]], 1), st.u_warm),
            ref_idx=keep(ref_idx, st.ref_idx),
            done=st.done | (done_now & active),
            collided=st.collided | (collided_now & active),
            collided_static=st.collided_static | (inside_static & active),
            min_clearance=keep(torch.minimum(st.min_clearance, d_humans),
                               st.min_clearance),
            min_static=keep(torch.minimum(st.min_static, d_static),
                            st.min_static),
            solver_fails=st.solver_fails
            + (active & torch.logical_not(solver_ok)).long(),
            overflow_steps=st.overflow_steps + (active & overflow).long(),
            u_prev2=keep(st.u_prev, st.u_prev2),
            n_actions=st.n_actions + active.long(),
            sum_jerk=torch.where((frozen | ~jerk_valid)[:, None],
                                 st.sum_jerk, st.sum_jerk + jerk),
            sum_dev=keep(st.sum_dev + dev, st.sum_dev),
            max_dev=keep(torch.maximum(st.max_dev, dev), st.max_dev),
        )

    def init_state(sc: Scenario) -> SimState:
        B, H = sc.human_starts.shape[:2]

        def zeros(*shape, dt=dtype):
            return torch.zeros((B,) + shape, dtype=dt, device=device)

        return SimState(
            robot=sc.robot_start, humans=sc.human_starts,
            human_wp=zeros(H, dt=torch.long),
            human_hist=sc.human_starts[:, None].expand(-1, 5, -1, -1),
            u_prev=zeros(2),
            u_warm=torch.tensor([base_speed, 0.0], dtype=dtype,
                                device=device).repeat(N).expand(B, -1),
            ref_idx=zeros(dt=torch.long),
            done=zeros(dt=torch.bool), collided=zeros(dt=torch.bool),
            collided_static=zeros(dt=torch.bool),
            min_clearance=zeros() + float("inf"),
            min_static=zeros() + float("inf"),
            solver_fails=zeros(dt=torch.long),
            overflow_steps=zeros(dt=torch.long),
            u_prev2=zeros(2), n_actions=zeros(dt=torch.long),
            sum_jerk=zeros(2), sum_dev=zeros(), max_dev=zeros())

    def run(batch: Scenario, seeds):
        sc = scenario_to_device(batch, device, dtype)
        B, H = sc.human_starts.shape[:2]
        if stagger_stream is not None:
            stag = torch.as_tensor(np.asarray(stagger_stream), dtype=dtype)
        else:
            stag = torch.stack([
                draw_stagger((n_steps, H), human_stagger,
                             torch.Generator().manual_seed(int(s)), dtype)
                for s in np.asarray(seeds).reshape(-1)])
        stag = stag.to(device)
        st = init_state(sc)

        if cold_solve is not None:
            P0, _ = assemble_step(sc, st)
            st = st._replace(u_warm=cold_solve(P0, st.u_warm).u)

        steps_used = torch.zeros(B, dtype=torch.long, device=device)
        traj, humans_traj = [], []
        for k in range(n_steps):
            P, ref_idx = assemble_step(sc, st)
            if multistart:
                res, overflow = solve_batch_ms(P, st.u_warm, st.u_prev)
            else:
                res = solve_batch(P, st.u_warm)
                overflow = torch.zeros_like(res.converged)
            st = apply_step(sc, st, res.u, res.converged, overflow, ref_idx,
                            stag[:, k])
            steps_used += torch.logical_not(st.done | st.collided).long()
            if record_traj:
                traj.append(st.robot)
                humans_traj.append(st.humans)
        result = BatchResult(
            success=st.done & ~st.collided,
            collided=st.collided,
            collided_static=st.collided_static,
            min_clearance=st.min_clearance,
            final_state=st.robot,
            steps_used=steps_used,
            min_static_clearance=st.min_static,
            solver_fail_steps=st.solver_fails,
            smoothness=st.sum_jerk
            / torch.clamp(st.n_actions - 2, min=1)[:, None].to(dtype),
            deviation_mean=st.sum_dev
            / torch.clamp(st.n_actions, min=1).to(dtype),
            deviation_max=st.max_dev,
            escalation_overflow_steps=st.overflow_steps,
        )
        if record_traj:
            # (T, B, ...) step histories for plotting/triage; returned as a
            # side tuple so BatchResult stays stable for existing callers.
            return result, (torch.stack(traj), torch.stack(humans_traj))
        return result

    return run


def scenario_to_device(sc, device, dtype=torch.float32):
    """A Scenario or `sim.fleet.FleetScenario` of numpy arrays or tensors
    (single or batched) as the same tuple of tensors on `device`: floating
    fields in `dtype`, integer fields in int64."""
    def move(x):
        t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return t.to(device=device,
                    dtype=dtype if t.is_floating_point() else torch.long)

    return type(sc)(*[move(x) for x in sc])


def build_step_program(cfg: MpcConfiguration,
                       robot_cfg: CircularRobotSpecification,
                       solver_cfg: SolverConfiguration | None = None,
                       predictor=None, dtype=torch.float32, device=None):
    """One control step for DEPLOYMENT (one robot): prediction -> dynamic
    obstacle assembly -> reference-window selection -> multistart NMPC
    solve, the port of `dyobav_tpu.sim.batch.build_step_program`, which
    `sim.deploy.NavigationNode(fused_step=...)` drives.  Unlike the batched
    sim there is no simulated world step: the real world advances between
    ticks.

    The JAX package jits the step into one device program with no host
    sync inside it.  Here it runs eagerly on `device` (None: the current
    CUDA device; raises without one) with the lane dim of
    `build_lane_solvers` set to 1, and a tick syncs with the host once: the
    multistart's `any_lane(distress)`, which decides whether the cold
    re-solve runs.  The returned tensors stay on the device.

    predictor: optional `hist (B, 5, H, 2) -> (mu (B, N, K, 2), std (B, N,
    K, 2), alpha (B, N, K))`, the contract of `build_batch_sim` (e.g.
    `make_wta_predictor`), called with B = 1; default: the
    constant-velocity prediction over the whole history ring.

    Returns (step, cold_start):
      step(sc: Scenario, robot (3,), human_hist (5, H, 2), u_warm, u_prev,
           ref_idx) -> (action (2,), u_warm_next, ref_idx_next,
                        converged (), cost ())
      cold_start(sc, robot, human_hist, u_init) -> u_warm: the episode's
           first solve at the cold profile (u_init itself without one).
    `sc` is one scenario (no lane dim), numpy or tensors; the step moves it
    to `device` (a no-op once it is there).
    """
    device = resolve_device(device)
    scfg = solver_cfg or SolverConfiguration()
    N = cfg.N_hor
    base_speed = robot_cfg.lin_vel_max * 0.8
    q_vec = torch.as_tensor(tuning_vector(cfg), dtype=dtype, device=device)
    _, cold_solve, _, solve_batch_ms = build_lane_solvers(
        cfg, robot_cfg, scfg, escalate=True, dtype=dtype, device=device)
    predict_fn = (predictor if predictor is not None
                  else lambda hist: cv_predict_horizon(hist, N))

    def as_lane(x, dt=dtype):
        return torch.as_tensor(x, device=device).to(dt)[None]

    def window_of(sc: Scenario, robot, ref_idx):
        return ref_window_select(sc.ref_traj[None], sc.ref_len[None],
                                 ref_idx, robot, N, cfg.action_steps)

    def params(sc: Scenario, robot, human_hist, u_prev, window) -> MpcParams:
        return lane_params(cfg, q_vec, base_speed, sc.all_polys[None],
                           sc.all_stc[None], robot, human_hist[:, -1],
                           predict_fn(human_hist), u_prev, window, dtype)

    def step(sc: Scenario, robot, human_hist, u_warm, u_prev, ref_idx):
        sc = scenario_to_device(sc, device, dtype)
        robot, human_hist = as_lane(robot), as_lane(human_hist)
        u_warm, u_prev = as_lane(u_warm), as_lane(u_prev)
        window, ref_idx_next = window_of(sc, robot,
                                         as_lane(ref_idx, torch.long))
        P = params(sc, robot, human_hist, u_prev, window)
        res, _ = solve_batch_ms(P, u_warm, u_prev)
        u = res.u[0]
        action = u[:2]
        action = torch.where(action[0] < 0, torch.zeros_like(action), action)
        u_warm_next = torch.cat([u[2:], u[-2:]])
        return (action, u_warm_next, ref_idx_next[0], res.converged[0],
                res.cost[0])

    def cold_start(sc: Scenario, robot, human_hist, u_init):
        u_init = torch.as_tensor(u_init, device=device).to(dtype)
        if cold_solve is None:
            return u_init
        sc = scenario_to_device(sc, device, dtype)
        robot, human_hist = as_lane(robot), as_lane(human_hist)
        window, _ = window_of(sc, robot, torch.zeros(1, dtype=torch.long,
                                                     device=device))
        P = params(sc, robot, human_hist,
                   torch.zeros(1, 2, dtype=dtype, device=device), window)
        return cold_solve(P, u_init[None]).u[0]

    return step, cold_start


def make_wta_predictor(net, ref_map_px, transform, n_hor: int,
                       snap_tables=None, obsv_len: int = 5,
                       max_clusters: int = 8, enlarge: float = 2.0,
                       scale2nn: float = 1.0, dtype=torch.float32,
                       device=None):
    """Neural predictor for the batched sim: SWTA CNN + on-device CGF.

    The JAX package's pipeline for a batch of lanes: world-frame histories
    -> pixel frame -> 7-channel input stacks for all horizon offsets
    (`models.heatmap`) -> ONE forward of `net` over all B x H x n_hor
    images -> optional obstacle snap (gather tables) -> world frame ->
    `ops.cluster.cluster_gaussian_fit` per (lane, human, offset) with
    eps = 1 m -> (mu, sigma, alpha) slots.  The net runs in full float32
    (`models.wta_net.full_f32`), as the JAX package's default dtype asks;
    the CGF takes no matrix product of coordinates, so it does too.
    Memory: the batch is B x H x n_hor images of (7, Hpx, Wpx); the stem's
    output alone is 64 x 147 x 165 floats an image at 293 x 330 px.

    Args:
        net: `models.wta_net.ConvMultiHypoNet` in eval mode on `device`.
        ref_map_px: (Hpx, Wpx) grayscale map channel.
        transform: `maps.transforms.ScaleOffsetReverseTransform` world<->px.
        snap_tables: optional (3, Hpx, Wpx) nearest-edge row / col tables
            and occupied mask (`predictors.mmp.ObstacleSnapper.tables()`).
        max_clusters: cluster slots per (human, offset); H x max_clusters
            must stay <= MpcConfiguration.Ndynobs.
        device: None: the current CUDA device; raises without one.
    Returns:
        predict(hist (B, 5, H, 2)) -> (mu (B, N, H*C, 2), std (B, N, H*C,
        2), alpha (B, N, H*C)), the contract of `build_batch_sim`.
    """
    from ..models.heatmap import traj_to_input_stack
    from ..models.wta_net import full_f32
    from ..ops.cluster import cluster_gaussian_fit

    device = resolve_device(device)
    ref_map = torch.as_tensor(np.asarray(ref_map_px), dtype=dtype,
                              device=device)
    Hpx, Wpx = ref_map.shape
    k = torch.tensor(transform.k, dtype=dtype, device=device)
    b = torch.tensor(transform.b, dtype=dtype, device=device)
    ym, y_rev = float(transform.ym), bool(transform.yr)
    tables = (None if snap_tables is None else torch.as_tensor(
        np.asarray(snap_tables), device=device).reshape(3, -1))
    offsets = torch.arange(1, n_hor + 1, dtype=dtype, device=device)

    def world_to_px(xy):
        px = (xy - b) / k
        if y_rev:
            px = torch.stack([px[..., 0], ym - px[..., 1]], dim=-1)
        return px * scale2nn

    def px_to_world(px):
        px = px / scale2nn
        if y_rev:
            px = torch.stack([px[..., 0], ym - px[..., 1]], dim=-1)
        return px * k + b

    def snap(points_px):
        """Points inside an obstacle move to the nearest edge cell; the int
        cast truncates toward zero, as `astype(int32)` does, then clips."""
        if tables is None:
            return points_px
        cols = torch.clamp(points_px[..., 0].to(torch.int32), 0, Wpx - 1)
        rows = torch.clamp(points_px[..., 1].to(torch.int32), 0, Hpx - 1)
        cell = (rows.long() * Wpx + cols.long()).reshape(-1)
        near = tables[:, cell].reshape((3,) + tuple(cols.shape))
        snapped = torch.stack([near[1], near[0]], dim=-1).to(dtype)
        return torch.where((near[2] > 0)[..., None], snapped, points_px)

    def predict(hist_world):
        B, _, H, _ = hist_world.shape
        trajs = world_to_px(hist_world).transpose(1, 2)       # (B, H, 5, 2)
        stack = traj_to_input_stack(trajs, ref_map, offsets,
                                    obsv_len=obsv_len)  # (B, H, N, 7, h, w)
        with torch.no_grad(), full_f32():
            hypos = net(stack.reshape((-1,) + stack.shape[3:]))
        hypos = snap(hypos.reshape(B, H, n_hor, -1, 2).to(dtype))
        mu, std, alpha = cluster_gaussian_fit(
            px_to_world(hypos), eps=1.0, enlarge=enlarge,
            max_clusters=max_clusters)                     # (B, H, N, C, ...)
        return (mu.transpose(1, 2).reshape(B, n_hor, -1, 2),
                std.transpose(1, 2).reshape(B, n_hor, -1, 2),
                alpha.transpose(1, 2).reshape(B, n_hor, -1))

    return predict
