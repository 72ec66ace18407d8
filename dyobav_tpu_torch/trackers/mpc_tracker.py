"""MPC trajectory tracker, the port of `dyobav_tpu.trackers.mpc_tracker`.

The stateful receding-horizon loop around the batched NMPC solve of
`ops.engine` (reference `pkg_mpc_tracker.trajectory_tracker`,
trajectory_tracker.py:18-416).  Protocol, work modes, reference-trajectory
generation, parameter assembly order and return shapes follow the
reference, so the interface layer carries over.

Each step solves a small batch of initial guesses (shifted warm start,
braking profile, zeros, two swerve arcs) in one `solve_batch` call on the
tracker's device and keeps the best; a step in distress re-solves the same
candidates at the cold budget.  Each solve comes back to the host in one
copy (`ops.engine.to_host`).
"""
from __future__ import annotations

import math
import timeit
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration)
from ..motion.models import unicycle_step_np
from ..ops.engine import (MpcSolve, MpcSolverBundle, build_mpc_solver,
                          profile_configuration, resolve_device, to_host)


def fetch(sol: MpcSolve) -> MpcSolve:
    """A batched `MpcSolve` as numpy, moved to the host in one copy."""
    B = sol.u.shape[0]
    fields = [sol.u, sol.cost[:, None], sol.pred_states.reshape(B, -1),
              sol.exit_ok[:, None].to(sol.u.dtype), sol.infeasibility[:, None],
              sol.residual[:, None]]
    flat = to_host(torch.cat(fields, dim=1))
    ends = np.cumsum([f.shape[1] for f in fields])
    u, cost, pred, ok, infeas, res = np.split(flat, ends[:-1], axis=1)
    return MpcSolve(u=u, cost=cost[:, 0],
                    pred_states=pred.reshape(sol.pred_states.shape),
                    exit_ok=ok[:, 0] > 0.5, infeasibility=infeas[:, 0],
                    residual=res[:, 0])


# Ids of the bundles already solved once in this process; the engine's
# cache keeps every bundle alive, so an id is never reused.
_WARMED: set = set()


class TrajectoryTracker:
    """Run-protocol: `load_init_states` → `set_ref_trajectory` → `run_step`.

    `device` (None: the current CUDA device; raises without one) is where
    the solves run."""

    def __init__(self, config: MpcConfiguration,
                 robot_specification: CircularRobotSpecification,
                 solver_config: SolverConfiguration | None = None,
                 use_multistart: bool = True, verbose: bool = False,
                 device=None):
        self.vb = verbose
        self.config = config
        self.robot_spec = robot_specification
        self.device = resolve_device(device)

        self.ts = config.ts
        self.ns = config.ns
        self.nu = config.nu
        self.N_hor = config.N_hor

        self.idle = True
        self.set_work_mode(mode="safe")
        self.set_obstacle_weights(stc_weights=10, dyn_weights=10)

        self.solver_config = solver_config or SolverConfiguration()
        self.bundle: MpcSolverBundle = build_mpc_solver(
            config, robot_specification, self.solver_config,
            device=self.device)
        # Cold-start escalation: the first solve of an episode has no warm
        # start, where lean receding-horizon profiles under-iterate; it
        # runs on the cold profile (optional 5th element: its initial
        # penalty, default 10).
        if self.solver_config.cold_profile:
            self.cold_bundle: MpcSolverBundle = build_mpc_solver(
                config, robot_specification,
                profile_configuration(self.solver_config,
                                      self.solver_config.cold_profile),
                device=self.device)
        else:
            self.cold_bundle = self.bundle
        self.use_multistart = use_multistart
        self._last_u: Optional[np.ndarray] = None

    def _warmup(self) -> None:
        """Run each bundle's multistart-shaped solve once before the first
        timed step.  On the card this builds and loads the SPD kernel and
        initialises the CUDA libraries and the allocator; without it the
        first step's `solve_time` would include the `nvcc` build, as the
        JAX package's would include its compile (its record: a 478 s
        `solve_time_max`).  Bundles are shared process-wide
        (`build_mpc_solver` memoizes them), so only the first tracker of a
        configuration pays."""
        n_guess = len(self._initial_guesses(np.zeros(self.nu)))
        for bundle in (self.bundle, self.cold_bundle):
            if id(bundle) in _WARMED:
                continue
            z = torch.zeros((n_guess, self.config.n_params),
                            device=self.device)
            u0 = torch.zeros((n_guess, self.nu * self.N_hor),
                             device=self.device)
            fetch(bundle.solve_batch(z, u0))
            _WARMED.add(id(bundle))

    # ------------------------------------------------------------------ setup
    def load_motion_model(self, motion_model) -> None:
        """Kept for protocol parity; the rollout model is the solver's."""
        self.motion_model = motion_model

    def load_init_states(self, current_state: np.ndarray,
                         goal_state: np.ndarray):
        if (not isinstance(current_state, np.ndarray)
                or not isinstance(goal_state, np.ndarray)):
            raise TypeError("States must be numpy arrays.")
        self.state = current_state
        self.final_goal = goal_state
        self.past_states: List[np.ndarray] = []
        self.past_actions: List[np.ndarray] = []
        self.cost_timelist: List[float] = []
        self.solver_time_timelist: List[float] = []
        self.solver_status_timelist: List[str] = []
        self.idx_ref_traj = 0
        self.idx_ref_path = 0
        self.idle = False
        self._last_u = None
        self.escalation_count = 0   # distress escalations this episode
        if self.use_multistart:
            self._warmup()

    def set_obstacle_weights(self, stc_weights, dyn_weights):
        def to_list(w):
            return list(w) if isinstance(w, list) else [float(w)] * self.N_hor

        self.stc_weights = to_list(stc_weights)
        self.dyn_weights = to_list(dyn_weights)

    def set_work_mode(self, mode: str = "safe"):
        """Base speed + the 10-element tuning vector per mode
        (trajectory_tracker.py:124-147)."""
        if mode == "aligning":
            self.base_speed = self.robot_spec.lin_vel_max * 0.5
            self.tuning_params = [0.0] * self.config.nq
            self.tuning_params[2] = 100.0
        else:
            c = self.config
            self.tuning_params = [
                c.qpos, c.qvel, c.qtheta, c.lin_vel_penalty, c.ang_vel_penalty,
                c.qpN, c.qthetaN, c.qrpd, c.lin_acc_penalty, c.ang_acc_penalty]
            speed_scale = {"safe": 0.2, "work": 0.8, "super": 1.0}
            if mode not in speed_scale:
                raise ValueError(f"There is no mode called {mode}.")
            self.base_speed = self.robot_spec.lin_vel_max * speed_scale[mode]

    def set_current_state(self, current_state: np.ndarray):
        if not isinstance(current_state, np.ndarray):
            raise TypeError("State must be a numpy array.")
        self.state = current_state

    def set_ref_trajectory(self, ref_path: List[tuple],
                           ref_traj: List[tuple] | None = None):
        self.idx_ref_path = 0
        self.idx_ref_traj = 0
        self.ref_path = ref_path
        self.ref_traj = (ref_traj if ref_traj is not None
                         else self.get_ref_traj(self.ts, ref_path, self.state,
                                                self.base_speed))

    def set_ref_states(self, ref_states: np.ndarray | None = None
                       ) -> np.ndarray:
        if ref_states is None:
            ref_states, self.idx_ref_traj = self.get_ref_states(
                self.idx_ref_traj, self.ref_traj, self.state,
                self.config.action_steps, self.N_hor)
        self.ref_states = ref_states
        return self.ref_states

    def check_termination_condition(self, state, action, final_goal) -> bool:
        """Within 0.5 m of goal at low speed (trajectory_tracker.py:191-199)."""
        if (np.allclose(state[:2], final_goal[:2], atol=0.5, rtol=0)
                and abs(action[0]) < 0.4):
            self.idle = True
            return True
        return False

    # --------------------------------------------------------- static helpers
    @staticmethod
    def get_ref_traj(ts: float, ref_path: List[tuple], state,
                     speed: float) -> List[tuple]:
        """Constant-speed resampling of the waypoint path into a trajectory
        (trajectory_tracker.py:202-240)."""
        x, y = float(state[0]), float(state[1])
        path = [(float(p[0]), float(p[1])) for p in ref_path]
        path_idx = 0
        x_next, y_next = path[0]
        ref_traj: List[tuple] = []
        x_dir = y_dir = 0.0
        traveling = True
        while traveling:
            # Inner stepping loop.  Reference quirk preserved
            # (trajectory_tracker.py:215-237): on reaching a waypoint
            # mid-step the elapsed time is NOT carried over — the walker
            # re-enters the loop with a fresh full ts toward the next node,
            # so points near node crossings advance slightly farther.
            while True:
                dist = math.hypot(x_next - x, y_next - y)
                if dist < 1e-9:
                    path_idx += 1
                    if path_idx > len(path) - 1:
                        traveling = False
                    else:
                        x_next, y_next = path[path_idx]
                    break
                x_dir, y_dir = (x_next - x) / dist, (y_next - y) / dist
                eta = dist / speed
                if eta > ts:
                    x += x_dir * speed * ts
                    y += y_dir * speed * ts
                    break
                x += x_dir * speed * eta
                y += y_dir * speed * eta
                path_idx += 1
                if path_idx > len(path) - 1:
                    traveling = False
                    break
                x_next, y_next = path[path_idx]
            if not dist < 1e-9:
                ref_traj.append((x, y, math.atan2(y_dir, x_dir)))
        return ref_traj

    @staticmethod
    def get_ref_states(idx_ref_traj: int, ref_traj: List[tuple], state,
                       action_steps: int = 1, horizon: int = 20
                       ) -> Tuple[np.ndarray, int]:
        """Pick the local N_hor reference window starting at the closest
        trajectory point near the previous index
        (trajectory_tracker.py:242-270)."""
        traj = np.asarray(ref_traj, dtype=np.float64)
        lb = max(0, idx_ref_traj - 1 * action_steps)
        ub = min(len(traj), idx_ref_traj + 5 * action_steps)
        window = traj[lb:ub, :2]
        dists = np.hypot(window[:, 0] - state[0], window[:, 1] - state[1])
        idx_next = int(np.argmin(dists)) + lb
        end = idx_next + horizon
        if end >= len(traj):
            pad = end - len(traj)
            ref_states = np.concatenate(
                [traj[idx_next:], np.repeat(traj[-1:], pad, axis=0)], axis=0)
        else:
            ref_states = traj[idx_next:end]
        return ref_states, idx_next

    # ------------------------------------------------------------------- run
    def _initial_guesses(self, last_u: np.ndarray) -> np.ndarray:
        """Multi-start candidates (K, nu*N_hor)."""
        N, nu = self.N_hor, self.nu
        guesses = []
        if self._last_u is not None:
            shifted = np.concatenate(
                [self._last_u[nu:], self._last_u[-nu:]])  # shift one step
            guesses.append(shifted)
        else:
            guesses.append(np.tile([self.base_speed, 0.0], N))
        # Braking profile: ramp current speed down to zero.
        ramp = np.linspace(float(last_u[0]), 0.0, N)
        brake = np.stack([ramp, np.zeros(N)], axis=1).reshape(-1)
        guesses.append(brake)
        guesses.append(np.zeros(nu * N))
        # Swerve arcs: commit left/right around an obstacle, so that the
        # solver can hop to the other side when it became cheaper.
        w = 0.6 * self.robot_spec.ang_vel_max
        for sgn in (+1.0, -1.0):
            arc = np.stack([np.full(N, self.base_speed),
                            np.full(N, sgn * w)], axis=1).reshape(-1)
            guesses.append(arc)
        return np.stack(guesses).astype(np.float32)

    def run_step(self, stc_constraints: list | None,
                 dyn_constraints: list | None,
                 other_robot_states: list | None = None,
                 ref_states: np.ndarray | None = None, mode: str = "safe"):
        """One receding-horizon step; same contract as the reference
        (`trajectory_tracker.run_step`, :273-337).

        Returns (actions, pred_states, ref_states, cost), or -1 when the
        solution is not finite.
        """
        self.set_work_mode(mode)

        if stc_constraints is None:
            stc_constraints = [0.0] * (self.config.Nstcobs
                                       * self.config.nstcobs)
        if dyn_constraints is None:
            dyn_constraints = [0.0] * (self.config.Ndynobs * self.config.ndynobs
                                       * (self.N_hor + 1))
        if other_robot_states is None:
            other_robot_states = [0.0] * (self.ns * (self.N_hor + 1)
                                          * self.config.Nother)

        ref_states = self.set_ref_states(ref_states)
        finish_state = ref_states[-1, :]

        dist_to_goal = math.hypot(self.state[0] - self.final_goal[0],
                                  self.state[1] - self.final_goal[1])
        if dist_to_goal >= self.base_speed * self.N_hor * self.ts:
            speed_ref_list = [self.base_speed] * self.N_hor
        else:
            # Reference quirk preserved (trajectory_tracker.py:307-310):
            # `max` with lin_vel_max pins the near-goal ref speed to vmax.
            speed_ref = dist_to_goal / self.N_hor / self.ts
            speed_ref = max(speed_ref, self.robot_spec.lin_vel_max)
            speed_ref_list = [speed_ref] * self.N_hor

        last_u = (self.past_actions[-1] if self.past_actions
                  else np.zeros(self.nu))

        params = (list(last_u) + list(self.state) + list(finish_state)
                  + self.tuning_params + ref_states.reshape(-1).tolist()
                  + speed_ref_list + list(other_robot_states)
                  + list(stc_constraints) + list(dyn_constraints)
                  + self.stc_weights + self.dyn_weights)
        z = torch.as_tensor(np.asarray(params, dtype=np.float32),
                            device=self.device)

        t0 = timeit.default_timer()
        bundle = self.bundle if self._last_u is not None else self.cold_bundle
        scfg = self.solver_config
        infeas_bar = scfg.multistart_infeas_factor * scfg.constraint_tol
        guesses = self._initial_guesses(last_u)
        if not self.use_multistart:
            guesses = guesses[:1]
        zb = z.expand(guesses.shape[0], z.shape[0])
        u0 = torch.as_tensor(guesses, device=self.device)
        sols = fetch(bundle.solve_batch(zb, u0))
        if self.use_multistart:
            # Distress escalation: the warm profile is sized for steps whose
            # basin did not move.  When a prediction newly blocks the warm
            # basin, the warm candidate goes infeasible or loses the
            # ranking, and the same candidates are re-solved at the cold
            # budget.  ANY infeasible candidate signals such a shift.
            infeas = sols.infeasibility
            score = sols.cost + 1e6 * (infeas > infeas_bar)
            best = int(np.argmin(score))
            distress = ((best != 0) or bool(np.max(infeas) > infeas_bar)
                        or not bool(sols.exit_ok[best]))
            if distress and self.cold_bundle is not bundle:
                self.escalation_count += 1
                sols = fetch(self.cold_bundle.solve_batch(zb, u0))
                infeas = sols.infeasibility
                score = sols.cost + 1e6 * (infeas > infeas_bar)
                best = int(np.argmin(score))
        else:
            best = 0
            if not bool(sols.exit_ok[0]) and self.cold_bundle is not bundle:
                sols = fetch(self.cold_bundle.solve_batch(zb, u0))
        u_flat = sols.u[best]
        cost = float(sols.cost[best])
        pred_states_arr = sols.pred_states[best]
        exit_ok = bool(sols.exit_ok[best])
        solver_time = (timeit.default_timer() - t0) * 1000.0  # ms

        # Failure path: the solver cannot raise, but a non-finite solution
        # is the reference's RuntimeError branch
        # (trajectory_tracker.py:318-325): report failure the same way.
        if not np.all(np.isfinite(u_flat)):
            print("Fatal: Cannot run solver (non-finite solution).")
            return -1

        self._last_u = u_flat
        take_steps = self.config.action_steps
        # Reference quirk preserved (trajectory_tracker.py:369-372): every
        # taken state integrates from the SAME current state rather than
        # chaining (identical for action_steps=1, all shipped configs).
        s0 = np.asarray(self.state, np.float64)
        taken_states = [
            unicycle_step_np(s0, u_flat[i * self.nu:(i + 1) * self.nu],
                             self.ts)
            for i in range(take_steps)]
        pred_states = [s for s in pred_states_arr]
        actions = [u_flat[i * self.nu:(i + 1) * self.nu].copy()
                   for i in range(take_steps)]

        self.past_states.append(self.state)
        self.past_states += taken_states[:-1]
        self.past_actions += actions
        self.state = taken_states[-1]
        self.cost_timelist.append(cost)
        self.solver_time_timelist.append(solver_time)

        # Exit-status vocabulary: OpEn's status strings (ref
        # `config/mpc_default.yaml` bad_exit_codes).  The solver has a
        # fixed iteration budget instead of a wall-clock cutoff, so a
        # failed solve is "NotConvergedIterations" unless the measured wall
        # time also blew the configured `max_solver_time` budget (µs).
        if exit_ok:
            status = "Converged"
        elif solver_time > self.config.max_solver_time / 1000.0:
            status = "NotConvergedOutOfTime"
        else:
            status = "NotConvergedIterations"
        self.solver_status = status
        self.solver_status_timelist.append(status)
        if status in self.config.bad_exit_codes and self.vb:
            print(f"[TrajTracker] Bad converge status: {status}")
        return actions, pred_states, ref_states, cost
