"""Receding-horizon NMPC problems for the solve cells, in numpy: the
generator of the `receding` traffic mixes.

Frozen copy of `chip_smoke.make_problems` (which is `bench.py`'s scenario
batch), with the port's `ops.params.pack` written out as the flat layout it
produces, so that a change to the program moves neither the problems nor
their layout:

    z = [u_m1(nu) | s_0(ns) | s_N(ns) | q(nq) | r_s(N ns) | r_v(N) |
         c_0(ns Nother) | c(ns N Nother) | o_s(Nstcobs nstcobs) |
         o_d(Ndynobs (N + 1) ndynobs) | q_stc(N) | q_dyn(N)]

Each lane is a robot at a uniform position in [-5, 5]^2 m and heading,
with a straight reference at 0.24 m a step along its heading, a 1.2 m/s
reference speed, and one static pedestrian ellipse (radii 0.4 m) 2.2 m
ahead and 0.3 m to the left.  `advance` rolls the states one step under
the first solved action (RK4 unicycle, as the program's model), which is
how the closed loop poses the next problem.
"""
from __future__ import annotations

import numpy as np


def tuning_vector(mpc: dict) -> np.ndarray:
    """q in the reference's order: qpos, qvel, qtheta, lin_vel_penalty,
    ang_vel_penalty, qpN, qthetaN, qrpd, lin_acc_penalty, ang_acc_penalty."""
    return np.array([mpc["qpos"], mpc["qvel"], mpc["qtheta"],
                     mpc["lin_vel_penalty"], mpc["ang_vel_penalty"],
                     mpc["qpN"], mpc["qthetaN"], mpc["qrpd"],
                     mpc["lin_acc_penalty"], mpc["ang_acc_penalty"]],
                    np.float32)


def field_sizes(mpc: dict) -> list:
    """(name, shape) of each field of the flat parameter vector, in order."""
    N, ns, nu = mpc["N_hor"], mpc["ns"], mpc["nu"]
    return [("u_prev", (nu,)), ("s0", (ns,)), ("sN", (ns,)),
            ("q", (mpc["nq"],)), ("ref_states", (N, ns)),
            ("ref_speed", (N,)), ("others0", (mpc["Nother"], ns)),
            ("others_pred", (mpc["Nother"], N, ns)),
            ("stc_obs", (mpc["Nstcobs"], mpc["nstcobs"])),
            ("dyn_obs", (mpc["Ndynobs"], N + 1, mpc["ndynobs"])),
            ("q_stc", (N,)), ("q_dyn", (N,))]


def n_params(mpc: dict) -> int:
    return int(sum(np.prod(s) for _, s in field_sizes(mpc)))


def unicycle_rk4(states: np.ndarray, actions: np.ndarray,
                 ts: float) -> np.ndarray:
    """(B, 3) states after one step of (B, 2) actions (v, w), RK4 with the
    action held over the step."""
    s = states.astype(np.float64)
    a = actions.astype(np.float64)

    def d(x):
        return ts * np.stack([a[:, 0] * np.cos(x[:, 2]),
                              a[:, 0] * np.sin(x[:, 2]), a[:, 1]], axis=1)

    k1 = d(s)
    k2 = d(s + 0.5 * k1)
    k3 = d(s + 0.5 * k2)
    k4 = d(s + k3)
    return (s + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0).astype(np.float32)


class RecedingProblems:
    """bench.py's batch of `batch` problems drawn from `seed`."""

    def __init__(self, mpc: dict, batch: int, seed: int,
                 ref_step_m: float = 0.24, ref_speed: float = 1.2,
                 obstacle_ahead_m: float = 2.2, obstacle_left_m: float = 0.3,
                 obstacle_radius_m: float = 0.4, spawn_half_width_m: float = 5.0,
                 q_stc: float = 10.0, q_dyn: float = 10.0):
        self.mpc, self.batch = mpc, batch
        N = mpc["N_hor"]
        rng = np.random.default_rng(seed)
        self.x0 = rng.uniform(-spawn_half_width_m, spawn_half_width_m, batch)
        self.y0 = rng.uniform(-spawn_half_width_m, spawn_half_width_m, batch)
        self.heading = rng.uniform(-np.pi, np.pi, batch)
        c, s = np.cos(self.heading), np.sin(self.heading)
        self.obs_xy = np.stack(
            [self.x0 + c * obstacle_ahead_m - s * obstacle_left_m,
             self.y0 + s * obstacle_ahead_m + c * obstacle_left_m], axis=1)
        self.ref_step_m, self.ref_speed = ref_step_m, ref_speed
        self.obstacle_radius_m = obstacle_radius_m
        self.q_stc, self.q_dyn = q_stc, q_dyn
        self.states = np.stack([self.x0, self.y0, self.heading],
                               axis=1).astype(np.float32)
        self.u_prev = np.tile(np.array([ref_speed, 0.0], np.float32),
                              (batch, 1))
        self.U0 = np.tile(np.tile(np.array([ref_speed, 0.0], np.float32), N),
                          (batch, 1))

    def make_Z(self, states: np.ndarray, u_prev: np.ndarray,
               k: int) -> np.ndarray:
        """(B, n_params) float32 problems at receding-horizon step k."""
        mpc, B = self.mpc, self.batch
        N = mpc["N_hor"]
        c, s = np.cos(self.heading), np.sin(self.heading)
        steps = np.arange(k + 1, k + N + 1)
        ref = np.zeros((B, N, 3), np.float32)
        ref[:, :, 0] = self.x0[:, None] + c[:, None] * self.ref_step_m * steps
        ref[:, :, 1] = self.y0[:, None] + s[:, None] * self.ref_step_m * steps
        ref[:, :, 2] = self.heading[:, None]
        ell = np.zeros((B, mpc["Ndynobs"], N + 1, mpc["ndynobs"]), np.float32)
        ell[:, 0, :, 0] = self.obs_xy[:, None, 0]
        ell[:, 0, :, 1] = self.obs_xy[:, None, 1]
        r = self.obstacle_radius_m
        ell[:, 0, :, 2:] = [r, r, 0.0, 1.0]
        fields = {
            "u_prev": u_prev, "s0": states, "sN": ref[:, -1],
            "q": np.broadcast_to(tuning_vector(mpc), (B, mpc["nq"])),
            "ref_states": ref,
            "ref_speed": np.full((B, N), self.ref_speed, np.float32),
            "dyn_obs": ell,
            "q_stc": np.full((B, N), self.q_stc, np.float32),
            "q_dyn": np.full((B, N), self.q_dyn, np.float32),
        }
        parts = []
        for name, shape in field_sizes(mpc):
            f = fields.get(name)
            if f is None:
                f = np.zeros((B,) + shape, np.float32)
            parts.append(np.asarray(f, np.float32).reshape(B, -1))
        return np.ascontiguousarray(np.concatenate(parts, axis=1))

    def advance(self, states: np.ndarray, u: np.ndarray):
        """(next states, next u_prev, next warm guess) after applying the
        first action of each lane's solved sequence u (B, N nu)."""
        nu = self.mpc["nu"]
        a = np.asarray(u[:, :nu], np.float32)
        nxt = unicycle_rk4(states, a, self.mpc["ts"])
        guess = np.concatenate([u[:, nu:], u[:, -nu:]], axis=1)
        return nxt, a.copy(), np.ascontiguousarray(guess, np.float32)
