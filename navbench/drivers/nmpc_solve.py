"""Driver of the solve cells: `MpcSolverBundle.solve_batch_escalated` in a
closed receding-horizon loop.

Set-up builds the bundle from the configuration, solves the generator's
step-0 problems cold and the step-1 problems warm (every shape the window
uses: the warm stage over B lanes and the escalation stage over its K
slots; the SPD kernel is built or loaded here).  The window then solves
steps 2, 3, ... back to back: each step poses the problems from the states
the previous actions reached, solves, synchronizes and copies the actions
back for the next step.  The traced run times one escalated solve and its
warm stage on the next problems with the host clock, then traces each
under the profiler.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import harness
from ..generators.receding import RecedingProblems
from ..reference import nmpc as reference
from ..yardstick import profiler
from ..yardstick.newton_work import escalated_solve_flops, spd_systems

def solver_configuration(cfg: dict):
    from dyobav_tpu_torch.configs import SolverConfiguration

    s = dict(cfg["solver"])
    for key in ("cold_profile", "escalation_slots"):
        s[key] = tuple(s[key])
    s["escalation_ladder"] = tuple(tuple(p) for p in s["escalation_ladder"])
    return SolverConfiguration(**s)


def problem_configurations(cfg: dict):
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration)

    names = {f.name for f in dataclasses.fields(MpcConfiguration)}
    mpc = MpcConfiguration(**{k: v for k, v in cfg["mpc"].items()
                              if k in names})
    return mpc, CircularRobotSpecification(**cfg["robot"])


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dyobav_tpu_torch.ops.engine import build_mpc_solver

        self.cfg, self.traffic, self.device = config, traffic, device
        mpc, robot = problem_configurations(config)
        self.bundle = build_mpc_solver(mpc, robot,
                                       solver_configuration(config),
                                       device=device)
        geometry = {k: traffic[k] for k in (
            "ref_step_m", "ref_speed", "obstacle_ahead_m", "obstacle_left_m",
            "obstacle_radius_m", "spawn_half_width_m", "q_stc", "q_dyn")}
        self.B = traffic["batch"]
        self.gen = RecedingProblems(config["mpc"], self.B, seed, **geometry)
        self.states, self.u_prev = self.gen.states, self.gen.u_prev
        self.guess, self.k = self.gen.U0, 0
        self.solved = []            # (Z, u, cost, pred_states, exit_ok)
        for _ in range(1 + traffic["steps_in"]):
            self._step(keep=False)

    def _step(self, keep: bool):
        """Pose, solve and advance one receding-horizon step."""
        Z = self.gen.make_Z(self.states, self.u_prev, self.k)
        sol = self.bundle.solve_batch_escalated(Z, self.guess)
        u = sol.u.cpu().numpy()                  # the step's one host copy
        if keep:
            self.solved.append((Z, sol.u, sol.cost, sol.pred_states,
                                sol.exit_ok))
        self.states, self.u_prev, self.guess = self.gen.advance(
            self.states, u)
        self.k += 1
        return sol

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self._step(keep=True)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        n = len(self.solved)
        failed = sum(int((~s[4]).sum()) for s in self.solved)
        return {"metrics": {"solves_per_s": self.B * n / elapsed},
                "attempted": self.B * n, "failed": failed}

    def traced(self) -> dict:
        Z = self.gen.make_Z(self.states, self.u_prev, self.k)
        Zd = torch.as_tensor(Z, device=self.device)
        U0 = torch.as_tensor(self.guess, device=self.device)

        def sync():
            harness.sync(self.device)

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            out = fn(Zd, U0)
            sync()
            return time.perf_counter() - t0, out

        esc_s, sol = timed(self.bundle.solve_batch_escalated)
        warm_s, _ = timed(self.bundle.solve_batch)
        keep = {}

        def esc():
            keep["sol"] = self.bundle.solve_batch_escalated(Zd, U0)
            sync()

        escalated = profiler.trace(esc, host=False)
        warm = profiler.trace(lambda: (self.bundle.solve_batch(Zd, U0),
                                       sync()), host=True)
        for s in (sol, keep["sol"]):
            self.solved.append((Z, s.u, s.cost, s.pred_states, s.exit_ok))
        scfg = solver_configuration(self.cfg)
        K = spd_systems(self.B, scfg)["slots"]
        obs = {
            "spans": {"escalated_s": esc_s, "warm_stage_s": warm_s},
            "traces": {"escalated": escalated, "warm": warm},
            "work": {"solve_flops": escalated_solve_flops(self.B, scfg,
                                                          self.cfg["mpc"]),
                     "lanes": self.B, "slots": K,
                     "n": self.cfg["mpc"]["nu"] * self.cfg["mpc"]["N_hor"]},
        }
        failed = sum(int((~s[4]).sum()) for s in self.solved)
        return {"observations": obs, "attempted": self.B * len(self.solved),
                "failed": failed, "busy_s": escalated["busy_s"],
                "window_s": escalated["wall_s"],
                "breakdown": {"device_ops": escalated["device_ops"],
                              "idle_gaps": warm["idle_gaps"]}}

    def release(self):
        """Free the program's state; the window's outputs stay."""
        self.bundle = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, control: bool = False) -> dict:
        """The reference's readings of every kept solve.  control=True
        judges the control instead: each solve's actions rounded to
        bfloat16, with its cost and predicted states worked out by the
        reference in bfloat16."""
        mpc, robot = self.cfg["mpc"], self.cfg["robot"]
        per = {k: [] for k in ("cost_gap", "states_gap", "box_violation",
                               "infeasibility", "descent_gap")}
        oks = []
        for Z, u, cost, pred, ok in self.solved:
            Zd = torch.as_tensor(Z, device=self.device)
            if control:
                u = u.to(torch.bfloat16)
                P = reference.unpack(Zd.to(torch.bfloat16), mpc)
                with torch.no_grad():
                    cost, _, _, pred, _ = reference.evaluate(u, P, mpc, robot)
            r = reference.judge(Zd, u, cost, pred, ok, mpc, robot,
                                self.cfg["solver"]["constraint_tol"])
            for k in per:
                per[k].append(r[k])
            oks.append(ok.to(torch.bool))
        allv = {k: torch.cat(v) for k, v in per.items()}
        ok = torch.cat(oks)
        st = allv["descent_gap"][ok]
        tol = self.cfg["solver"]["constraint_tol"]
        return {
            "cost_gap": float(allv["cost_gap"].max()),
            "states_gap_m": float(allv["states_gap"].max()),
            "box_violation": float(allv["box_violation"].max()),
            "infeasibility_ok_over_tol": float(
                allv["infeasibility"][ok].max() / tol) if bool(ok.any())
            else 0.0,
            "descent_gap_p90": float(torch.quantile(st, 0.9))
            if st.numel() else 0.0,
            "descent_gap_max": float(st.max()) if st.numel() else 0.0,
            "converged_share": float(ok.double().mean()),
        }
