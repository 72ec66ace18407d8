"""NMPC engine: config → batched solve functions on one device, the port of
`dyobav_tpu.ops.engine`.

`build_mpc_solver` closes the cost library over the configuration and
returns plain functions on tensors.  PyTorch runs eagerly, so nothing is
compiled; the bundle is still memoized on the configuration and the device
so every caller of one configuration shares one set of closures.

Entry points run on the card: `device=None` resolves to `cuda` and raises
when there is none.  Pass `device="cpu"` to run on the CPU (the tests do).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ..configs import (CircularRobotSpecification, MpcConfiguration,
                       SolverConfiguration)
from ..utils.profiling import span
from . import costs
from .newton import make_alm_newton_solver
from .panoc import make_panoc_solver
from .params import unpack


class MpcSolve(NamedTuple):
    u: torch.Tensor              # (B, N_hor * nu) optimal action sequences
    cost: torch.Tensor           # (B,) objective at the solution
    pred_states: torch.Tensor    # (B, N_hor, ns) predicted states under u
    exit_ok: torch.Tensor        # (B,) bool: converged within tolerances
    infeasibility: torch.Tensor  # (B,) constraint violation
    residual: torch.Tensor       # (B,) stationarity residual (control units)


class MpcSolverBundle(NamedTuple):
    solve: Callable             # (z, u0) -> MpcSolve of one problem
    solve_batch: Callable       # (Z[B,n], U0[B,m]) -> MpcSolve, warm
                                # profile only (cold problems belong on
                                # solve_batch_escalated)
    objective: Callable         # (u, z) -> CostBreakdown of one problem
    n_params: int
    n_decision: int
    device: torch.device
    solve_batch_escalated: Callable | None = None
                                # warm profile for every lane + deep
                                # re-solve of the non-converged tail
                                # (requires cold_profile)


def resolve_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when None; raises without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dyobav_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def profile_configuration(scfg: SolverConfiguration,
                          prof) -> SolverConfiguration:
    """`scfg` at the budget of a stage profile (inner, outer, later,
    substeps[, penalty]), with no cold profile of its own."""
    prof = tuple(prof)
    ci, co, cl, cs = prof[:4]
    pen = prof[4] if len(prof) > 4 else 10.0
    return dataclasses.replace(
        scfg, max_inner_iters=ci, max_outer_iters=co, inner_iters_later=cl,
        newton_substeps=cs, initial_penalty=pen, cold_profile=None)


def escalation_ladder(scfg: SolverConfiguration):
    """(stage profiles, slots): the configured ladder, or the cold profile
    followed by the strong budget; slots(B) gives each stage's slot count
    K = max(B // divisor, min(B, 16), 1), later stages reusing the last
    divisor."""
    ladder = (list(tuple(p) for p in scfg.escalation_ladder)
              if scfg.escalation_ladder
              else [tuple(scfg.cold_profile), (30, 10, 10, 1, 10.0)])
    divisors = tuple(scfg.escalation_slots)
    if len(divisors) < len(ladder):
        divisors = divisors + (divisors[-1],) * (len(ladder) - len(divisors))
    return ladder, lambda B: [max(B // d, min(B, 16), 1) for d in divisors]


def any_lane(mask: torch.Tensor) -> bool:
    """True if any lane of `mask` is set.  This reads one bool back to the
    host: the device-to-host sync that takes the place of the JAX package's
    `lax.cond(jnp.any(...))`.  `any_lane.syncs` counts them."""
    any_lane.syncs += 1
    return bool(torch.any(mask))


any_lane.syncs = 0


def to_host(t: torch.Tensor):
    """`t` as a numpy array, in one device-to-host copy (a host sync on the
    card).  `to_host.syncs` counts them."""
    to_host.syncs += 1
    return t.cpu().numpy()


to_host.syncs = 0


def gather_slots(mask: torch.Tensor, K: int):
    """Static-size gather of the first K set lanes of `mask` in lane order,
    without a host sync (`jnp.nonzero(mask, size=K, fill_value=0)`).

    Returns (idx (K,), slot (B,), in_slot (B,)): slot k re-solves lane
    idx[k]; each set lane's slot is its rank among the set lanes; lanes
    past K and unset lanes are not in a slot, and unfilled slots hold
    lane 0.  `new[slot]` then reads every lane's slot result back."""
    B = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.long), 0) - 1
    in_slot = mask & (rank < K)
    target = torch.where(in_slot, rank, torch.full_like(rank, K))
    idx = torch.zeros(K + 1, dtype=torch.long, device=mask.device)
    idx.scatter_(0, target, torch.arange(B, device=mask.device))
    return idx[:K], torch.clamp(rank, 0, K - 1), in_slot


def merge_slots(take: torch.Tensor, slot: torch.Tensor, old, new):
    """Lane b takes `new[slot[b]]` where `take[b]`, else keeps `old[b]`;
    `old` and `new` are NamedTuples of (B, ...) and (K, ...) tensors."""
    B = take.shape[0]

    def merge(o, n):
        return torch.where(take.reshape((B,) + (1,) * (n.ndim - 1)),
                           n[slot], o)

    return type(old)(*[merge(o, n) for o, n in zip(old, new)])


def escalate_tail(sol, runs, slots, res_tol, ok_of):
    """The escalation ladder shared by `solve_batch_escalated` and the
    batched simulation's `solve_batch`.

    sol: a NamedTuple of (B, ...) results with `cost` and `residual`;
    ok_of(sol) gives its (B,) convergence flag.  Each stage gathers the
    lanes that failed (or sit in the residual band above `res_tol`) into
    K = slots[i] static slots, `runs[i](idx, sol)` re-solves them, and a
    lane takes its re-solve where that converged -- a band lane (already
    ok) only on a clear cost gain, or on a residual gain that does not
    regress cost.  A batch with no such lane skips the stage: one host
    sync per stage.  A stage that runs is the span `solve.stage.<i>`."""
    for i, (run, K) in enumerate(zip(runs, slots)):
        ok = ok_of(sol)
        fail = torch.logical_not(ok)
        if res_tol is not None:
            fail = fail | (sol.residual > res_tol)
        if not any_lane(fail):
            continue
        with span(f"solve.stage.{i}", fail):
            idx, slot, in_slot = gather_slots(fail, K)
            deep = run(idx, sol)
            cost_eps = 1e-6 * (1.0 + torch.abs(sol.cost))
            cost_gain = deep.cost[slot] <= sol.cost - 1e3 * cost_eps
            band_better = cost_gain | (
                (deep.residual[slot] <= sol.residual)
                & (deep.cost[slot] <= sol.cost + cost_eps))
            take = in_slot & ok_of(deep)[slot] & (
                torch.logical_not(ok) | band_better)
            sol = merge_slots(take, slot, sol, deep)
    return sol


def build_mpc_solver(
    cfg: MpcConfiguration,
    robot: CircularRobotSpecification,
    solver_cfg: SolverConfiguration | None = None,
    dtype=torch.float32,
    method: str = "newton",
    device=None,
) -> MpcSolverBundle:
    """Construct the batched NMPC solve for one (MPC config, robot spec)
    pair on one device.

    method: "newton" (the dense-Hessian ALM of `ops.newton`, the default)
    or "panoc" (the first-order L-BFGS PANOC of `ops.panoc`), for the warm
    solve and every escalation stage alike.  Bundles are memoized on the
    full configuration and the device.
    """
    if method not in ("newton", "panoc"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    key = repr((cfg, robot, solver_cfg, dtype, method, str(dev)))
    cached = _BUNDLE_CACHE.get(key)
    if cached is not None:
        return cached
    _check_cold_safety(solver_cfg)
    bundle = _build_mpc_solver_uncached(cfg, robot, solver_cfg, dtype,
                                        method, dev)
    _BUNDLE_CACHE[key] = bundle
    return bundle


_BUNDLE_CACHE: dict = {}
_COLD_WARNED = False


def _check_cold_safety(scfg: SolverConfiguration | None) -> None:
    """One-time warning for a penalty-pre-escalated warm profile with NO
    cold escalation path: such a bundle's `solve_batch` converges only a
    minority of cold (no-warm-start) problems.  From-scratch penalty ramps
    (initial_penalty < 100) are self-sufficient and stay silent."""
    global _COLD_WARNED
    if scfg is None or _COLD_WARNED:
        return
    if scfg.cold_profile is None and scfg.initial_penalty >= 100.0:
        warnings.warn(
            "SolverConfiguration has a pre-escalated warm penalty "
            f"(initial_penalty={scfg.initial_penalty}) but cold_profile="
            "None: bundle.solve_batch will converge only a minority of "
            "cold (no-warm-start) problems.  Set cold_profile (default) and "
            "route cold/distressed solves through solve_batch_escalated, "
            "or use strong_configuration().",
            stacklevel=3)
        _COLD_WARNED = True


def _build_mpc_solver_uncached(cfg, robot, solver_cfg, dtype, method: str,
                               device: torch.device) -> MpcSolverBundle:
    scfg = solver_cfg or SolverConfiguration()
    if scfg.dtype is not None:
        dtype = scfg.dtype

    u_lo, u_hi = costs.action_bounds(cfg, robot, dtype, device)
    c_lo, c_hi = costs.acceleration_bounds(cfg, robot, dtype, device)

    def obj(u_flat, p):
        br = costs.evaluate(u_flat, p, cfg, robot)
        return br.objective, br.f1, br.f2

    def split(p):
        return costs.split_objective(p, cfg, robot)

    def states_of(u_flat, p):
        return costs.evaluate(u_flat, p, cfg, robot).states

    pred_states = vmap(states_of)

    def as_input(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def make_batch_solve(stage_cfg):
        # The split objective feeds Newton's block Hessian; PANOC needs
        # only the merit's gradient.
        if method == "newton":
            solver = make_alm_newton_solver(obj, u_lo, u_hi, c_lo, c_hi,
                                            stage_cfg, split=split)
        else:
            solver = make_panoc_solver(obj, u_lo, u_hi, c_lo, c_hi,
                                       stage_cfg)

        def solve_batch(Z, U0) -> MpcSolve:
            P = unpack(as_input(Z), cfg)
            res = solver(as_input(U0), P)
            return MpcSolve(
                u=res.u, cost=res.cost, pred_states=pred_states(res.u, P),
                exit_ok=res.converged, infeasibility=res.infeasibility,
                residual=res.residual)

        return solve_batch

    solve_batch = make_batch_solve(scfg)

    def solve(z, u0) -> MpcSolve:
        sol = solve_batch(as_input(z)[None], as_input(u0)[None])
        return MpcSolve(*[f[0] for f in sol])

    def objective(u_flat, z):
        return costs.evaluate(as_input(u_flat), unpack(as_input(z), cfg),
                              cfg, robot)

    # Escalated batch solve: every lane gets the warm profile; lanes that
    # fail the convergence test (or sit in the residual band) are gathered
    # into K static slots, re-solved with each ladder stage's budget and
    # merged back where the re-solve converged (cost-gated for band lanes).
    # As in the JAX engine, the band's `escalation_residual_tol` applies to
    # PANOC's fixed-point residual too, though its scale is another.
    solve_batch_escalated = None
    if scfg.cold_profile:
        ladder, slots = escalation_ladder(scfg)
        # Optional 6th profile element: from_iterate (continue from the
        # failing lane's returned iterate instead of its original guess).
        stages = [make_batch_solve(profile_configuration(scfg, p[:5]))
                  for p in ladder]
        from_iterate = [bool(p[5]) if len(p) > 5 else False for p in ladder]
        res_tol = scfg.escalation_residual_tol

        def solve_batch_escalated(Z, U0) -> MpcSolve:
            Z, U0 = as_input(Z), as_input(U0)
            with span("solve.escalated", Z):
                with span("solve.warm", Z):
                    sol = solve_batch(Z, U0)
                runs = [
                    lambda idx, cur, stage=stage, cont=cont: stage(
                        Z[idx], cur.u[idx] if cont else U0[idx])
                    for stage, cont in zip(stages, from_iterate)]
                return escalate_tail(sol, runs, slots(Z.shape[0]), res_tol,
                                     ok_of=lambda r: r.exit_ok)

    return MpcSolverBundle(
        solve=solve,
        solve_batch=solve_batch,
        objective=objective,
        n_params=cfg.n_params,
        n_decision=cfg.nu * cfg.N_hor,
        device=device,
        solve_batch_escalated=solve_batch_escalated,
    )
