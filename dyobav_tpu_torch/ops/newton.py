"""Second-order ALM solver (two-metric projected Levenberg–Marquardt Newton),
the port of `dyobav_tpu.ops.newton`.

The JAX package writes a per-problem solver and vmaps it.  Here the batch
is written out: every tensor of the solver loop carries a leading lane dim
B, and the LM ladder is a second dim (B, 4, ...).  Per-lane derivatives
(merit gradient, block Hessian) come from `torch.func.vmap` over per-lane
functions; the batched SPD solve is called outside any transform, once per
substep on (B, 4, n, n).  `lax.scan` becomes a Python loop whose carries
are tensors, and convergence stays masked (`torch.where`): no lane exits
early.

Every mode of the JAX solver is ported: the fused single-loop ALM
(`solve_fused`, the `fused=True` default) and the staged `solve`
(`fused=False`, one Python loop per ALM stage); the three exact merit
Hessians (`"block"`, the default, `"structured"` and `"jacfwd"`, the
last also when no split objective is given); and three linear solvers:
the hand-written SPD kernel (`"pallas"`), its plain version
(`"cholesky"`) and `schulz_spd_solve` (`"schulz"`, matrix products only,
which launches no kernel of the port's own).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, grad_and_value, jacfwd, jvp, vmap

from ..configs import SolverConfiguration
from .costs import _clip
from .spd import spd_solve, spd_solve_plain

# Damping multipliers tried in parallel each iteration (relative to carried λ).
_LM_LADDER = (0.2, 1.0, 5.0, 50.0)


def schulz_spd_solve(A: torch.Tensor, g: torch.Tensor,
                     iters: int = 14) -> torch.Tensor:
    """SPD solve A⁻¹g via Newton–Schulz inverse iteration: matrix products
    only, two batched 40×40 products an iteration over any leading dims.

    X₀ = I/λ̄ with λ̄ the Gershgorin row-sum bound gives ‖I − X₀A‖ < 1 for
    SPD A, and each iteration X ← X(2I − AX) squares the error; as in the
    JAX package X is not symmetrised.  The step is inexact at float32 level
    for ill-conditioned rungs, which the LM ladder's merit comparison
    absorbs.  On a CUDA device the products must run in float32, not TF32
    (`torch.backends.cuda.matmul.allow_tf32`, False by default).
    """
    n = A.shape[-1]
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)
    lam = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    X = eye_n / lam[..., None, None]
    two_eye = 2.0 * eye_n
    for _ in range(iters):
        X = X @ (two_eye - A @ X)
    return torch.einsum("...ij,...j->...i", X, g)


class NewtonResult(NamedTuple):
    u: torch.Tensor              # (B, n)
    cost: torch.Tensor           # (B,)
    residual: torch.Tensor       # (B,)
    infeasibility: torch.Tensor  # (B,)
    penalty: torch.Tensor        # (B,)
    converged: torch.Tensor      # (B,) bool


def make_structured_hessian(split, proj_rect, mode: str = "structured"):
    """Exact merit Hessian of one lane assembled from the problem structure,
    as `dyobav_tpu.ops.newton.make_structured_hessian`:

        ψ(u) = φ(X(u), u)  with  X_k = f(X_{k-1}, u_k)
        ∇²ψ  = Gᵀ(∇²φ)G  +  Σ_k S_kᵀ (q_k · ∇²f_k) S_k

    with G = [J; I], J = dX/du, and q the second-order adjoint.  The cost
    part Gᵀ(∇²φ)G is taken, by `mode`:
      * "structured": as n Hessian-vector products of φ along G's columns
        (`jvp` of `grad`, vmapped over the columns);
      * "block": Σ_k S7ᵀ C7 S7 + c·VᵀV from the per-step 7×7 blocks C7 and
        hinge gradients gF of `costs.make_block_curvature`.

    `split(p)` returns `costs.split_objective` for the lane's params p.
    Returns hess(u, y, c, p) -> (n, n) for one lane; vmap it over lanes.
    """
    def merit_x(phi, X, u, y, c):
        f, f1, f2 = phi(X, u)
        shifted = f1 + y / c
        alm = shifted - proj_rect(shifted)
        return f + 0.5 * c * (torch.sum(alm * alm) + torch.sum(f2 * f2))

    def hess(u, y, c, p):
        phi, roll, step, s0, blocks = split(p)
        dtype = u.dtype
        X = roll(u)                                      # (N, ns)
        N, ns = X.shape
        n = u.shape[0]
        nu = n // N

        def merit_z(zf):
            return merit_x(phi, zf[:N * ns].reshape(N, ns), zf[N * ns:], y, c)

        z = torch.cat([X.reshape(-1), u])
        prevs = torch.cat([s0[None].to(dtype), X[:-1]], dim=0)
        zk = torch.cat([prevs, u.reshape(N, nu)], dim=1)  # (N, ns+nu)

        def step_z(zz):
            return step(zz[:ns], zz[ns:])

        AB = vmap(jacfwd(step_z))(zk)                    # (N, ns, ns+nu)
        Hf = vmap(jacfwd(jacfwd(step_z)))(zk)            # (N, ns, ns+nu, ns+nu)
        A, Bm = AB[..., :ns], AB[..., ns:]

        # E_k: (nu, n) one-hot selector of u_k's slice of the flat vector.
        E = torch.eye(n, dtype=dtype, device=u.device).reshape(N, nu, n)
        Jk = torch.zeros(ns, n, dtype=dtype, device=u.device)
        Js = []
        for k in range(N):
            Jk = A[k] @ Jk + Bm[k] @ E[k]
            Js.append(Jk)
        J = torch.stack(Js)                              # (N, ns, n)

        if mode == "block":
            gz = grad(merit_z)(z)
            C7, gF = blocks(X, u, y, c)
            E_prev = torch.cat([torch.zeros_like(E[:1]), E[:-1]], dim=0)
            S7 = torch.cat([J, E, E_prev], dim=1)        # (N, ns+2nu, n)
            H_cost = torch.einsum("kpi,kpq,kqj->ij", S7, C7, S7)
            V = torch.einsum("kri,kmr->mi", J, gF)       # (M, n)
            H_cost = H_cost + c * (V.T @ V)
        else:
            # Gᵀ(∇²φ)G without the (N·ns+n)² matrix: n Hessian-vector
            # products of φ along G's columns (`jax.linearize` in JAX).
            G = torch.cat([J.reshape(N * ns, n),
                           torch.eye(n, dtype=dtype, device=u.device)])
            grad_z = grad(merit_z)
            gz = grad_z(z)
            W = vmap(lambda v: jvp(grad_z, (z,), (v,))[1])(G.T)  # (n, N·ns+n)
            H_cost = W @ G
        lam = gz[:N * ns].reshape(N, ns)

        qk = lam[N - 1]
        qs = [qk]
        for k in range(N - 2, -1, -1):
            qk = lam[k] + A[k + 1].T @ qk
            qs.append(qk)
        q = torch.stack(qs[::-1])                        # (N, ns)

        M = torch.einsum("ki,kipq->kpq", q, Hf)          # (N, ns+nu, ns+nu)
        Jprev_full = torch.cat([torch.zeros_like(J[:1]), J[:-1]], dim=0)
        S = torch.cat([Jprev_full, E], dim=1)            # (N, ns+nu, n)
        H_dyn = torch.einsum("kpi,kpq,kqj->ij", S, M, S)

        H = H_cost + H_dyn
        return 0.5 * (H + H.T)

    return hess


def make_alm_newton_solver(
    objective: Callable,
    u_lo: torch.Tensor,
    u_hi: torch.Tensor,
    c_lo: torch.Tensor,
    c_hi: torch.Tensor,
    solver_cfg: SolverConfiguration,
    split: Callable | None = None,
):
    """Build the batched ALM-Newton solve.

    objective(u, p) -> (f, f1, f2) for ONE lane with params p, and
    split(p) -> `costs.split_objective(p, ...)`.  The returned
    solve(u0 (B, n), P) takes params P whose fields carry the lane dim B
    and returns a NewtonResult of (B, ...) tensors.
    """
    scfg = solver_cfg
    n = u_lo.shape[0]
    dtype, device = u_lo.dtype, u_lo.device
    eye = torch.eye(n, dtype=dtype, device=device)
    bound_eps = 1e-9

    if scfg.linear_solver == "pallas":
        lin_solve = spd_solve
    elif scfg.linear_solver == "cholesky":
        lin_solve = spd_solve_plain
    elif scfg.linear_solver == "schulz":
        def lin_solve(A, g):
            return schulz_spd_solve(A, g, scfg.schulz_iters)
    else:
        raise ValueError(f"unknown linear_solver {scfg.linear_solver!r}")

    def proj_box(u):
        return _clip(u, u_lo, u_hi)

    def proj_rect(x):
        return _clip(x, c_lo, c_hi)

    def merit_fn(u, y, c, p):
        f, f1, f2 = objective(u, p)
        shifted = f1 + y / c
        alm = shifted - proj_rect(shifted)
        return f + 0.5 * c * (torch.sum(alm * alm) + torch.sum(f2 * f2))

    def merit_grad(u, y, c, P):
        """(ψ (B,), ∇ψ (B, n))."""
        g, psi = vmap(grad_and_value(merit_fn))(u, y, c, P)
        return psi, g

    if split is not None and scfg.hessian_mode in ("structured", "block"):
        # Structure-exploiting exact Hessian: no tangents through the
        # rollout's loop.
        hess_lane = make_structured_hessian(split, proj_rect,
                                            scfg.hessian_mode)
    else:
        # Forward-over-reverse: n tangents through the rollout.
        hess_lane = jacfwd(grad(merit_fn))

    def merit_hess(u, y, c, P):
        return vmap(hess_lane)(u, y, c, P)

    merit_rungs = vmap(vmap(merit_fn, in_dims=(0, None, None, None)))
    objective_b = vmap(objective)
    lm_ladder = torch.tensor(_LM_LADDER, dtype=dtype, device=device)

    def rung_solve(u, y, c, P, H, g_u, lam_c):
        """The LM ladder's candidates at damping lam_c (B, 4): the linear
        solve of every lane and rung in one call, then the projected
        candidates and their merits (inf where not finite)."""
        at_lo = (u <= u_lo + bound_eps) & (g_u > 0)
        at_hi = (u >= u_hi - bound_eps) & (g_u < 0)
        free = torch.logical_not(at_lo | at_hi).to(dtype)
        Mfree = free[:, :, None] * free[:, None, :]
        H_free = H * Mfree + (1.0 - torch.diag_embed(free)) * eye
        g_free = g_u * free
        diag_scale = torch.maximum(
            torch.abs(torch.diagonal(H_free, dim1=-2, dim2=-1)),
            torch.ones_like(free))
        A = (H_free[:, None]
             + lam_c[..., None, None] * torch.diag_embed(diag_scale)[:, None])
        d = -lin_solve(A, g_free[:, None].expand(-1, lam_c.shape[1], -1))
        u_c = proj_box(u[:, None] + d)                   # (B, 4, n)
        psi_c = merit_rungs(u_c, y, c, P)                # (B, 4)
        valid = torch.all(torch.isfinite(u_c), dim=-1) & torch.isfinite(psi_c)
        return u_c, torch.where(valid, psi_c, torch.full_like(psi_c,
                                                              float("inf")))

    def stationarity_probe(u, y, c, P):
        """(scaled residual, settled) at the returned iterate: one more full
        Newton iteration at fresh damping; settled if no rung improves the
        merit while moving a control coordinate by more than tol."""
        psi_u, g_u = merit_grad(u, y, c, P)
        H = merit_hess(u, y, c, P)
        scale = torch.maximum(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)),
                              torch.ones_like(u))
        r = torch.amax(torch.abs(u - proj_box(u - g_u / scale)), dim=-1)
        lam_c = (1e-3 * lm_ladder).expand(u.shape[0], -1)
        u_c, psis = rung_solve(u, y, c, P, H, g_u, lam_c)
        dus = torch.amax(torch.abs(u_c - u[:, None]), dim=-1)
        improves = psis < (psi_u - 1e-6 * (1.0 + torch.abs(psi_u)))[:, None]
        settled = torch.logical_not(
            torch.any(improves & (dus > scfg.tol), dim=-1))
        return r, settled

    n_stage_iters = [scfg.max_inner_iters] + [
        max(scfg.inner_iters_later, 4)
    ] * (scfg.max_outer_iters - 1)

    def alm_update(u, y, c, prev_inf, P):
        """One multiplier/penalty update (OpEn semantics: escalate c by the
        update factor unless infeasibility dropped 10x)."""
        _, f1, f2 = objective_b(u, P)
        shifted = f1 + y / c[:, None]
        y_new = y + c[:, None] * (f1 - proj_rect(shifted))
        viol1 = torch.amax(torch.abs(f1 - proj_rect(f1)), dim=-1)
        inf_new = torch.maximum(viol1, torch.amax(torch.abs(f2), dim=-1))
        improved = inf_new <= 0.1 * prev_inf
        c_new = torch.where(improved, c, c * scfg.penalty_update_factor)
        return y_new, c_new, inf_new

    def substep(u, psi_u, g_u, lam, H, y, c, frozen, P):
        lam_c = lam[:, None] * lm_ladder                 # (B, 4)
        cu, cpsi = rung_solve(u, y, c, P, H, g_u, lam_c)
        best = torch.argmin(cpsi, dim=1)                 # first minimum
        psi_best = torch.gather(cpsi, 1, best[:, None])[:, 0]
        lam_best = torch.gather(lam_c, 1, best[:, None])[:, 0]
        u_best = torch.gather(
            cu, 1, best[:, None, None].expand(-1, 1, n))[:, 0]
        improved = psi_best < psi_u - 1e-12
        move = improved & torch.logical_not(frozen)
        u_new = torch.where(move[:, None], u_best, u)
        lam_new = torch.where(
            improved,
            torch.maximum(lam_best * 0.5, torch.full_like(lam, 1e-10)),
            torch.minimum(lam * 100.0, torch.full_like(lam, 1e10)))
        return u_new, lam_new, improved

    n_substeps = max(int(scfg.newton_substeps), 1)

    def scaled_residual(u, y, c, P):
        """Diagonal-Newton stationarity residual in control units (B,): the
        projected-gradient step with each coordinate scaled by the merit
        Hessian's diagonal, curvature- and penalty-invariant."""
        _, g = merit_grad(u, y, c, P)
        H = merit_hess(u, y, c, P)
        scale = torch.maximum(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)),
                              torch.ones_like(u))
        return torch.amax(torch.abs(u - proj_box(u - g / scale)), dim=-1)

    def solve_fused(u0: torch.Tensor, P) -> NewtonResult:
        """Single-loop ALM: all stages in one loop, with the multiplier /
        penalty updates applied at masked stage boundaries."""
        B = u0.shape[0]
        total = sum(n_stage_iters)
        boundary = np.zeros(total, bool)
        boundary[np.cumsum(n_stage_iters) - 1] = True

        u = proj_box(u0.to(dtype))
        y = torch.zeros(B, c_lo.shape[0], dtype=dtype, device=device)
        c = torch.full((B,), scfg.initial_penalty, dtype=dtype, device=device)
        psi_u, g_u = merit_grad(u, y, c, P)
        lam = torch.full((B,), 1e-3, dtype=dtype, device=device)
        false = torch.zeros(B, dtype=torch.bool, device=device)
        done, outer_done = false, false
        prev_inf = torch.zeros(B, dtype=dtype, device=device)
        y_solved, c_solved = y, c

        for is_boundary in boundary:
            frozen = done | outer_done
            # One exact Hessian per iteration; the substeps share it (chord
            # method) while the active set and gradient are refreshed.
            H = merit_hess(u, y, c, P)
            u_new, lam_new, improved = substep(u, psi_u, g_u, lam, H, y, c,
                                               frozen, P)
            for _ in range(n_substeps - 1):
                psi_mid, g_mid = merit_grad(u_new, y, c, P)
                u_new, lam_new, improved = substep(
                    u_new, psi_mid, g_mid, lam_new, H, y, c, frozen, P)

            # Masked ALM stage-boundary update.
            if is_boundary:
                y_b, c_b, inf_b = alm_update(u_new, y, c, prev_inf, P)
                upd = torch.logical_not(outer_done)
                y_new = torch.where(upd[:, None], y_b, y)
                c_new = torch.where(upd, c_b, c)
                prev_inf_new = torch.where(upd, inf_b, prev_inf)
                outer_done_new = outer_done | (upd
                                               & (inf_b <= scfg.constraint_tol))
            else:
                upd = false
                y_new, c_new = y, c
                prev_inf_new, outer_done_new = prev_inf, outer_done

            psi_new, g_new = merit_grad(u_new, y_new, c_new, P)
            r_norm = torch.amax(torch.abs(u_new - proj_box(u_new - g_new)),
                                dim=-1)
            done_new = done | (r_norm <= scfg.tol) | (
                torch.logical_not(improved) & (lam >= 1e8))
            done_new = torch.where(upd, false, done_new)
            lam_new = torch.where(upd, torch.full_like(lam_new, 1e-3),
                                  lam_new)
            # The multipliers the accepted iterate was solved under.
            y_solved = torch.where(outer_done[:, None], y_solved, y)
            c_solved = torch.where(outer_done, c_solved, c)

            u, psi_u, g_u, lam, done = u_new, psi_new, g_new, lam_new, done_new
            y, c, prev_inf, outer_done = (y_new, c_new, prev_inf_new,
                                          outer_done_new)

        r_final, settled = stationarity_probe(u, y_solved, c_solved, P)
        f, f1, f2 = objective_b(u, P)
        viol1 = torch.amax(torch.abs(f1 - proj_rect(f1)), dim=-1)
        infeas = torch.maximum(viol1, torch.amax(torch.abs(f2), dim=-1))
        return NewtonResult(
            u=u, cost=f, residual=r_final, infeasibility=infeas, penalty=c,
            converged=(infeas <= scfg.constraint_tol)
            & ((r_final <= scfg.tol) | settled))

    def inner_solve(u0, y, c, P, n_iters: int):
        """n_iters LM-Newton iterations at fixed (y, c); a lane stops moving
        once done.  Returns (u, scaled residual)."""
        B = u0.shape[0]
        psi_u, g_u = merit_grad(u0, y, c, P)
        u = u0
        lam = torch.full((B,), 1e-3, dtype=dtype, device=device)
        done = torch.zeros(B, dtype=torch.bool, device=device)
        for _ in range(n_iters):
            # One exact Hessian per iteration; the substeps share it, as in
            # the fused loop.
            H = merit_hess(u, y, c, P)
            u_new, lam_new, improved = substep(u, psi_u, g_u, lam, H, y, c,
                                               done, P)
            for _ in range(n_substeps - 1):
                psi_mid, g_mid = merit_grad(u_new, y, c, P)
                u_new, lam_new, improved = substep(
                    u_new, psi_mid, g_mid, lam_new, H, y, c, done, P)
            psi_new, g_new = merit_grad(u_new, y, c, P)
            r_norm = torch.amax(torch.abs(u_new - proj_box(u_new - g_new)),
                                dim=-1)
            done = done | (r_norm <= scfg.tol) | (
                torch.logical_not(improved) & (lam >= 1e8))
            u, psi_u, g_u, lam = u_new, psi_new, g_new, lam_new
        return u, scaled_residual(u, y, c, P)

    def solve(u0: torch.Tensor, P) -> NewtonResult:
        """Staged ALM: one inner solve per stage, then the multiplier /
        penalty update; a lane whose stage met the constraint tolerance
        keeps its iterate through the later stages (per-lane masks)."""
        B = u0.shape[0]
        u = proj_box(u0.to(dtype))
        y = torch.zeros(B, c_lo.shape[0], dtype=dtype, device=device)
        c = torch.full((B,), scfg.initial_penalty, dtype=dtype, device=device)
        prev_inf = torch.zeros(B, dtype=dtype, device=device)
        outer_done = torch.zeros(B, dtype=torch.bool, device=device)
        r_final = torch.full((B,), float("inf"), dtype=dtype, device=device)
        y_solved, c_solved = y, c
        for n_iters in n_stage_iters:
            u_new, r_norm = inner_solve(u, y, c, P, n_iters)
            y_new, c_new, inf_new = alm_update(u_new, y, c, prev_inf, P)
            keep = outer_done
            y_solved = torch.where(keep[:, None], y_solved, y)
            c_solved = torch.where(keep, c_solved, c)
            u = torch.where(keep[:, None], u, u_new)
            y = torch.where(keep[:, None], y, y_new)
            c = torch.where(keep, c, c_new)
            prev_inf = torch.where(keep, prev_inf, inf_new)
            r_final = torch.where(keep, r_final, r_norm)
            outer_done = outer_done | (inf_new <= scfg.constraint_tol)

        # As in the JAX package, the probe's residual supersedes r_final.
        r_final, settled = stationarity_probe(u, y_solved, c_solved, P)
        f, f1, f2 = objective_b(u, P)
        viol1 = torch.amax(torch.abs(f1 - proj_rect(f1)), dim=-1)
        infeas = torch.maximum(viol1, torch.amax(torch.abs(f2), dim=-1))
        return NewtonResult(
            u=u, cost=f, residual=r_final, infeasibility=infeas, penalty=c,
            converged=(infeas <= scfg.constraint_tol)
            & ((r_final <= scfg.tol) | settled))

    return solve_fused if scfg.fused else solve
