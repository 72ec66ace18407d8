"""PANOC/ALM NMPC solver (the OpEn-lineage first-order method), the port of
`dyobav_tpu.ops.panoc`.

  outer loop  — augmented Lagrangian on the acceleration rectangle F1 ∈ C
                plus a quadratic penalty on the obstacle violations F2 = 0,
                penalty c multiplied by the update factor per stage;
  inner loop  — PANOC: projected-gradient fixed-point iterations
                accelerated by L-BFGS directions, globalized with a
                forward-backward-envelope (FBE) line search.

The JAX package writes a per-problem solver and vmaps it.  Here the batch
is written out: every tensor carries a leading lane dim B, the L-BFGS
buffers are (B, m, n) with a per-lane head, and the three FBE
τ-candidates are evaluated as one merit-and-gradient call on B·3 rows.
Only the per-lane merit goes through `torch.func.vmap`; its gradient is
autograd's on the batch.
The ALM stages and the inner iterations are Python loops with masked
updates (no lane exits early), so a solve reads nothing back to the host.
PANOC solves no linear system and runs no hand-written kernel.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ..configs import SolverConfiguration
from .costs import _clip

# τ ladder for the FBE line search.  τ=1 is the full L-BFGS step, τ=0 the
# pure proximal-gradient step (accepted whenever γ is valid).
_TAU_LADDER = (1.0, 0.5, 0.0)


class PanocResult(NamedTuple):
    u: torch.Tensor              # (B, n) solutions
    cost: torch.Tensor           # (B,) raw objective f(u) (no penalty terms)
    residual: torch.Tensor       # (B,) last fixed-point residual (inf-norm)
    infeasibility: torch.Tensor  # (B,) final constraint violation (inf-norm)
    penalty: torch.Tensor        # (B,) final penalty weight
    converged: torch.Tensor      # (B,) bool


class LbfgsBuf(NamedTuple):
    s: torch.Tensor     # (B, m, n) displacement history
    y: torch.Tensor     # (B, m, n) residual-difference history
    rho: torch.Tensor   # (B, m) 1/(s·y); 0 marks an empty or rejected slot
    head: torch.Tensor  # (B,) int64: next write position (mod m)


def lbfgs_init(B: int, m: int, n: int, dtype, device) -> LbfgsBuf:
    return LbfgsBuf(
        s=torch.zeros(B, m, n, dtype=dtype, device=device),
        y=torch.zeros(B, m, n, dtype=dtype, device=device),
        rho=torch.zeros(B, m, dtype=dtype, device=device),
        head=torch.zeros(B, dtype=torch.long, device=device))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def lbfgs_push(buf: LbfgsBuf, s: torch.Tensor, y: torch.Tensor,
               enabled: torch.Tensor) -> LbfgsBuf:
    """Write the pair (s, y) of each enabled lane whose curvature s·y is
    positive into its slot head % m and advance that lane's head."""
    m = buf.s.shape[1]
    sy = _dot(s, y)
    ok = enabled & (sy > 1e-12 * (_dot(y, y) + 1e-30))
    rho_new = torch.where(ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)),
                          torch.zeros_like(sy))
    write = ok[:, None] & (torch.arange(m, device=s.device)[None]
                           == (buf.head % m)[:, None])          # (B, m)
    return LbfgsBuf(
        s=torch.where(write[..., None], s[:, None], buf.s),
        y=torch.where(write[..., None], y[:, None], buf.y),
        rho=torch.where(write, rho_new[:, None], buf.rho),
        head=buf.head + ok.to(buf.head.dtype))


def lbfgs_direction(buf: LbfgsBuf, r: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion per lane: d ≈ -H r with H the inverse-Jacobian
    estimate, the slots visited newest first, (head - 1 - j) % m."""
    m = buf.s.shape[1]
    order = (buf.head[:, None] - 1
             - torch.arange(m, device=r.device)[None]) % m      # (B, m)
    # Each lane's slots, newest first: j-th of `slots` is its (s, y, rho).
    s_ord = torch.take_along_dim(buf.s, order[..., None], dim=1)
    y_ord = torch.take_along_dim(buf.y, order[..., None], dim=1)
    rho_ord = torch.take_along_dim(buf.rho, order, dim=1)
    slots = [(s_ord[:, j], y_ord[:, j], rho_ord[:, j]) for j in range(m)]
    q = r
    alphas = []
    for s_i, y_i, rho_i in slots:
        alpha = rho_i * _dot(s_i, q)
        q = q - alpha[:, None] * y_i
        alphas.append(alpha)

    s0, y0, rho0 = slots[0]
    ys = _dot(s0, y0)
    yy = _dot(y0, y0)
    gamma0 = torch.where((rho0 > 0) & (yy > 1e-30), ys / (yy + 1e-30),
                         torch.ones_like(ys))
    q = gamma0[:, None] * q

    for (s_i, y_i, rho_i), alpha in zip(reversed(slots), reversed(alphas)):
        beta = rho_i * _dot(y_i, q)
        q = q + (alpha - beta)[:, None] * s_i
    return -q


def _repeat_lanes(P, k: int):
    """Each lane's params repeated k times in place: (B, ...) -> (B·k, ...)."""
    if torch.is_tensor(P):
        return P.repeat_interleave(k, dim=0)
    return type(P)(*[_repeat_lanes(t, k) for t in P])


def make_panoc_solver(
    objective: Callable,
    u_lo: torch.Tensor,
    u_hi: torch.Tensor,
    c_lo: torch.Tensor,
    c_hi: torch.Tensor,
    solver_cfg: SolverConfiguration,
):
    """Build the batched PANOC/ALM solve of a box-constrained ALM problem.

    objective(u, p) -> (f, F1, F2) for ONE lane with params p: f scalar
    smooth cost; F1 (p,) ALM constraint values with target rectangle
    [c_lo, c_hi]; F2 (q,) penalty-constraint values with target 0.
    u_lo / u_hi: (n,) hard box on the decision variables.  The returned
    solve(u0 (B, n), P) takes params P (a tensor or a NamedTuple of
    tensors) with the lane dim B leading, and returns a PanocResult of
    (B, ...) tensors.
    """
    scfg = solver_cfg
    sigma_fbe = 0.1
    dtype, device = u_lo.dtype, u_lo.device
    taus = torch.tensor(_TAU_LADDER, dtype=dtype, device=device)
    n_tau = len(_TAU_LADDER)

    def proj_box(u):
        return _clip(u, u_lo, u_hi)

    def proj_rect(x):
        return _clip(x, c_lo, c_hi)

    def merit(u, y, c, p):
        f, f1, f2 = objective(u, p)
        shifted = f1 + y / c
        alm = shifted - proj_rect(shifted)
        return f + 0.5 * c * (torch.sum(alm * alm) + torch.sum(f2 * f2))

    merit_lanes = vmap(merit)
    objective_b = vmap(objective)

    def merit_and_grad(u, y, c, P):
        """(ψ (rows,), ∇ψ (rows, n)).  Rows are independent, so the
        gradient of the summed merits is each row's own gradient: the same
        values as `vmap(grad_and_value(merit))`, bit for bit, with about a
        third fewer operations dispatched by the host."""
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            psi = merit_lanes(u, y, c, P)
            (g,) = torch.autograd.grad(psi.sum(), u)
        return psi.detach(), g

    def prox_point(u, g, gamma):
        u_half = proj_box(u - gamma[..., None] * g)
        r = (u - u_half) / gamma[..., None]
        return u_half, r

    def fbe_value(psi_u, g_u, u, u_half, gamma):
        diff = u_half - u
        return psi_u + _dot(g_u, diff) + torch.sum(diff * diff, -1) / (2 * gamma)

    def inner_solve(u0, y, c, P, P3, n_iters: int):
        """Fixed-iteration PANOC minimizing the ALM merit over the box:
        returns the iterate, the last iteration's pre-move residual and
        the done flags."""
        B, n = u0.shape
        psi_u, g_u = merit_and_grad(u0, y, c, P)

        # Step-size init from a finite-difference curvature estimate.
        delta = 1e-4 * (torch.abs(u0) + 1.0)
        _, g_d = merit_and_grad(u0 + delta, y, c, P)
        lip = (torch.linalg.vector_norm(g_d - g_u, dim=-1)
               / (torch.linalg.vector_norm(delta, dim=-1) + 1e-30))
        gamma = _clip(0.95 / torch.clamp(lip, min=1e-12), 1e-8, 1e4)

        buf = lbfgs_init(B, scfg.lbfgs_memory, n, dtype, device)
        y3 = y.repeat_interleave(n_tau, dim=0)
        c3 = c.repeat_interleave(n_tau, dim=0)
        u = u0
        done = torch.zeros(B, dtype=torch.bool, device=device)
        lanes = torch.arange(B, device=device)
        r_norm = None
        for _ in range(n_iters):
            u_half, r = prox_point(u, g_u, gamma)
            r_norm = torch.amax(torch.abs(r), dim=-1)
            phi_u = fbe_value(psi_u, g_u, u, u_half, gamma)
            d = lbfgs_direction(buf, r)

            # The τ-candidates of every lane as B·3 rows, lane-major.
            cu = proj_box(u[:, None] + (1.0 - taus)[None, :, None]
                          * (u_half - u)[:, None] + taus[None, :, None]
                          * d[:, None])                          # (B, 3, n)
            cpsi, cg = merit_and_grad(cu.reshape(B * n_tau, n), y3, c3, P3)
            gamma3 = gamma.repeat_interleave(n_tau, dim=0)
            cu_half, cr = prox_point(cu.reshape(B * n_tau, n), cg, gamma3)
            cphi = fbe_value(cpsi, cg, cu.reshape(B * n_tau, n), cu_half,
                             gamma3)
            cpsi, cphi = cpsi.reshape(B, n_tau), cphi.reshape(B, n_tau)
            cg, cr = cg.reshape(B, n_tau, n), cr.reshape(B, n_tau, n)

            # γ validity: quadratic upper bound at the prox point (τ=0 slot).
            diff0 = u_half - u
            ub = (psi_u + _dot(g_u, diff0)
                  + torch.sum(diff0 * diff0, -1) / (2 * gamma))
            gamma_ok = cpsi[:, -1] <= ub + 1e-6 * torch.abs(ub) + 1e-9

            accept = cphi <= (phi_u - sigma_fbe * gamma
                              * torch.sum(r * r, -1))[:, None]
            accept[:, -1] = True                   # prox step: fallback
            pick = torch.argmax(accept.to(torch.uint8), dim=1)  # first max

            move = gamma_ok & torch.logical_not(done)
            u_new = torch.where(move[:, None], cu[lanes, pick], u)
            psi_u = torch.where(move, cpsi[lanes, pick], psi_u)
            g_u = torch.where(move[:, None], cg[lanes, pick], g_u)
            gamma = torch.where(gamma_ok, gamma, gamma * 0.5)

            buf = lbfgs_push(buf, u_new - u, cr[lanes, pick] - r, move)
            done = done | (r_norm <= scfg.tol)
            u = u_new
        return u, r_norm, done

    n_stage_iters = [scfg.max_inner_iters] + [
        max(scfg.inner_iters_later, 8)
    ] * (scfg.max_outer_iters - 1)

    def violation(f1, f2):
        viol1 = torch.amax(torch.abs(f1 - proj_rect(f1)), dim=-1)
        return torch.maximum(viol1, torch.amax(torch.abs(f2), dim=-1))

    def solve(u0: torch.Tensor, P) -> PanocResult:
        B = u0.shape[0]
        u = proj_box(u0.to(dtype))
        y = torch.zeros(B, c_lo.shape[0], dtype=dtype, device=device)
        c = torch.full((B,), scfg.initial_penalty, dtype=dtype, device=device)
        # prev_inf starts at 0 so the first stage never counts as
        # "improved": the penalty escalates every stage until the
        # infeasibility drops 10x stage over stage (OpEn's rule).
        prev_inf = torch.zeros(B, dtype=dtype, device=device)
        outer_done = torch.zeros(B, dtype=torch.bool, device=device)
        r_final = torch.full((B,), float("inf"), dtype=dtype, device=device)
        P3 = _repeat_lanes(P, n_tau)

        for n_iters in n_stage_iters:
            u_new, r_norm, _ = inner_solve(u, y, c, P, P3, n_iters)

            _, f1, f2 = objective_b(u_new, P)
            shifted = f1 + y / c[:, None]
            y_new = y + c[:, None] * (f1 - proj_rect(shifted))
            inf_new = violation(f1, f2)

            improved = inf_new <= 0.1 * prev_inf
            c_new = torch.where(improved, c, c * scfg.penalty_update_factor)

            keep = outer_done
            u = torch.where(keep[:, None], u, u_new)
            y = torch.where(keep[:, None], y, y_new)
            c = torch.where(keep, c, c_new)
            prev_inf = torch.where(keep, prev_inf, inf_new)
            r_final = torch.where(keep, r_final, r_norm)
            outer_done = outer_done | (inf_new <= scfg.constraint_tol)

        f, f1, f2 = objective_b(u, P)
        infeas = violation(f1, f2)
        return PanocResult(
            u=u, cost=f, residual=r_final, infeasibility=infeas, penalty=c,
            converged=(infeas <= scfg.constraint_tol)
            & (r_final <= 10 * scfg.tol))

    return solve
