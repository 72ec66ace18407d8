"""Plain reference of the warehouse NMPC problem, in batched PyTorch.

It judges what an escalated solve returns, from the packed problems the
solver was handed: the objective, the constraints, and how far one Newton
step from the returned action sequences could still lower a penalty merit
(stationarity, without the solver's multipliers).  The problem is the
reference repository's `mpc_fast` NMPC (RA-L 2023: unicycle, RK4, N_hor
steps of ts): the cost terms, the acceleration constraints f1 held in a
rectangle by an augmented Lagrangian and the penalty vector f2 of static
polygon and pedestrian-ellipse violations, written from that formulation
with its documented quirks (the reference-path window shrinks; the
"current" fleet term skips slot 0; the "current" ellipse term reuses step
0 of each obstacle; f2 repeats the static sum in every slot).  It imports
nothing of the program and computes in the dtype it is given (float64 for
the judgement, bfloat16 for the control).
"""
from __future__ import annotations

import torch

from ..generators.receding import field_sizes


def unpack(Z: torch.Tensor, mpc: dict) -> dict:
    """(B, n_params) -> {field: (B, ...)}."""
    out, at = {}, 0
    B = Z.shape[0]
    for name, shape in field_sizes(mpc):
        size = 1
        for s in shape:
            size *= s
        out[name] = Z[:, at:at + size].reshape((B,) + shape)
        at += size
    return out


def rollout(s0: torch.Tensor, u: torch.Tensor, ts: float) -> torch.Tensor:
    """(B, 3) states and (B, N, 2) actions -> (B, N, 3) states after each
    action (RK4, the action held over the step)."""
    def d(x, a):
        return ts * torch.stack([a[:, 0] * torch.cos(x[:, 2]),
                                 a[:, 0] * torch.sin(x[:, 2]), a[:, 1]], 1)

    s, out = s0, []
    for k in range(u.shape[1]):
        a = u[:, k]
        k1 = d(s, a)
        k2 = d(s + 0.5 * k1, a)
        k3 = d(s + 0.5 * k2, a)
        k4 = d(s + k3, a)
        s = s + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        out.append(s)
    return torch.stack(out, 1)


def _relu(x):
    return torch.clamp(x, min=0.0)


def _ellipses(xy, ell, margin):
    """(B, N, 2) positions against (B, N, M, 6) ellipses (x, y, rx, ry,
    angle, alpha) widened by `margin`: 1 - u^2 - v^2, > 0 inside."""
    dx = xy[:, :, None, 0] - ell[..., 0]
    dy = xy[:, :, None, 1] - ell[..., 1]
    c, s = torch.cos(ell[..., 4]), torch.sin(ell[..., 4])
    rx = ell[..., 2] + margin + 1e-6
    ry = ell[..., 3] + margin + 1e-6
    uu = (dx * c + dy * s) / rx
    vv = (dx * s - dy * c) / ry
    return 1.0 - uu * uu - vv * vv


def _polygons(xy, stc, n_edges):
    """(B, N, Nstc): product over edges of relu(b - a0 x - a1 y), > 0
    inside."""
    b = stc[:, None, :, :n_edges]
    a0 = stc[:, None, :, n_edges:2 * n_edges]
    a1 = stc[:, None, :, 2 * n_edges:]
    res = _relu(b - a0 * xy[:, :, None, None, 0] - a1 * xy[:, :, None, None, 1])
    return torch.prod(res, dim=-1)


def evaluate(u_flat: torch.Tensor, P: dict, mpc: dict, robot: dict):
    """Objective f (B,), acceleration values f1 (B, 2N), penalty vector f2
    (B, Ndynobs), states (B, N, 3) and the disaggregated inside-indicators
    g (B, N Nstcobs + 2 N Ndynobs), > 0 where violated."""
    N, ts = mpc["N_hor"], mpc["ts"]
    B = u_flat.shape[0]
    u = u_flat.reshape(B, N, mpc["nu"])
    states = rollout(P["s0"], u, ts)
    xy = states[..., :2]
    q = P["q"]
    qvel, rv, rw = q[:, 1], q[:, 3], q[:, 4]
    qN, qthetaN, qrpd, acc_pen, wacc_pen = (q[:, 5], q[:, 6], q[:, 7],
                                            q[:, 8], q[:, 9])

    # Reference-path deviation: state k against segments j >= k.
    ref = torch.cat([P["ref_states"][..., :2], P["ref_states"][:, -1:, :2]], 1)
    a, bb = ref[:, :-1], ref[:, 1:]
    seg = bb - a
    len_sq = (seg * seg).sum(-1) + 1e-16
    rel = xy[:, :, None, :] - a[:, None]
    t = torch.clamp((rel * seg[:, None]).sum(-1) / len_sq[:, None], 0.0, 1.0)
    closest = a[:, None] + t[..., None] * seg[:, None]
    dist_sq = ((xy[:, :, None, :] - closest) ** 2).sum(-1)
    idx = torch.arange(N, device=u.device)
    window = idx[None, :] >= idx[:, None]
    dist_sq = torch.where(window, dist_sq, torch.full_like(dist_sq, float("inf")))
    cost = qrpd * dist_sq.amin(-1).sum(-1)
    cost = cost + (qvel[:, None] * (u[..., 0] - P["ref_speed"]) ** 2).sum(-1)
    cost = cost + (rv[:, None] * u[..., 0] ** 2 + rw[:, None] * u[..., 1] ** 2
                   ).sum(-1)

    # Other robots: current positions (slots 1..) weight 1000, predicted
    # positions at each step weight 10.
    w2 = robot["vehicle_width"] ** 2
    others0 = P["others0"][:, 1:, :2]
    d0 = ((xy[:, :, None, :] - others0[:, None]) ** 2).sum(-1)
    cost = cost + 1000.0 * _relu(w2 - d0).sum((-1, -2))
    pred = P["others_pred"][..., :2].transpose(1, 2)            # (B, N, M, 2)
    dk = ((xy[:, :, None, :] - pred) ** 2).sum(-1)
    cost = cost + 10.0 * _relu(w2 - dk).sum((-1, -2))

    # Static polygons.
    inside = _polygons(xy, P["stc_obs"], mpc["nstcobs"] // 3)
    cost = cost + (P["q_stc"][:, :, None] * inside ** 2).sum((-1, -2))
    static_violation = inside.sum((-1, -2))

    # Pedestrian ellipses: the "current" block repeats step 0 at every k,
    # the predictive block takes step k + 1 for state k.
    dyn = P["dyn_obs"]
    cur = dyn[:, :, 0][:, None].expand(B, N, -1, -1)            # (B, N, M, 6)
    soft = robot["vehicle_margin"] + robot["social_margin"]
    cur_raw = _ellipses(xy, cur, 0.0)
    cost = cost + 1000.0 * (cur[..., 5] * _relu(_ellipses(xy, cur, soft)) ** 2
                            ).sum((-1, -2))
    prd = dyn[:, :, 1:].transpose(1, 2)                         # (B, N, M, 6)
    prd_raw = _ellipses(xy, prd, 0.0)
    cost = cost + (P["q_dyn"][:, :, None] * prd[..., 5] * _relu(
        _ellipses(xy, prd, robot["vehicle_margin"])) ** 2).sum((-1, -2))

    # Terminal state.
    sT, sN = states[:, -1], P["sN"]
    cost = cost + qN * ((sT[:, 0] - sN[:, 0]) ** 2 + (sT[:, 1] - sN[:, 1]) ** 2)
    cost = cost + qthetaN * (sT[:, 2] - sN[:, 2]) ** 2

    # Accelerations: cost and the ALM constraint values.
    v, w = u[..., 0], u[..., 1]
    acc = (v - torch.cat([P["u_prev"][:, :1], v[:, :-1]], 1)) / ts
    wacc = (w - torch.cat([P["u_prev"][:, 1:2], w[:, :-1]], 1)) / ts
    cost = cost + acc_pen * (acc ** 2).sum(-1) + wacc_pen * (wacc ** 2).sum(-1)
    f1 = torch.cat([acc, wacc], 1)
    f2 = static_violation[:, None] + _relu(cur_raw).sum(1) + _relu(prd_raw).sum(1)
    g = torch.cat([inside.reshape(B, -1), cur_raw.reshape(B, -1),
                   prd_raw.reshape(B, -1)], 1)
    return cost, f1, f2, states, g


def bounds(mpc: dict, robot: dict, dtype, device):
    """Box of the decision vector and rectangle of f1."""
    N = mpc["N_hor"]
    kw = dict(dtype=dtype, device=device)
    lo = torch.tensor([robot["lin_vel_min"], -robot["ang_vel_max"]], **kw
                      ).repeat(N)
    hi = torch.tensor([robot["lin_vel_max"], robot["ang_vel_max"]], **kw
                      ).repeat(N)
    c_lo = torch.cat([torch.full((N,), robot["lin_acc_min"], **kw),
                      torch.full((N,), -robot["ang_acc_max"], **kw)])
    c_hi = torch.cat([torch.full((N,), robot["lin_acc_max"], **kw),
                      torch.full((N,), robot["ang_acc_max"], **kw)])
    return lo, hi, c_lo, c_hi


def infeasibility(f1, f2, c_lo, c_hi):
    """max(|f1 - proj_C(f1)|, |f2|) per lane."""
    viol1 = (f1 - torch.minimum(torch.maximum(f1, c_lo), c_hi)).abs().amax(-1)
    return torch.maximum(viol1, f2.abs().amax(-1))


def descent_gap(u: torch.Tensor, P: dict, mpc: dict, robot: dict,
                tol: float, rho: float = 1e6) -> torch.Tensor:
    """How far each lane is from a local minimum at u (B, n): the largest
    relative decrease of the objective, (f(u) - f(u')) / (1 + |f(u)|) and
    at least 0, over the points u' that one projected Levenberg-Marquardt
    Newton step of the penalty merit

        m(u) = f(u) + rho / 2 (|f1 - proj_C(f1)|^2 + |f2|^2)

    reaches from u over a ladder of dampings (coordinates at a bound that
    the gradient pushes out are held), among those no less feasible than
    max(tol, infeasibility at u).  Near zero at a local minimum of the
    constrained problem, whatever the multipliers that found it."""
    from torch.func import grad, hessian, vmap

    lo, hi, c_lo, c_hi = bounds(mpc, robot, u.dtype, u.device)

    def merit_lane(ul, Pl):
        P1 = {k: v[None] for k, v in Pl.items()}
        f, f1, f2, _, _ = evaluate(ul[None], P1, mpc, robot)
        v1 = f1 - torch.minimum(torch.maximum(f1, c_lo), c_hi)
        return f[0] + 0.5 * rho * ((v1 * v1).sum() + (f2 * f2).sum())

    def objective(ub):
        f, f1, f2, _, _ = evaluate(ub, P, mpc, robot)
        return f, infeasibility(f1, f2, c_lo, c_hi)

    f0, inf0 = objective(u)
    allowed = inf0.clamp_min(tol)
    g = vmap(grad(merit_lane))(u, P)
    H = vmap(hessian(merit_lane))(u, P)
    held = ((u <= lo) & (g > 0)) | ((u >= hi) & (g < 0))
    free = (~held).to(u.dtype)
    Hf = H * free[:, :, None] * free[:, None, :] + torch.diag_embed(1 - free)
    scale = torch.diagonal(Hf, dim1=-2, dim2=-1).abs().clamp_min(1.0)
    best = f0.clone()
    for lam in (0.0, 1e-6, 1e-4, 1e-2, 1.0, 1e2, 1e4):
        A = Hf + lam * torch.diag_embed(scale)
        d = torch.linalg.solve_ex(A, (g * free)[..., None])[0][..., 0]
        uc = torch.minimum(torch.maximum(u - d, lo), hi)
        fc, infc = objective(uc)
        good = (torch.isfinite(fc) & torch.isfinite(uc).all(-1)
                & (infc <= allowed))
        best = torch.where(good & (fc < best), fc, best)
    return ((f0 - best) / (1.0 + f0.abs())).clamp_min(0.0)


def judge(Z, u, cost, pred_states, exit_ok, mpc, robot, tol: float,
          dtype=torch.float64, block: int = 512):
    """Per-lane readings of one solve's outputs against the problems Z:
    cost_gap |cost - f(u)| / (1 + |f(u)|), states_gap max |pred - X(u)| (m),
    box_violation, infeasibility (float64, at u) and descent_gap (on the
    lanes reported converged, NaN elsewhere).  Tensors of (B, ...)."""
    out = {k: [] for k in ("cost_gap", "states_gap", "box_violation",
                           "infeasibility", "descent_gap")}
    for s in range(0, Z.shape[0], block):
        sl = slice(s, s + block)
        Zb = Z[sl].to(dtype)
        ub = u[sl].to(dtype)
        P = unpack(Zb, mpc)
        lo, hi, c_lo, c_hi = bounds(mpc, robot, dtype, Zb.device)
        with torch.no_grad():
            f, f1, f2, X, _ = evaluate(ub, P, mpc, robot)
        out["cost_gap"].append((cost[sl].to(dtype) - f).abs() / (1 + f.abs()))
        out["states_gap"].append(
            (pred_states[sl].to(dtype) - X).abs().amax((-1, -2)))
        out["box_violation"].append(
            torch.maximum(lo - ub, ub - hi).clamp_min(0).amax(-1))
        out["infeasibility"].append(infeasibility(f1, f2, c_lo, c_hi))
        st = torch.full_like(f, float("nan"))
        ok = exit_ok[sl].to(torch.bool)
        if bool(ok.any()):
            Pk = {k: v[ok] for k, v in P.items()}
            st[ok] = descent_gap(ub[ok], Pk, mpc, robot, tol)
        out["descent_gap"].append(st)
    return {k: torch.cat(v) for k, v in out.items()}
