"""NMPC objective + constraint functions in PyTorch, the port of
`dyobav_tpu.ops.costs`.

Every function here takes ONE problem (unbatched tensors, like the JAX
functions) and is batched by the caller with `torch.func.vmap`; the
derivatives the solver needs come from `torch.func` transforms of these
same functions.

Reference quirks kept as spec (see `dyobav_tpu/ops/costs.py:13-25`):
  - `cost_refpath_deviation` takes the min over a *shrinking* segment
    window: state k only sees reference segments j >= k;
  - the "current" fleet-collision term skips other-robot slot 0;
  - the "current" dynamic-obstacle term reuses horizon-step 0 of o_d at
    every k; the predictive term uses step k+1;
  - F2 has Ndynobs components, each equal to [shared static-obstacle
    violation sum] + [that obstacle's own dynamic violation sum].

Gradient tie-breaks follow JAX's: `jnp.maximum`/`jnp.minimum`/`jnp.clip`
split the gradient evenly at ties and `jnp.min` splits it evenly over equal
minima.  So the port uses `torch.maximum`/`torch.minimum` (via `_clip`,
`_relu`) and `torch.amin`; never `clamp`, `relu` or `min(dim)`, whose
gradients at ties differ.  `jnp.prod` over polygon edges becomes an
explicit product (the same product rule, no data-dependent backward).

Python numbers go through the `.Scalar` overloads and the block Hessian's
tensor constants are lifted into its tangent levels (`ops/tangents.py`):
the same values, without torch's Python reference kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from ..configs import CircularRobotSpecification, MpcConfiguration
from ..motion.models import unicycle_step
from . import tangents
from .params import MpcParams

_add = torch.ops.aten.add.Scalar
_mul = torch.ops.aten.mul.Scalar
_div = torch.ops.aten.div.Scalar
_rsub = torch.ops.aten.rsub.Scalar


def _relu(x: torch.Tensor, zero: torch.Tensor | None = None) -> torch.Tensor:
    """`jnp.maximum(0.0, x)`: gradient 1/2 at x == 0, as in JAX.  zero: a
    0-dim zero at x's tangent levels (`tangents.lift`), else one is made."""
    return torch.maximum(x, torch.zeros_like(x) if zero is None else zero)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` = minimum(maximum(x, lo), hi), JAX's tie-breaks.
    A bound given as a number is filled on x's device (no host copy)."""
    lo = lo if torch.is_tensor(lo) else torch.full_like(x, lo)
    hi = hi if torch.is_tensor(hi) else torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def rollout_states(s0: torch.Tensor, u: torch.Tensor, ts: float) -> torch.Tensor:
    """Roll the unicycle model over the horizon.

    s0: (ns,) initial state.  u: (N, nu) actions.
    Returns (N, ns) states after each action (t = 1..N).
    """
    states = []
    s = s0
    for k in range(u.shape[0]):
        s = unicycle_step(s, u[k], ts)
        states.append(s)
    return torch.stack(states)


def refpath_deviation_cost(states_xy: torch.Tensor, ref_pts: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Sum_k weight * min_{j>=k} dist²(state_k, segment_j).

    ref_pts is (N+1, 2): the N reference positions with the last repeated.
    """
    N = states_xy.shape[0]
    seg_a, seg_b = ref_pts[:-1], ref_pts[1:]
    d = seg_b - seg_a
    len_sq = torch.sum(d * d, dim=-1) + 1e-16
    rel = states_xy[:, None, :] - seg_a[None, :, :]           # (N, N, 2)
    t = _clip(torch.sum(rel * d[None], dim=-1) / len_sq, 0.0, 1.0)
    closest = seg_a[None] + t[..., None] * d[None]
    dist_sq = torch.sum((states_xy[:, None, :] - closest) ** 2, dim=-1)
    idx = torch.arange(N, device=states_xy.device)
    masked = torch.where(idx[None, :] >= idx[:, None], dist_sq,
                         torch.full_like(dist_sq, float("inf")))
    return torch.sum(weight * torch.amin(masked, dim=1))


def fleet_collision_cost(states_xy: torch.Tensor, others_xy: torch.Tensor,
                         safe_distance: float, weight: float,
                         per_step: bool) -> torch.Tensor:
    """Hinge on squared clearance to other robots.

    others_xy: (M, 2) at every step (per_step=False) or (N, M, 2).
    """
    if per_step:
        diff = states_xy[:, None, :] - others_xy
    else:
        diff = states_xy[:, None, :] - others_xy[None]
    dist_sq = torch.sum(diff * diff, dim=-1)
    return weight * torch.sum(_relu(safe_distance ** 2 - dist_sq))


def _polygon_residuals(states_xy: torch.Tensor, stc_obs: torch.Tensor,
                       n_edges: int, zero: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Per-(step, obstacle) inside-indicator, (N, Nstcobs):
    prod_edges relu(b - a0 x - a1 y), > 0 iff inside."""
    b = stc_obs[:, :n_edges]
    a0 = stc_obs[:, n_edges:2 * n_edges]
    a1 = stc_obs[:, 2 * n_edges:]
    res = _relu(b[None] - a0[None] * states_xy[:, 0, None, None]
                - a1[None] * states_xy[:, 1, None, None], zero)  # (N, Nobs, E)
    out = res[..., 0]
    for e in range(1, n_edges):
        out = out * res[..., e]
    return out


def _ellipse_geometry(ell: torch.Tensor, extra_margin: float) -> tuple:
    """(x, y, rx, ry, cos, sin) of ellipse rows (x, y, rx, ry, ang, alpha),
    the radii widened by extra_margin: the part of `_ellipse_indicator`
    that does not depend on the states, which the block Hessian computes
    once, outside its derivatives."""
    return (ell[..., 0], ell[..., 1],
            _add(_add(ell[..., 2], extra_margin), 1e-6),
            _add(_add(ell[..., 3], extra_margin), 1e-6),
            torch.cos(ell[..., 4]), torch.sin(ell[..., 4]))


def _ellipse_indicator(states_xy: torch.Tensor, ell: torch.Tensor,
                       extra_margin: float) -> torch.Tensor:
    """Inside-indicator for per-step ellipse sets, (N, M), > 0 inside.

    ell: (N, M, 6) rows (x, y, rx, ry, ang, alpha) aligned with states.
    """
    return _inside_ellipses(states_xy, _ellipse_geometry(ell, extra_margin))


def _inside_ellipses(states_xy: torch.Tensor, geometry: tuple
                     ) -> torch.Tensor:
    """`_ellipse_indicator` from the ellipses' `_ellipse_geometry`."""
    ex, ey, rx, ry, c, s = geometry
    dx = states_xy[:, None, 0] - ex
    dy = states_xy[:, None, 1] - ey
    u = (dx * c + dy * s) / rx
    v = (dx * s - dy * c) / ry
    return _rsub(u * u, 1.0) - v * v


class CostBreakdown(NamedTuple):
    objective: torch.Tensor     # scalar f(u; z)
    f1: torch.Tensor            # (2 N_hor,) acceleration ALM constraint values
    f2: torch.Tensor            # (Ndynobs,) penalty-constraint vector
    states: torch.Tensor        # (N_hor, ns) rolled-out states


def evaluate(u_flat: torch.Tensor, p: MpcParams, cfg: MpcConfiguration,
             robot: CircularRobotSpecification) -> CostBreakdown:
    """Full objective + constraint evaluation for one problem instance.

    u_flat: (nu*N_hor,) decision vector in [v0, w0, v1, w1, ...] order.
    """
    states = rollout_states(p.s0, u_flat.reshape(cfg.N_hor, cfg.nu), cfg.ts)
    return evaluate_states(states, u_flat, p, cfg, robot)


def evaluate_states(states: torch.Tensor, u_flat: torch.Tensor,
                    p: MpcParams, cfg: MpcConfiguration,
                    robot: CircularRobotSpecification) -> CostBreakdown:
    """`evaluate` with the rolled-out states passed in as an independent
    input: the state-space objective φ(X, u) the block Hessian uses."""
    N, nu = cfg.N_hor, cfg.nu
    u = u_flat.reshape(N, nu)
    ts = cfg.ts

    (qpos, qvel, qtheta, rv, rw, qN, qthetaN, qrpd,
     acc_penalty, w_acc_penalty) = [p.q[i] for i in range(10)]

    states_xy = states[:, :2]
    ref_pts = torch.cat([p.ref_states[:, :2], p.ref_states[-1:, :2]], dim=0)

    cost = refpath_deviation_cost(states_xy, ref_pts, qrpd)
    cost = cost + torch.sum(qvel * (u[:, 0] - p.ref_speed) ** 2)
    cost = cost + torch.sum(rv * u[:, 0] ** 2 + rw * u[:, 1] ** 2)

    # Fleet collision: current positions (skip slot 0) weight 1000;
    # predictive positions (all slots, step k) weight 10.
    cost = cost + fleet_collision_cost(states_xy, p.others0[1:, :2],
                                       robot.vehicle_width, 1000.0,
                                       per_step=False)
    others_k = torch.swapaxes(p.others_pred[..., :2], 0, 1)  # (N, Nother, 2)
    cost = cost + fleet_collision_cost(states_xy, others_k,
                                       robot.vehicle_width, 10.0,
                                       per_step=True)

    # Static polygon obstacles.
    n_edges = cfg.nstcobs // 3
    inside_stc = _polygon_residuals(states_xy, p.stc_obs, n_edges)
    cost = cost + torch.sum(p.q_stc[:, None] * inside_stc ** 2)
    static_violation = torch.sum(inside_stc)

    # Dynamic ellipse obstacles: "current" block repeats step 0 at every k.
    margin_soft = robot.vehicle_margin + robot.social_margin
    ell_cur = p.dyn_obs[:, 0, :].expand(N, -1, -1)          # (N, M, 6)
    ind_cur_raw = _ellipse_indicator(states_xy, ell_cur, 0.0)
    ind_cur_soft = _ellipse_indicator(states_xy, ell_cur, margin_soft)
    alpha_cur = ell_cur[..., 5]
    cost = cost + 1000.0 * torch.sum(alpha_cur * _relu(ind_cur_soft) ** 2)

    # Predictive block: step k+1 for state k.
    ell_pred = torch.swapaxes(p.dyn_obs[:, 1:, :], 0, 1)    # (N, M, 6)
    ind_pred_raw = _ellipse_indicator(states_xy, ell_pred, 0.0)
    ind_pred_soft = _ellipse_indicator(states_xy, ell_pred,
                                       robot.vehicle_margin)
    alpha_pred = ell_pred[..., 5]
    cost = cost + torch.sum(p.q_dyn[:, None] * alpha_pred
                            * _relu(ind_pred_soft) ** 2)

    # Terminal cost on the final rolled-out state.
    sT = states[-1]
    cost = cost + qN * ((sT[0] - p.sN[0]) ** 2 + (sT[1] - p.sN[1]) ** 2)
    cost = cost + qthetaN * (sT[2] - p.sN[2]) ** 2

    # Acceleration cost + ALM constraint values.
    v, w = u[:, 0], u[:, 1]
    acc = (v - torch.cat([p.u_prev[:1], v[:-1]])) / ts
    w_acc = (w - torch.cat([p.u_prev[1:2], w[:-1]])) / ts
    cost = cost + acc_penalty * torch.sum(acc ** 2)
    cost = cost + w_acc_penalty * torch.sum(w_acc ** 2)
    f1 = torch.cat([acc, w_acc])

    # Penalty-constraint vector F2 (Ndynobs,), see module docstring.
    dyn_violation = (torch.sum(_relu(ind_cur_raw), dim=0)
                     + torch.sum(_relu(ind_pred_raw), dim=0))
    f2 = static_violation + dyn_violation

    return CostBreakdown(objective=cost, f1=f1, f2=f2, states=states)


def split_objective(p: MpcParams, cfg: MpcConfiguration,
                    robot: CircularRobotSpecification):
    """(phi, rollout, step, s0, blocks): the structured form of the NMPC
    objective consumed by `ops.newton`'s block Hessian.

    phi(X, u)  : state-space objective (no rollout inside)
    rollout(u) : (nu*N,) -> (N, ns) horizon states
    step(x, a) : one dynamics step, for per-step Jacobians / curvature
    s0         : (ns,) initial state
    blocks     : `make_block_curvature(p, cfg, robot)`
    """
    N, nu, ts = cfg.N_hor, cfg.nu, cfg.ts

    def phi(states, u_flat):
        br = evaluate_states(states, u_flat, p, cfg, robot)
        return br.objective, br.f1, br.f2

    def roll(u_flat):
        return rollout_states(p.s0, u_flat.reshape(N, nu), ts)

    def step(x, a):
        return unicycle_step(x, a, ts)

    return phi, roll, step, p.s0, make_block_curvature(p, cfg, robot)


def make_block_curvature(p: MpcParams, cfg: MpcConfiguration,
                         robot: CircularRobotSpecification):
    """Per-horizon-step curvature of the ALM merit (block Hessian mode).

    Every merit term except the squared penalty channel Σᵢ F_i² is
    separable per step k over the 7 variables (x_k, u_k, u_{k-1}); its
    curvature is N 7×7 Hessians.  The penalty channel's curvature splits
    into per-step blocks of the weight-linearized hinges c·Σᵢ wᵢ∇²F_i
    (wᵢ = F_i frozen at the evaluation point) and the rank-M part
    c·Σᵢ ∇F_i∇F_iᵀ, returned as per-step hinge gradients.

    JAX indexes per-step data with a traced k inside `vmap`; here the
    per-step slices are stacked along a leading N dim and `vmap` maps
    over them instead (same values, no batched indexing).

    Returns block_fn(X, u_flat, y, c) -> (C7 (N, 7, 7), gF (N, M, ns)).
    """
    N, nu, ns = cfg.N_hor, cfg.nu, cfg.ns
    ts = cfg.ts
    n_edges = cfg.nstcobs // 3
    margin_soft = robot.vehicle_margin + robot.social_margin
    vw2 = robot.vehicle_width ** 2
    (qpos, qvel, qtheta, rv, rw, qN, qthetaN, qrpd,
     acc_pen, w_acc_pen) = [p.q[i] for i in range(10)]
    dtype, device = p.ref_states.dtype, p.ref_states.device
    c_lo, c_hi = acceleration_bounds(cfg, robot, dtype, device)

    ref_pts = torch.cat([p.ref_states[:, :2], p.ref_states[-1:, :2]], dim=0)
    seg_a, seg_b = ref_pts[:-1], ref_pts[1:]
    seg_d = seg_b - seg_a
    seg_len_sq = torch.sum(seg_d * seg_d, dim=-1) + 1e-16
    others_cur = p.others0[1:, :2]
    ell_cur = p.dyn_obs[:, 0, :]                                # (M, 6)
    ell_pred = torch.swapaxes(p.dyn_obs[:, 1:, :], 0, 1)        # (N, M, 6)

    ks = torch.arange(N, device=device)
    steps = dict(                                               # leading N
        window=ks[None, :] >= ks[:, None],                      # (N, N)
        last=ks == N - 1,
        ref_speed=p.ref_speed,
        others=torch.swapaxes(p.others_pred[..., :2], 0, 1),    # (N, No, 2)
        q_stc=p.q_stc,
        alpha_pred=ell_pred[..., 5],                            # (N, M)
        pred_raw=_ellipse_geometry(ell_pred[:, None], 0.0),     # (N, 1, M)
        pred_soft=_ellipse_geometry(ell_pred[:, None], robot.vehicle_margin),
        q_dyn=p.q_dyn,
        lo_a=c_lo[:N], hi_a=c_hi[:N], lo_w=c_lo[N:], hi_w=c_hi[N:],
    )
    # The problem's constants, passed as an argument so that the derivatives
    # lift them into their tangent levels (`tangents.lift`).
    consts = dict(
        seg_a=seg_a, seg_d=seg_d, seg_len_sq=seg_len_sq,
        others_cur=others_cur, stc_obs=p.stc_obs, sN=p.sN,
        alpha_cur=ell_cur[:, 5],
        cur_raw=_ellipse_geometry(ell_cur[None], 0.0),          # (1, M)
        cur_soft=_ellipse_geometry(ell_cur[None], margin_soft),
        qvel=qvel, rv=rv, rw=rw, qN=qN, qthetaN=qthetaN, qrpd=qrpd,
        acc_pen=acc_pen, w_acc_pen=w_acc_pen,
        zero=torch.zeros((), dtype=dtype, device=device),
        one=torch.ones((), dtype=dtype, device=device))

    def hinges_k(x_k, st, K):
        """(s_k, d_k (M,)): step k's contributions to S and D_i."""
        xy = x_k[:2][None]
        stc = _polygon_residuals(xy, K["stc_obs"], n_edges, K["zero"])[0]
        cur = _inside_ellipses(xy, K["cur_raw"])[0]
        prd = _inside_ellipses(xy, st["pred_raw"])[0]
        return torch.sum(stc), _relu(cur, K["zero"]) + _relu(prd, K["zero"])

    def phi_k(zz, args):
        """Step k's slice of the merit (each original term appears in
        exactly one phi_k; the penalty channel enters weight-linearized)."""
        st, ya, yw, c, w, wtot, K = args
        zero = K["zero"]
        x_k, u_k, u_km1 = zz[:ns], zz[ns:ns + nu], zz[ns + nu:]
        xy = x_k[:2]
        # refpath: min over segments j >= k (shrinking window).
        rel = xy[None] - K["seg_a"]
        t = _clip(torch.sum(rel * K["seg_d"], dim=-1) / K["seg_len_sq"],
                  zero, K["one"])
        closest = K["seg_a"] + t[:, None] * K["seg_d"]
        dist_sq = torch.sum((xy[None] - closest) ** 2, dim=-1)
        masked = torch.where(st["window"], dist_sq,
                             torch.full_like(dist_sq, float("inf")))
        cost = K["qrpd"] * torch.amin(masked)
        cost = cost + K["qvel"] * (u_k[0] - st["ref_speed"]) ** 2
        cost = cost + K["rv"] * u_k[0] ** 2 + K["rw"] * u_k[1] ** 2
        # fleet: current (skip slot 0, weight 1000) + predictive (step k).
        dcur = xy[None] - K["others_cur"]
        cost = cost + _mul(torch.sum(_relu(
            _rsub(torch.sum(dcur * dcur, dim=-1), vw2), zero)), 1000.0)
        dprd = xy[None] - st["others"]
        cost = cost + _mul(torch.sum(_relu(
            _rsub(torch.sum(dprd * dprd, dim=-1), vw2), zero)), 10.0)
        # static polygons.
        stc_prod = _polygon_residuals(xy[None], K["stc_obs"], n_edges,
                                      zero)[0]
        cost = cost + st["q_stc"] * torch.sum(stc_prod ** 2)
        # dynamic ellipses: current (soft margin, weight 1000·α) +
        # predictive (vehicle margin, weight q_dyn·α).
        ind_cur_soft = _inside_ellipses(xy[None], K["cur_soft"])[0]
        cost = cost + _mul(torch.sum(K["alpha_cur"]
                                     * _relu(ind_cur_soft, zero) ** 2),
                           1000.0)
        ind_prd_soft = _inside_ellipses(xy[None], st["pred_soft"])[0]
        cost = cost + st["q_dyn"] * torch.sum(st["alpha_pred"]
                                              * _relu(ind_prd_soft, zero) ** 2)
        # terminal (k = N-1 only).
        sN = K["sN"]
        term = (K["qN"] * ((x_k[0] - sN[0]) ** 2 + (x_k[1] - sN[1]) ** 2)
                + K["qthetaN"] * (x_k[2] - sN[2]) ** 2)
        cost = cost + torch.where(st["last"], term, torch.zeros_like(term))
        # acceleration cost + this step's ALM components.
        acc = _div(u_k[0] - u_km1[0], ts)
        wacc = _div(u_k[1] - u_km1[1], ts)
        cost = cost + K["acc_pen"] * acc ** 2 + K["w_acc_pen"] * wacc ** 2
        sh_a = acc + ya / c
        sh_w = wacc + yw / c
        alm_a = sh_a - _clip(sh_a, st["lo_a"], st["hi_a"])
        alm_w = sh_w - _clip(sh_w, st["lo_w"], st["hi_w"])
        cost = cost + _mul(c, 0.5) * (alm_a ** 2 + alm_w ** 2)
        # penalty channel, weight-linearized: c·Σᵢ wᵢ (s_k + d_ik).
        s_k, d_k = hinges_k(x_k, st, K)
        cost = cost + c * (wtot * s_k + torch.dot(w, d_k))
        return cost

    hess_k = tangents.hessian(phi_k)
    jac_hinges = tangents.jacfwd(lambda x_k, a: hinges_k(x_k, *a))

    def block_fn(X, u_flat, y, c):
        U = u_flat.reshape(N, nu)
        U_km1 = torch.cat([p.u_prev[None].to(U.dtype), U[:-1]], dim=0)
        ZZ = torch.cat([X, U, U_km1], dim=1)                    # (N, 7)
        s_all, d_all = vmap(hinges_k, in_dims=(0, 0, None))(X, steps, consts)
        w = (torch.sum(s_all) + torch.sum(d_all, dim=0)).detach()
        wtot = torch.sum(w)
        C7 = vmap(hess_k, in_dims=(0, (0, 0, 0, None, None, None, None)))(
            ZZ, (steps, y[:N], y[N:], c, w, wtot, consts))
        gs, gd = vmap(jac_hinges, in_dims=(0, (0, None)))(X, (steps, consts))
        gF = gs[:, None, :] + gd                                # (N, M, ns)
        return C7, gF

    return block_fn


def constraint_residuals(u_flat: torch.Tensor, p: MpcParams,
                         cfg: MpcConfiguration,
                         robot: CircularRobotSpecification):
    """Disaggregated smooth constraint residuals (feasible iff all <= 0).

    The penalty channel F2 (a sum of hinges, see `evaluate`) is zero
    exactly when every one of these residuals is non-positive: the same
    NLP with its constraints exposed one by one, for an independent NLP
    solver (the JAX package's `scripts/parity_check.py`).

    Returns (f1, stc, dyn):
      f1  (2 N_hor,)        acceleration values, bounded by C
      stc (N_hor * Nstcobs,) polygon inside-products (>0 inside)
      dyn (2 * N_hor * Ndynobs,) ellipse indicators, current + predictive
    """
    N, nu = cfg.N_hor, cfg.nu
    u = u_flat.reshape(N, nu)
    states_xy = rollout_states(p.s0, u, cfg.ts)[:, :2]
    stc = _polygon_residuals(states_xy, p.stc_obs, cfg.nstcobs // 3)
    ell_cur = p.dyn_obs[:, 0, :].expand(N, -1, -1)
    ind_cur = _ellipse_indicator(states_xy, ell_cur, 0.0)        # (N, M)
    ell_pred = p.dyn_obs[:, 1:, :].transpose(0, 1)              # (N, M, 6)
    ind_pred = _ellipse_indicator(states_xy, ell_pred, 0.0)      # (N, M)
    v, w = u[:, 0], u[:, 1]
    acc = (v - torch.cat([p.u_prev[:1], v[:-1]])) / cfg.ts
    w_acc = (w - torch.cat([p.u_prev[1:2], w[:-1]])) / cfg.ts
    return (torch.cat([acc, w_acc]), stc.reshape(-1),
            torch.cat([ind_cur.reshape(-1), ind_pred.reshape(-1)]))


def action_bounds(cfg: MpcConfiguration, robot: CircularRobotSpecification,
                  dtype=torch.float32, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard box bounds on the flat decision vector."""
    lo = torch.tensor([robot.lin_vel_min, -robot.ang_vel_max], dtype=dtype,
                      device=device).repeat(cfg.N_hor)
    hi = torch.tensor([robot.lin_vel_max, robot.ang_vel_max], dtype=dtype,
                      device=device).repeat(cfg.N_hor)
    return lo, hi


def acceleration_bounds(cfg: MpcConfiguration,
                        robot: CircularRobotSpecification,
                        dtype=torch.float32, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectangle C for the ALM acceleration constraints."""
    N = cfg.N_hor
    kw = dict(dtype=dtype, device=device)
    lo = torch.cat([torch.full((N,), robot.lin_acc_min, **kw),
                    torch.full((N,), -robot.ang_acc_max, **kw)])
    hi = torch.cat([torch.full((N,), robot.lin_acc_max, **kw),
                    torch.full((N,), robot.ang_acc_max, **kw)])
    return lo, hi
