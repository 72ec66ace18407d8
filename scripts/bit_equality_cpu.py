"""Record the port's derivative outputs on the CPU, and compare two records
bit for bit: the check that a change to the derivative code (`ops/costs`,
`motion/models`, `ops/newton`) moves no value.

Each record holds, in float32 and float64:
  * `block_fn` = `costs.make_block_curvature(...)`'s (C7, gF) on two busy
    problems (every cost and constraint term active) at c = 10 and 1250,
    and the lane Hessian of `newton.make_structured_hessian(..., "block")`;
  * one `solve_batch_escalated` of the first 16 problems of bench.py's
    seeded generator (`chip_smoke.make_problems`, step 0);
  * the 2-step head-on fleet run of `scripts/fleet_step_cpu.py`.

    python scripts/bit_equality_cpu.py --out a.pt [--root OTHER_CHECKOUT]
    python scripts/bit_equality_cpu.py --compare a.pt b.pt

`--root` imports the package (and `chip_smoke.py`) from another checkout,
so one copy of this script records a parent commit too.  `--compare`
prints, for every output, the largest absolute difference, whether the
two are equal bit for bit, and whether they differ only in the sign of
zeros; it exits 1 unless every largest difference is 0.0.
"""
import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_problem(seed, cfg, dtype):
    """(p, u, X): a problem whose every cost and constraint term is active
    along the rollout of u (tests/test_torch_costs.py's `_busy_problem`,
    without JAX)."""
    from dyobav_tpu_torch.motion.models import unicycle_step_np
    from dyobav_tpu_torch.ops import params

    N, ns = cfg.N_hor, cfg.ns
    rng = np.random.default_rng(seed)
    u = np.stack([rng.uniform(0.5, 1.4, N), rng.uniform(-0.4, 0.4, N)], 1)
    s0 = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                   rng.uniform(-0.3, 0.3)])
    states = [s0]
    for k in range(N):
        states.append(unicycle_step_np(states[-1], u[k], cfg.ts))
    X = np.array(states[1:])
    ref = X + rng.normal(0, 0.3, X.shape)
    stc = np.zeros((cfg.Nstcobs, cfg.nstcobs))
    for i, k in enumerate(rng.choice(N, 4, replace=False)):
        cx, cy = X[k, :2] + rng.normal(0, 0.1, 2)
        h = rng.uniform(0.2, 0.5)
        stc[i] = [cx + h, -(cx - h), cy + h, -(cy - h),
                  1, -1, 0, 0, 0, 0, 1, -1]
    others0 = np.zeros((cfg.Nother, ns))
    others0[:4, :2] = X[rng.choice(N, 4), :2] + rng.normal(0, 0.2, (4, 2))
    others_pred = np.zeros((cfg.Nother, N, ns))
    others_pred[:3, :, :2] = X[None, :, :2] + rng.normal(0, 0.3, (3, N, 2))
    dyn = np.zeros((cfg.Ndynobs, N + 1, cfg.ndynobs))
    for i in range(4):
        k = rng.integers(N)
        dyn[i, :, :2] = X[k, :2] + rng.normal(0, 0.3, 2)
        dyn[i, 1:, :2] += (rng.normal(0, 0.1, (N, 2))
                           + (X[:, :2] - X[k, :2]) * (i % 2))
        dyn[i, :, 2:4] = rng.uniform(0.2, 0.6, 2)
        dyn[i, :, 4] = rng.uniform(-np.pi, np.pi)
        dyn[i, :, 5] = 1.0
    fields = dict(
        u_prev=u[0] + rng.normal(0, 0.2, 2), s0=s0, sN=ref[-1],
        q=params.tuning_vector(cfg) + rng.uniform(0, 5, cfg.nq),
        ref_states=ref, ref_speed=rng.uniform(0.8, 1.4, N),
        others0=others0, others_pred=others_pred, stc_obs=stc, dyn_obs=dyn,
        q_stc=rng.uniform(5, 15, N), q_dyn=rng.uniform(5, 15, N))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)

    p = params.MpcParams(**{k: t(v) for k, v in fields.items()})
    return p, t(u.reshape(-1)), t(X)


def record_blocks(cfg, robot, dtype, out):
    from dyobav_tpu_torch.ops import costs
    from dyobav_tpu_torch.ops.newton import make_structured_hessian

    lo, hi = costs.acceleration_bounds(cfg, robot, dtype)
    hess = make_structured_hessian(
        lambda p: costs.split_objective(p, cfg, robot),
        lambda x: costs._clip(x, lo, hi), "block")
    rng = np.random.default_rng(7)
    for seed in range(2):
        p, u, X = busy_problem(seed, cfg, dtype)
        y = torch.as_tensor(rng.normal(0, 1, 2 * cfg.N_hor)).to(dtype)
        for c in (10.0, 1250.0):
            ct = torch.tensor(c, dtype=dtype)
            C7, gF = costs.make_block_curvature(p, cfg, robot)(X, u, y, ct)
            tag = f"{dtype}/seed{seed}/c{c:g}"
            out[f"block_fn.C7/{tag}"] = C7
            out[f"block_fn.gF/{tag}"] = gF
            out[f"hessian/{tag}"] = hess(u, y, ct, p)


def record_solve(cfg, robot, dtype, out, batch=16):
    from chip_smoke import make_problems
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    make_Z, states, u_prev, U0 = make_problems(cfg, 2048, seed=0)
    Z = torch.as_tensor(make_Z(states, u_prev, 0)[:batch]).to(dtype)
    bundle = build_mpc_solver(cfg, robot, SolverConfiguration(), dtype=dtype,
                              device="cpu")
    sol = bundle.solve_batch_escalated(Z, torch.as_tensor(U0[:batch]).to(
        dtype))
    for k, v in sol._asdict().items():
        if torch.is_tensor(v):
            out[f"solve_batch_escalated.{k}/{dtype}"] = v


def record_fleet(cfg, robot, dtype, out, steps=2):
    from dyobav_tpu_torch import configs
    from dyobav_tpu_torch.sim import fleet, scenarios

    fast = configs.SolverConfiguration(
        max_inner_iters=8, max_outer_iters=2, inner_iters_later=4,
        escalation_ladder=((4, 2, 2, 1, 10.0),), escalation_slots=(4,))
    sc = scenarios.synthetic_fleet_scenario(
        [[0.0, 0.2, 0.0], [8.0, -0.2, np.pi]], [[8.0, 0.2], [0.0, -0.2]],
        base_speed=robot.lin_vel_max * 0.8, ts=cfg.ts)
    batch = fleet.FleetScenario(*[np.stack([x, x]) for x in sc])
    res = fleet.build_fleet_sim(cfg, robot, fast, n_robots=2, n_steps=steps,
                                dtype=dtype, device="cpu")(batch,
                                                           np.arange(2))
    for k, v in res._asdict().items():
        if torch.is_tensor(v):
            out[f"fleet.{k}/{dtype}"] = v


def record(path, root):
    sys.path.insert(0, root)
    torch.set_num_threads(1)
    from dyobav_tpu_torch import configs

    cfg, robot = configs.MpcConfiguration(), \
        configs.CircularRobotSpecification()
    out = {}
    for dtype in (torch.float32, torch.float64):
        record_blocks(cfg, robot, dtype, out)
        record_solve(cfg, robot, dtype, out)
        record_fleet(cfg, robot, dtype, out)
    torch.save({k: v.detach().cpu() for k, v in out.items()}, path)
    print(f"{len(out)} outputs from {root} -> {path}")


def compare(a_path, b_path) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    if sorted(a) != sorted(b):
        print("the two records hold different outputs")
        return 1
    worst = 0.0
    for k in sorted(a):
        x, y = a[k], b[k]
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            d = torch.where(same, torch.zeros_like(x), (x - y).abs())
            diff = float(torch.nan_to_num(d, nan=float("inf")).max()) \
                if d.numel() else 0.0
            ints = {torch.float32: torch.int32, torch.float64: torch.int64}
            bits = torch.equal(x.view(ints[x.dtype]), y.view(ints[y.dtype]))
            zero_signs = int(((x == 0) & (y == 0)
                              & (torch.signbit(x) != torch.signbit(y))).sum())
        else:
            diff = 0.0 if torch.equal(x, y) else float("inf")
            bits, zero_signs = torch.equal(x, y), 0
        worst = max(worst, diff)
        print(f"{k:60s} max|a-b| {diff:.3g}  bit-equal {bits}"
              + (f"  zeros of opposite sign {zero_signs}" if zero_signs else ""))
    print(f"largest absolute difference over {len(a)} outputs: {worst}")
    return 0 if worst == 0.0 else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write a record here")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is recorded")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("give --out or --compare")
    record(args.out, os.path.abspath(args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
