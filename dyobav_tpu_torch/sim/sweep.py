"""Evaluation sweep over randomized warehouse scenarios, the port of
`dyobav_tpu.sim.sweep` on one device.

The batched counterpart of `main_eva`: randomized (start, goal,
pedestrian-seed) episodes run as one batch on the card; the statistics are
printed as one JSON object with the JAX script's keys.

    python -m dyobav_tpu_torch.sim.sweep --n 256 --steps 60
    python -m dyobav_tpu_torch.sim.sweep --robots 4 --n 32 --steps 60

It runs on the current CUDA device and raises without one; `--device cpu`
asks for the CPU.  `wall_s_first` is a one-step run that absorbs set-up
(the kernel build, CUDA library initialisation); `wall_s_steady` is the
full run, which `control_steps_per_s` is taken from (robots counted).
`--robots R > 1` runs the decentralized fleet sim (`sim.fleet`), whose
per-robot statistics are reduced per scenario as the JAX script does.
Multi-device runs (`--devices`, `--distributed`) are not ported yet
(ROADMAP.md, queue A item 13).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64, help="number of scenarios")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--humans", type=int, default=1)
    ap.add_argument("--robots", type=int, default=1,
                    help=">1 switches to the decentralized fleet sim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="more than one device is not ported")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host runs are not ported")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' must be asked for)")
    ap.add_argument("--inner-iters", type=int, default=None,
                    help="custom solver budget (default: the production "
                         "SolverConfiguration() profile)")
    ap.add_argument("--outer-iters", type=int, default=None)
    ap.add_argument("--no-multistart", action="store_true",
                    help="opt out of the tracker's 5-candidate multistart "
                         "decision rule (budget-only escalation of the "
                         "warm guess; ~5x cheaper, weaker basin recovery)")
    args = ap.parse_args(argv)
    if args.devices > 1 or args.distributed:
        ap.exit(2, "--devices / --distributed: multi-device sweeps are not "
                   "ported yet (ROADMAP.md, queue A item 13)\n")

    import torch

    from ..configs import SolverConfiguration
    from ..ops.engine import resolve_device
    from .batch import build_batch_sim
    from .fleet import build_fleet_sim
    from .harness import MainBase
    from .scenarios import random_fleet_scenarios, random_scenarios

    device = resolve_device(args.device)
    base = MainBase(max_run_time_step=args.steps, evaluation=True,
                    seed=args.seed)
    fleet = args.robots > 1
    if fleet:
        batch = random_fleet_scenarios(base, args.n, n_robots=args.robots,
                                       n_humans=args.humans, seed=args.seed,
                                       device=device)
    else:
        batch = random_scenarios(base, args.n, n_humans=args.humans,
                                 seed=args.seed, device=device)

    # Default: the shipped production operating point (one configuration
    # everywhere); passing either iteration flag opts into a custom budget.
    if args.inner_iters is not None or args.outer_iters is not None:
        inner = (args.inner_iters if args.inner_iters is not None
                 else SolverConfiguration().max_inner_iters)
        outer = (args.outer_iters if args.outer_iters is not None
                 else SolverConfiguration().max_outer_iters)
        scfg = SolverConfiguration(
            max_inner_iters=inner, max_outer_iters=outer,
            inner_iters_later=max(inner // 2, 3))
    else:
        scfg = SolverConfiguration()
    seeds = np.arange(args.n)

    def timed(n_steps):
        ms = not args.no_multistart
        if fleet:
            run = build_fleet_sim(base.config_mpc, base.config_robot, scfg,
                                  n_robots=args.robots, n_steps=n_steps,
                                  multistart=ms, device=device)
        else:
            run = build_batch_sim(base.config_mpc, base.config_robot, scfg,
                                  n_humans=args.humans, n_steps=n_steps,
                                  multistart=ms, device=device)
        t0 = time.perf_counter()
        res = run(batch, seeds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0

    _, first = timed(1)
    res, steady = timed(args.steps)

    success = res.success.cpu().numpy()
    collided = res.collided.cpu().numpy()
    clearance = res.min_clearance.cpu().numpy()
    static_clear = res.min_static_clearance.cpu().numpy()
    fail_steps = res.solver_fail_steps.cpu().numpy()
    steps_used = res.steps_used.cpu().numpy()
    smooth = res.smoothness.cpu().numpy()
    dev_mean = res.deviation_mean.cpu().numpy()
    dev_max = res.deviation_max.cpu().numpy()
    overflow = res.escalation_overflow_steps.cpu().numpy()
    if fleet:                                 # per-robot flags
        collided = collided.any(axis=1)
        static_clear = static_clear.min(axis=1)
        fail_steps = fail_steps.sum(axis=1)
        smooth = smooth.mean(axis=1)
        dev_mean = dev_mean.mean(axis=1)
        dev_max = dev_max.max(axis=1)
        overflow = overflow.sum(axis=1)

    out = {
        "n_scenarios": args.n,
        "devices": 1,
        "robots": args.robots,
        "success_rate": float(success.mean()),
        "collision_rate": float(collided.mean()),
        "timeout_rate": float(1.0 - success.mean() - collided.mean()),
        "min_clearance_mean": float(clearance[np.isfinite(clearance)].mean())
        if np.isfinite(clearance).any() else None,
        "min_static_clearance_mean": float(
            static_clear[np.isfinite(static_clear)].mean())
        if np.isfinite(static_clear).any() else None,
        "solver_fail_steps_mean": float(fail_steps.mean()),
        "steps_used_mean": float(steps_used.mean()),
        # Reference eval-protocol metrics (main_base.py:483-506): action
        # smoothness [mean|d2v|, mean|d2w|] averaged over episodes, and
        # path-deviation mean/std (over per-episode means) + max (of maxes).
        "smoothness_mean": [float(x) for x in smooth.mean(axis=0)],
        "deviation_mean": float(dev_mean.mean()),
        "deviation_std": float(dev_mean.std()),
        "deviation_max": float(dev_max.max()) if len(dev_max) else None,
        "escalation_overflow_steps_mean": float(overflow.mean()),
        "wall_s_first": round(first, 2),
        "wall_s_steady": round(steady, 2),
        "control_steps_per_s": round(
            args.n * args.steps * args.robots / steady, 1),
    }
    if fleet:
        inter = res.min_inter_robot.cpu().numpy()
        out["min_inter_robot_mean"] = (float(inter[np.isfinite(inter)].mean())
                                       if np.isfinite(inter).any() else None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
