"""Evaluation sweep over randomized warehouse scenarios, the port of
`dyobav_tpu.sim.sweep`.

The batched counterpart of `main_eva`: randomized (start, goal,
pedestrian-seed) episodes run as one batch, split over devices; the
statistics are printed as one JSON object with the JAX script's keys.

    python -m dyobav_tpu_torch.sim.sweep --n 256 --steps 60 [--devices N]
    python -m dyobav_tpu_torch.sim.sweep --robots 4 --n 32 --steps 60
    torchrun --nproc_per_node=N -m dyobav_tpu_torch.sim.sweep --distributed \
        --scenarios 256 --steps 60

It runs on the first CUDA device and raises without one; `--device cpu`
asks for the CPU, `--device cuda:k` for card k.  `--devices N` pads the
batch to a multiple of N, splits it into N shards
(`parallel.mesh.shard_batch`: the first N CUDA devices, or N shards of the
CPU with `--device cpu`) and runs them one after another in this process
(`shard_map_batch` says why), so N > 1 buys no speed: it shows that a split
batch gives the unsplit one's statistics, and cards run side by side only
under `--distributed`.  0, the JAX script's default (every device there),
means 1 here: one unsharded batch.  The statistics reduce over the first
`--n` lanes.  Lane b draws its pedestrian stagger from seed b of the
padded global batch, whichever shard holds it.  A shard sizes its cold and
escalation slots from its own lanes, as the JAX package's `shard_map_batch`
does (JAX's sweep gathers over the whole batch instead); the two agree
wherever no lane falls past its slots, and part only on
`escalation_overflow_steps`.

`--distributed` runs one process per device under a launcher that sets
`torch.distributed`'s environment (`parallel.mesh.init_distributed`;
without it the run falls back to one host, as the JAX script does).  Each
process runs its rows of the identical global batch on `cuda:LOCAL_RANK`
(or the CPU), the sums, counts and maxima reduce with `all_reduce`, and
process 0 prints the JAX script's multi-host keys, `"hosts"` counting the
processes.

`wall_s_first` is a one-step run that absorbs set-up (the kernel build,
CUDA library initialisation); `wall_s_steady` is the full run, which
`control_steps_per_s` is taken from (robots counted).  `--robots R > 1`
runs the decentralized fleet sim (`sim.fleet`), whose per-robot statistics
are reduced per scenario as the JAX script does.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def per_scenario(res, fleet: bool) -> dict:
    """The result's statistics per scenario as numpy arrays (the fleet's
    per-robot fields reduced per scenario, as the JAX script does)."""
    out = {k: getattr(res, k).cpu().numpy() for k in (
        "success", "collided", "min_clearance", "min_static_clearance",
        "solver_fail_steps", "steps_used", "smoothness", "deviation_mean",
        "deviation_max", "escalation_overflow_steps")}
    if fleet:
        out["collided"] = out["collided"].any(axis=1)
        out["min_static_clearance"] = out["min_static_clearance"].min(axis=1)
        out["solver_fail_steps"] = out["solver_fail_steps"].sum(axis=1)
        out["smoothness"] = out["smoothness"].mean(axis=1)
        out["deviation_mean"] = out["deviation_mean"].mean(axis=1)
        out["deviation_max"] = out["deviation_max"].max(axis=1)
        out["escalation_overflow_steps"] = \
            out["escalation_overflow_steps"].sum(axis=1)
        out["min_inter_robot"] = res.min_inter_robot.cpu().numpy()
    return out


def reduce_global(stats: dict, valid: np.ndarray, true_n: int, device,
                  times) -> dict:
    """The JAX script's `reduce_global` over the processes: each sums,
    counts and takes maxima over its valid rows, then one `all_reduce` of
    the sums and one of the maxima (the run times included).  The fleet's
    per-robot clearances take the row mask along their robot axis (the JAX
    function's mask does not broadcast there)."""
    import torch
    import torch.distributed as dist

    # The fleet's clearances are per robot, (rows, R).
    finite = np.isfinite(stats["min_clearance"]) & (
        valid[:, None] if stats["min_clearance"].ndim > 1 else valid)
    finite_s = np.isfinite(stats["min_static_clearance"]) & valid
    sums = torch.tensor(np.concatenate([[
        stats["success"][valid].sum(), stats["collided"][valid].sum(),
        stats["min_clearance"][finite].astype(np.float64).sum(),
        finite.sum(),
        stats["min_static_clearance"][finite_s].astype(np.float64).sum(),
        finite_s.sum(), stats["solver_fail_steps"][valid].sum(),
        stats["steps_used"][valid].sum(),
        stats["deviation_mean"][valid].astype(np.float64).sum(),
        valid.sum()], stats["smoothness"][valid].astype(np.float64).sum(0)]),
        dtype=torch.float64, device=device)
    maxima = torch.tensor(
        [float(np.max(np.where(valid, stats["deviation_max"], 0.0),
                      initial=0.0)), *times],
        dtype=torch.float64, device=device)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX)
    (succ, coll, clear, n_clear, sclear, n_sclear, fails, steps, dev,
     nv, *smooth) = sums.cpu().tolist()
    dev_max, first, steady = maxima.cpu().tolist()
    nv = max(nv, 1.0)
    return {
        "success_rate": succ / true_n,
        "collision_rate": coll / true_n,
        "timeout_rate": 1.0 - succ / true_n - coll / true_n,
        "min_clearance_mean": clear / max(n_clear, 1.0),
        "min_static_clearance_mean": sclear / max(n_sclear, 1.0),
        "solver_fail_steps_mean": fails / true_n,
        "steps_used_mean": steps / true_n,
        "smoothness_mean": [x / nv for x in smooth],
        "deviation_mean": dev / nv,
        "deviation_max": dev_max,
        "wall_s_first": first,
        "wall_s_steady": steady,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    # `--scenarios` spells `--n` where a launcher's parser would read `--n`
    # as an ambiguous abbreviation of its own options (torchrun does).
    ap.add_argument("--n", "--scenarios", type=int, default=64,
                    help="number of scenarios")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--humans", type=int, default=1)
    ap.add_argument("--robots", type=int, default=1,
                    help=">1 switches to the decentralized fleet sim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="shards, run one after another in this process "
                         "(0 or 1: one unsharded batch; cards side by side "
                         "need --distributed)")
    ap.add_argument("--distributed", action="store_true",
                    help="one process per device under torch.distributed's "
                         "launcher environment (torchrun); without it, one "
                         "host")
    ap.add_argument("--device", default=None,
                    help="'cpu' (N shards of the CPU with --devices N) or "
                         "one card, cuda:k (default: the first CUDA "
                         "device, or the first --devices N of them)")
    ap.add_argument("--inner-iters", type=int, default=None,
                    help="custom solver budget (default: the production "
                         "SolverConfiguration() profile)")
    ap.add_argument("--outer-iters", type=int, default=None)
    ap.add_argument("--no-multistart", action="store_true",
                    help="opt out of the tracker's 5-candidate multistart "
                         "decision rule (budget-only escalation of the "
                         "warm guess; ~5x cheaper, weaker basin recovery)")
    args = ap.parse_args(argv)
    if args.devices < 0:
        ap.exit(2, f"--devices {args.devices}: must be 0 or more\n")

    import torch
    import torch.distributed as dist

    from ..configs import SolverConfiguration
    from ..ops.engine import resolve_device
    from ..parallel.mesh import (init_distributed, make_global_batch,
                                 make_mesh, pad_to_multiple, shard_batch,
                                 shard_map_batch)
    from .batch import Scenario, build_batch_sim
    from .fleet import FleetScenario, build_fleet_sim
    from .harness import MainBase
    from .scenarios import random_fleet_scenarios, random_scenarios

    n_shards = max(args.devices, 1)
    named = None if args.device is None else torch.device(args.device)
    card = named is not None and named.type == "cuda" \
        and named.index is not None
    if args.distributed and (n_shards > 1 or card):
        ap.exit(2, "--distributed runs one device a process, cuda:LOCAL_RANK "
                   "or the CPU: leave out --devices and the card index\n")
    if card and n_shards > 1:
        ap.exit(2, f"--device {args.device} names one card and --devices "
                   f"{args.devices} asks for shards: give one of them\n")
    distributed, owned = False, False
    if args.distributed:
        local = (named if named is not None and named.type != "cuda"
                 else torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                              0))))
        if local.type == "cuda":
            resolve_device(None)          # raises without a CUDA device
        owned = not dist.is_initialized()
        distributed = init_distributed(local)
    if distributed:
        mesh = [local]
        n_dev = dist.get_world_size()
    else:
        # One list of devices: the CUDA devices unless a device is named.
        devices = (None if named is None or (named.type == "cuda"
                                             and not card)
                   else [named] * n_shards)
        try:
            mesh = make_mesh(n_shards, devices)
        except ValueError as exc:
            ap.exit(2, f"--devices {args.devices}: {exc}\n")
        n_dev = len(mesh)

    base = MainBase(max_run_time_step=args.steps, evaluation=True,
                    seed=args.seed)
    fleet = args.robots > 1
    if fleet:
        batch = random_fleet_scenarios(base, args.n, n_robots=args.robots,
                                       n_humans=args.humans, seed=args.seed)
    else:
        batch = random_scenarios(base, args.n, n_humans=args.humans,
                                 seed=args.seed)
    cls = FleetScenario if fleet else Scenario
    padded = cls(*[pad_to_multiple(np.asarray(x), n_dev)[0] for x in batch])
    true_n = args.n
    # Lane b's pedestrian stagger comes from seeds[b] of the global batch.
    seeds = np.arange(padded[0].shape[0])
    split = make_global_batch if distributed else shard_batch
    shards, seed_shards = split(mesh, padded), split(mesh, seeds)

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

    def timed(n_steps):
        ms = not args.no_multistart
        runs = {}
        for d in dict.fromkeys(mesh):
            if fleet:
                runs[d] = build_fleet_sim(
                    base.config_mpc, base.config_robot, scfg,
                    n_robots=args.robots, n_steps=n_steps, multistart=ms,
                    device=d)
            else:
                runs[d] = build_batch_sim(
                    base.config_mpc, base.config_robot, scfg,
                    n_humans=args.humans, n_steps=n_steps, multistart=ms,
                    device=d)
        run = shard_map_batch(lambda sc, s: runs[sc[0].device](sc, s), mesh)
        t0 = time.perf_counter()
        res = run(shards, seed_shards)
        for d in dict.fromkeys(mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return res, time.perf_counter() - t0

    _, first = timed(1)
    res, steady = timed(args.steps)
    stats = per_scenario(res, fleet)

    if distributed:
        rank = dist.get_rank()
        rows = len(stats["success"])
        valid = rank * rows + np.arange(rows) < true_n
        red = reduce_global(stats, valid, true_n, mesh[0], (first, steady))
        out = {"n_scenarios": true_n, "devices": n_dev, "hosts": n_dev,
               "robots": args.robots, **red}
        out["wall_s_first"] = round(out["wall_s_first"], 2)
        out["wall_s_steady"] = round(out["wall_s_steady"], 2)
        out["control_steps_per_s"] = round(
            true_n * args.steps * args.robots / out["wall_s_steady"], 1)
        if rank == 0:
            print(json.dumps(out))
        if owned:
            dist.destroy_process_group()
        return 0

    stats = {k: v[:true_n] for k, v in stats.items()}
    success, collided = stats["success"], stats["collided"]
    clearance = stats["min_clearance"]
    static_clear = stats["min_static_clearance"]
    dev_mean, dev_max = stats["deviation_mean"], stats["deviation_max"]
    out = {
        "n_scenarios": true_n,
        "devices": n_dev,
        "robots": args.robots,
        "success_rate": float(success.mean()),
        "collision_rate": float(collided.mean()),
        "timeout_rate": float(1.0 - success.mean() - collided.mean()),
        "min_clearance_mean": float(clearance[np.isfinite(clearance)].mean())
        if np.isfinite(clearance).any() else None,
        "min_static_clearance_mean": float(
            static_clear[np.isfinite(static_clear)].mean())
        if np.isfinite(static_clear).any() else None,
        "solver_fail_steps_mean": float(stats["solver_fail_steps"].mean()),
        "steps_used_mean": float(stats["steps_used"].mean()),
        # Reference eval-protocol metrics (main_base.py:483-506): action
        # smoothness [mean|d2v|, mean|d2w|] averaged over episodes, and
        # path-deviation mean/std (over per-episode means) + max (of maxes).
        "smoothness_mean": [float(x) for x in stats["smoothness"].mean(0)],
        "deviation_mean": float(dev_mean.mean()),
        "deviation_std": float(dev_mean.std()),
        "deviation_max": float(dev_max.max()) if len(dev_max) else None,
        "escalation_overflow_steps_mean": float(
            stats["escalation_overflow_steps"].mean()),
        "wall_s_first": round(first, 2),
        "wall_s_steady": round(steady, 2),
        "control_steps_per_s": round(
            true_n * args.steps * args.robots / steady, 1),
    }
    if fleet:
        inter = stats["min_inter_robot"]
        out["min_inter_robot_mean"] = (float(inter[np.isfinite(inter)].mean())
                                       if np.isfinite(inter).any() else None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
