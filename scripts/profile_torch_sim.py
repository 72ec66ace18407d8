#!/usr/bin/env python3
"""Where the PyTorch port's closed-loop batched simulation spends its time.

    python3 scripts/profile_torch_sim.py              # 256 scenarios, card
    python3 scripts/profile_torch_sim.py --wta        # neural, 64 scenarios
    python3 scripts/profile_torch_sim.py --robots 4   # fleet, 32 x 4 robots
    python3 scripts/profile_torch_sim.py --device cpu --batch 4

Builds chip_smoke.py's simulation (`random_scenarios(base, B, seed=0)`,
shipped configurations, multistart on), runs it for 1 and for 3 control
steps without a profiler (each run starts with the cold pre-solve, so the
difference over 2 is a step's time and the rest the pre-solve's), then
runs 1 step once under `torch.profiler`, tracing the device only (the
host's events of such a run, millions of operators, do not fit in memory),
and reports, as one JSON line: the wall times, the summed time and the
number of the device's own events (kernels, memcpy, memset), the device's
idle share with and without the profiler, the SPD kernel's launches, its
share of the device time and the host syncs, and the kernels that take the
most device time.  `--wta` swaps the constant-velocity predictor for the
SWTA neural one (`make_wta_predictor`, trained net) and also profiles one
predictor call alone: its device time and its share of the one-step run's
(which calls it twice: the cold pre-solve and the step).  `--robots R > 1`
profiles the decentralized fleet instead (`random_fleet_scenarios(base, B,
n_robots=R, n_humans=1, seed=0)` -> `build_fleet_sim`), chip_smoke.py's
`build_fleet_sim` path: B x R solve lanes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="scenarios (default: 256, 64 with --wta, 32 "
                         "with --robots)")
    ap.add_argument("--wta", action="store_true",
                    help="drive the sim with the SWTA neural predictor")
    ap.add_argument("--robots", type=int, default=1,
                    help=">1 profiles the fleet sim with this many robots")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim.batch import build_batch_sim
    from dyobav_tpu_torch.sim.fleet import build_fleet_sim
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import (random_fleet_scenarios,
                                                random_scenarios)
    from profile_torch_solve import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = engine.resolve_device(args.device)
    cuda = dev.type == "cuda"
    fleet = args.robots > 1
    n = args.batch or (64 if args.wta else 32 if fleet else 256)
    base = MainBase(evaluation=True, seed=0)
    if fleet:
        batch = random_fleet_scenarios(base, n, n_robots=args.robots,
                                       n_humans=1, seed=0, device=dev)
    else:
        batch = random_scenarios(base, n, seed=0, device=dev)
    seeds = np.arange(n)
    predictor = None
    if args.wta:
        from chip_smoke import make_wta
        from dyobav_tpu_torch.models.wta_net import load_checkpoint

        predictor = make_wta(base, load_checkpoint(os.path.join(
            ROOT, "Model", "wsd_1t20_full_torch.pt"), dev), dev)

    def timed(n_steps):
        if fleet:
            run = build_fleet_sim(base.config_mpc, base.config_robot,
                                  SolverConfiguration(),
                                  n_robots=args.robots, n_steps=n_steps,
                                  multistart=True, predictor=predictor,
                                  device=dev)
        else:
            run = build_batch_sim(base.config_mpc, base.config_robot,
                                  SolverConfiguration(), n_steps=n_steps,
                                  multistart=True, predictor=predictor,
                                  device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(batch, seeds)
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    timed(1)                          # kernel build, library initialisation
    one_s, three_s = timed(1), timed(3)
    spd.spd_solve.launches = engine.any_lane.syncs = 0
    prof_s, stats = profiled(lambda: timed(1), cuda, args.top,
                             host=False)
    device_s = stats["device_kernel_s"]
    step_s = (three_s - one_s) / 2
    wta = {}
    if predictor is not None:
        hist = torch.as_tensor(batch.human_starts, dtype=torch.float32,
                               device=dev)[:, None].expand(-1, 5, -1, -1)

        def timed_predict():
            t0 = time.perf_counter()
            predictor(hist)
            if cuda:
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        timed_predict()
        pred_s, pstats = profiled(timed_predict, cuda, args.top, host=False)
        wta = {"predictor_call_s": pred_s,
               "predictor_device_s": pstats["device_kernel_s"],
               "predictor_share_of_device_one_step_run":
               2 * pstats["device_kernel_s"] / device_s if cuda else None,
               "predictor_top_device_ms": pstats["top_device_ms"]}
    print(json.dumps({
        "card": card_line() if cuda else "cpu",
        "predictor": "wta" if args.wta else "cv",
        "scenarios": n, "robots": args.robots,
        "one_step_run_s": one_s, "three_step_run_s": three_s,
        "step_s": step_s, "cold_presolve_s": one_s - step_s,
        "profiled_one_step_run_s": prof_s,
        # Kernel time against the profiled and the unprofiled wall time:
        # the profiler slows the host, not the kernels.
        "device_idle_share": (1.0 - device_s / prof_s) if cuda else None,
        "device_idle_share_unprofiled": (1.0 - device_s / one_s)
        if cuda else None,
        "spd_launches_one_step_run": spd.spd_solve.launches,
        "host_syncs_one_step_run": engine.any_lane.syncs,
        **stats, **wta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
