#!/usr/bin/env python3
"""Where the PyTorch port's closed-loop batched simulation spends its time.

    python3 scripts/profile_torch_sim.py              # 256 scenarios, card
    python3 scripts/profile_torch_sim.py --device cpu --batch 4

Builds chip_smoke.py's simulation (`random_scenarios(base, B, seed=0)`,
shipped configurations, multistart on), runs it for 1 and for 3 control
steps without a profiler (each run starts with the cold pre-solve, so the
difference over 2 is a step's time and the rest the pre-solve's), then
runs 1 step once under `torch.profiler`, tracing the device only (the
host's events of such a run, millions of operators, do not fit in memory),
and reports, as one JSON line: the wall times, the summed time and the
number of the device's own events (kernels, memcpy, memset), the device's
idle share with and without the profiler, the SPD kernel's launches and
host syncs, and the kernels that take the most device time.
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
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim.batch import build_batch_sim
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import random_scenarios
    from profile_torch_solve import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = engine.resolve_device(args.device)
    cuda = dev.type == "cuda"
    base = MainBase(evaluation=True, seed=0)
    batch = random_scenarios(base, args.batch, seed=0, device=dev)
    seeds = np.arange(args.batch)

    def timed(n_steps):
        run = build_batch_sim(base.config_mpc, base.config_robot,
                              SolverConfiguration(), n_steps=n_steps,
                              multistart=True, device=dev)
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
    print(json.dumps({
        "card": card_line() if cuda else "cpu",
        "scenarios": args.batch,
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
        **stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
