#!/usr/bin/env python3
"""Where a step of the PyTorch port's per-episode harness spends its time.

    python3 scripts/profile_torch_harness.py                    # cvmp, card
    python3 scripts/profile_torch_harness.py --predictor mmp
    python3 scripts/profile_torch_harness.py --tracker dwa --steps 5
    python3 scripts/profile_torch_harness.py --device cpu --steps 2

Prepares `MainBase(scenario_index=0, evaluation=True)` with the tracker
and the predictor as `python -m dyobav_tpu_torch.sim eval` does (the
shipped `SolverConfiguration()`, or the entry's strong cold budget for
mmp; the tracker's warm-up builds the kernel), runs the cold first step
unprofiled, then profiles each of the next `--steps` steps alone under
`torch.profiler`, tracing the device only (a step's host events, near a
million operators, take minutes to aggregate), and reports one JSON line
per step: its wall time, whether it escalated, the predictor's time, the
device's own time (kernels, memcpy, memset) and events, its idle share,
the SPD kernel's launches and share of the device time, the host syncs,
and the kernels that take the most device time.  With `--tracker dwa`
a step is one DWA grid search (no solve, no SPD kernel, no escalation).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracker", default="mpc", choices=["mpc", "dwa"])
    ap.add_argument("--predictor", default="cvmp",
                    choices=["cvmp", "kfmp", "mmp"])
    ap.add_argument("--steps", type=int, default=3,
                    help="profiled steps after the cold first one")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()

    import torch

    from chip_smoke import MMP_BUDGET, card_line
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim.harness import MainBase
    from profile_torch_solve import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = engine.resolve_device(args.device)
    cuda = dev.type == "cuda"
    scfg = SolverConfiguration(**(MMP_BUDGET if args.predictor == "mmp"
                                  else {}))
    base = MainBase(max_run_time_step=args.steps + 1, evaluation=True,
                    seed=0, scenario_index=0, solver_config=scfg, device=dev)
    robot, humans = base._prepare_agents()
    t0 = time.perf_counter()
    intf, pred = base._prepare_interfaces(robot, args.predictor,
                                          args.tracker)
    prepare_s = time.perf_counter() - t0
    tracker = intf.traj_tracker

    def step():
        t0 = time.perf_counter()
        base.run_one_step(robot, humans, intf, pred)
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    cold_s = step()
    card = card_line() if cuda else "cpu"
    for k in range(1, args.steps + 1):
        escalations = getattr(tracker, "escalation_count", 0)
        spd.spd_solve.launches = 0
        syncs = engine.to_host.syncs + engine.any_lane.syncs
        step_s, stats = profiled(step, cuda, args.top, host=False)
        device_s = stats["device_kernel_s"]
        print(json.dumps({
            "card": card, "tracker": args.tracker,
            "predictor": args.predictor, "step": k,
            "prepare_s": prepare_s, "cold_first_step_s": cold_s,
            "profiled_step_s": step_s,
            "escalated": getattr(tracker, "escalation_count", 0)
            > escalations,
            "predictor_s": base._last_predict_time,
            "status": (tracker.solver_status_timelist[-1]
                       if args.tracker == "mpc" else None),
            "device_idle_share": (1.0 - device_s / step_s) if cuda else None,
            "spd_launches": spd.spd_solve.launches,
            "host_syncs": engine.to_host.syncs + engine.any_lane.syncs
            - syncs,
            **stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
