"""Time one step of the port's fleet on the CPU, and what share of it torch
spends in its Python reference kernels.

The head-on corridor of tests/test_fleet.py (2 lanes x 2 robots, its FAST
budget), `build_fleet_sim(..., device="cpu")`: a 1-step run and a 2-step run,
each with its cold pre-solve; one step is their difference.

    python scripts/fleet_step_cpu.py --threads 1
    python scripts/fleet_step_cpu.py --threads 1 --profile
    python scripts/fleet_step_cpu.py --threads 1 --reverse-mode

--profile runs the 1-step run under cProfile and prints the share of its
time inside `torch._refs` / `torch._prims` (forward-mode AD on a tensor with
no tangent goes there in some torch builds).  --reverse-mode swaps the block
Hessian's forward-mode derivatives (`hessian`, `jacfwd`) for reverse-mode
ones (`jacrev`) in this process only, to time what that costs; the numbers
then differ from the port's at rounding level.
"""
import argparse
import cProfile
import os
import pstats
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dyobav_tpu_torch import configs  # noqa: E402
from dyobav_tpu_torch.sim import fleet, scenarios  # noqa: E402

CFG, ROBOT = configs.MpcConfiguration(), configs.CircularRobotSpecification()
FAST = configs.SolverConfiguration(max_inner_iters=8, max_outer_iters=2,
                                   inner_iters_later=4,
                                   escalation_ladder=((4, 2, 2, 1, 10.0),),
                                   escalation_slots=(4,))


def reverse_mode():
    """Patch `ops.costs` and `ops.newton` to take reverse-mode derivatives."""
    from torch.func import jacrev

    from dyobav_tpu_torch.ops import costs, newton
    costs.hessian = lambda f: jacrev(jacrev(f))
    costs.jacfwd = jacrev
    newton.jacfwd = jacrev


def run(steps):
    sc = scenarios.synthetic_fleet_scenario(
        [[0.0, 0.2, 0.0], [8.0, -0.2, np.pi]], [[8.0, 0.2], [0.0, -0.2]],
        base_speed=ROBOT.lin_vel_max * 0.8, ts=CFG.ts)
    batch = fleet.FleetScenario(*[np.stack([x, x]) for x in sc])
    t = time.perf_counter()
    fleet.build_fleet_sim(CFG, ROBOT, FAST, n_robots=2, n_steps=steps,
                          device="cpu")(batch, np.arange(2))
    return time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--reverse-mode", action="store_true")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.reverse_mode:
        reverse_mode()
    if args.profile:
        prof = cProfile.Profile()
        prof.enable()
        one = run(1)
        prof.disable()
        stats = pstats.Stats(prof).stats
        refs = sum(v[2] for k, v in stats.items()
                   if "/torch/_refs/" in k[0] or "/torch/_prims" in k[0])
        print(f"threads {torch.get_num_threads()}: 1-step run {one:.1f} s "
              f"profiled, {refs:.1f} s ({refs / one:.0%}) in torch._refs / "
              f"torch._prims")
        return
    one, two = run(1), run(2)
    print(f"threads {torch.get_num_threads()}, reverse-mode "
          f"{args.reverse_mode}: 1-step run {one:.1f} s, 2-step run "
          f"{two:.1f} s, one step {two - one:.1f} s")


if __name__ == "__main__":
    main()
