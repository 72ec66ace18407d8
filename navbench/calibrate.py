#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on several seeds at once.

    python3 navbench/calibrate.py --workload <name> --seeds 11 12 13 \
        --seconds 20 [--control] [--faults unchanged half altered] \
        [--device cpu] [--traffic '{"batch": 8}']

For each seed: the cell's set-up and a window of `--seconds`, then the
reference's readings of the program's outputs; with `--control` the same
readings of the control (the reference in the next precision down, in the
program's place); with `--faults` those of the program with each fault of
`faults.py` planted under its timed path.  One JSON line a reading.  Not
run by the benchmark's runs; `--device cpu` with a small `--traffic`
rehearses a cell here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="{}",
                    help="JSON object of traffic parameters to override")
    args = ap.parse_args()

    import torch

    from navbench import faults, harness

    spec = harness.cell(args.workload)
    traffic = dict(spec["traffic"], **json.loads(args.traffic))
    driver = harness.load_module("drivers", traffic["driver"])
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(4)
    training = traffic["driver"] == "swta_train"

    def emit(seed, side, cell, t0):
        r = cell.judge(control=side == "control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, "seconds": time.perf_counter() - t0,
                          **r}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = driver.Cell(spec["config"], traffic, seed, device)
        cell.window(args.seconds)
        cell.release()
        emit(seed, "program", cell, t0)
        if args.control:
            emit(seed, "control", cell, time.perf_counter())
        for fault in args.faults:
            t0 = time.perf_counter()
            if training:
                with faults.training(fault):
                    bad = driver.Cell(spec["config"], traffic, seed, device)
                    bad.window(min(args.seconds, 1.0))
            else:
                bad = driver.Cell(spec["config"], traffic, seed, device)
                faults.plant(bad, fault)
                bad.window(min(args.seconds, 1.0))
            bad.release()
            emit(seed, "fault:" + fault, bad, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
