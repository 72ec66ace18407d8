#!/usr/bin/env python3
"""Deployment-node tick latency of the PyTorch port on its fused path.

Drives `sim.deploy.NavigationNode` in fused mode on a `LocalTransport`:
each tick is the whole neural control step of `sim.batch.build_step_program`
(the SWTA CNN over 20 offsets, the on-device cluster-Gaussian fit, the
constraint assembly and the 5-candidate multistart NMPC solve with its
cold re-solve on distress), behind the node's one device-to-host copy,
against the reference's 0.2 s control period (config/mpc_default.yaml
`ts`).  The net is strictly loaded from `Model/wsd_1t20_full_torch.pt`.
The world drifts between ticks: the pedestrian moves by uniform(-0.1, 0.1)
+ [0, 0.15] m a tick (numpy `default_rng(0)`), and the robot follows the
commanded action with the unicycle model.  One untimed tick (the episode's
cold start) precedes the `--n` timed ones.

    python scripts/deploy_latency_torch.py --n 20
    python scripts/deploy_latency_torch.py --n 20 --trace chiprun_out/deploy
    python scripts/deploy_latency_torch.py --n 2 --device cpu

Prints one JSON line; `--trace DIR` also profiles 5 more ticks with
`torch.profiler` and writes the Chrome trace to DIR/deploy_ticks.json and
its summary (device time, idle share, top kernels) to standard error.  On
a card it traces the device's events only; on the CPU it traces the
host's, whose aggregation takes minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def card_line():
    """`nvidia-smi`'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20, help="timed ticks")
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--trace", default="",
                    help="directory for a torch.profiler trace of 5 ticks")
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "Model", "wsd_1t20_full_torch.pt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.models.wta_net import load_checkpoint
    from dyobav_tpu_torch.motion.models import unicycle_step_np
    from dyobav_tpu_torch.ops.engine import resolve_device
    from dyobav_tpu_torch.predictors.mmp import ObstacleSnapper
    from dyobav_tpu_torch.sim.batch import (build_step_program,
                                            make_wta_predictor)
    from dyobav_tpu_torch.sim.deploy import LocalTransport, NavigationNode
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import build_scenario

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    base = MainBase(max_run_time_step=3, evaluation=True, seed=0,
                    device=device)
    sc = build_scenario(base, scenario_index=0)
    net = load_checkpoint(args.ckpt, device)
    pred = make_wta_predictor(
        net, base.ref_map, base.ct2real, base.config_mpc.N_hor,
        snap_tables=ObstacleSnapper(255.0 - base.ref_map).tables(),
        scale2nn=base.sim_config.scale2nn, device=device)
    fused = build_step_program(base.config_mpc, base.config_robot,
                               SolverConfiguration(), predictor=pred,
                               device=device)
    transport = LocalTransport()
    node = NavigationNode(transport, fused_step=fused, scenario=sc,
                          n_humans=int(sc.human_starts.shape[0]),
                          device=device)

    # Feed live messages the way a ROS adapter would.
    state = np.asarray(sc.robot_start, float)
    humans = np.asarray(sc.human_starts, float)

    def feed():
        transport.publish("actor_poses", {
            "poses": {f"a{i}": (p[0], p[1]) for i, p in enumerate(humans)}})
        transport.publish("robot_pose", {"x": state[0], "y": state[1],
                                         "theta": state[2]})

    feed()
    a = node.control_tick()            # the cold start and the first step
    if a is None or not np.all(np.isfinite(a)):
        raise AssertionError(f"first tick gave {a}")
    rng = np.random.default_rng(0)
    lat = []
    for _ in range(args.n):
        humans = humans + rng.uniform(-0.1, 0.1, humans.shape) + [0.0, 0.15]
        feed()
        t0 = time.perf_counter()
        a = node.control_tick()        # ends with its one host copy
        lat.append(time.perf_counter() - t0)
        state = unicycle_step_np(state, np.asarray(a, float), 0.2)

    if args.trace:
        from profile_torch_solve import profiled

        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "deploy_ticks.json")

        def five_ticks():
            t0 = time.perf_counter()
            for _ in range(5):
                node.control_tick()
            return time.perf_counter() - t0

        seconds, prof = profiled(five_ticks, cuda, n_top=10, host=not cuda,
                                 trace_path=path)
        prof["wall_s_per_tick"] = seconds / 5
        if cuda:
            prof["device_idle_share"] = 1.0 - prof["device_kernel_s"] / seconds
        print(json.dumps(prof), file=sys.stderr)
        print(f"profiler trace written to {path}", file=sys.stderr)

    lat_ms = np.sort(np.array(lat)) * 1e3
    p95 = float(np.percentile(lat_ms, 95))
    result = {
        "metric": "deploy_tick_latency_p95",
        "value": p95,
        "unit": "ms",
        "vs_baseline": 200.0 / p95,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "mean_ms": float(lat_ms.mean()),
        "n": args.n,
        "path": "NavigationNode fused_step (build_step_program)",
        "ckpt": os.path.basename(args.ckpt),
        "platform": device.type,
        "card": card_line() if cuda else None,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
