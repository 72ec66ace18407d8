#!/usr/bin/env python3
"""Where the PyTorch port's batched NMPC solve spends its time.

    python3 scripts/profile_torch_solve.py            # B=2048 on the card
    python3 scripts/profile_torch_solve.py --method panoc --iters 30
    python3 scripts/profile_torch_solve.py --device cpu --batch 8

Poses chip_smoke.py's problem batch one warm receding-horizon step in,
times `solve_batch_escalated` and its warm stage `solve_batch` without a
profiler, then runs the warm stage once under `torch.profiler` and reports
the host wall time, the summed time of the device's own events (kernels,
memcpy, memset), the device's idle share (1 - that time / wall time, with
and without the profiler), the SPD kernel's share of that device time, the
number of kernel launches and the operators that take the most host and
device time, as one JSON line.  With `--method panoc` the bundle is PANOC
at a one-stage budget of `--iters` iterations, and the line adds the
warm stage's time and launches per iteration.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profiled(timed_fn, cuda: bool, n_top: int, host: bool = True,
             trace_path: str | None = None):
    """Run `timed_fn()` (which returns its own wall seconds, taken around a
    device synchronize) under `torch.profiler`; returns (those seconds,
    {device_kernel_s, spd_kernel_s, spd_share_of_device, device_events,
    kernel_launches, aten_calls, top_device_ms, top_host_ms}).  host=False
    traces the device only: the profiler keeps every event in memory, and
    a run of millions of operators does not fit with the host's events
    (the host-side counts and rows are then empty).  `trace_path` also
    writes the Chrome trace there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        seconds = timed_fn()
    if trace_path:
        prof.export_chrome_trace(trace_path)
    ev = prof.key_averages()
    # Device time is summed over the device's own events (kernels, memcpy,
    # memset) only: an operator's self device time is the time of the
    # kernels it launched, which appear again as events of their own.
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    # The port's SPD kernels (spd_cholesky_solve_kernel and
    # spd_lanes_solve_kernel).
    spd_us = sum(e.self_device_time_total for e in kernels if "spd_" in e.key)
    launches = sum(e.count for e in ev
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    aten_calls = sum(e.count for e in ev if e.key.startswith("aten::"))

    def top(events, attr):
        rows = sorted(events, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key[:60], e.count, round(getattr(e, attr) / 1e3, 3)]
                for e in rows[:n_top] if getattr(e, attr) > 0]

    return seconds, {
        "device_kernel_s": device_us / 1e6,
        "spd_kernel_s": spd_us / 1e6,
        "spd_share_of_device": spd_us / device_us if device_us else None,
        "device_events": sum(e.count for e in kernels),
        "kernel_launches": launches,
        "aten_calls": aten_calls,
        "top_device_ms": top(kernels, "self_device_time_total"),
        "top_host_ms": top(ev, "self_cpu_time_total"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--method", default="newton", choices=["newton", "panoc"])
    ap.add_argument("--iters", type=int, default=30,
                    help="PANOC: iterations of the one-stage warm budget")
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line, make_problems
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration,
                                          SolverConfiguration)
    from dyobav_tpu_torch.motion.models import unicycle_step
    from dyobav_tpu_torch.ops.engine import build_mpc_solver, resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = MpcConfiguration()
    scfg = (SolverConfiguration() if args.method == "newton" else
            SolverConfiguration(max_inner_iters=args.iters,
                                max_outer_iters=1))
    bundle = build_mpc_solver(cfg, CircularRobotSpecification(), scfg,
                              method=args.method, device=dev)
    make_Z, states, u_prev, U0 = make_problems(cfg, args.batch)
    sol = bundle.solve_batch_escalated(make_Z(states, u_prev, 0), U0)
    u = sol.u
    st = torch.func.vmap(lambda s, a: unicycle_step(s, a, cfg.ts))(
        torch.as_tensor(states, device=dev), u[:, :cfg.nu])
    Z = torch.as_tensor(make_Z(st.cpu().numpy(), u[:, :cfg.nu].cpu().numpy(),
                               1), device=dev)
    U0w = torch.cat([u[:, cfg.nu:], u[:, -cfg.nu:]], dim=1)

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn(Z, U0w)
        sync()
        return time.perf_counter() - t0, out

    esc_s, esc = wall(bundle.solve_batch_escalated)
    warm_s, _ = wall(bundle.solve_batch)

    prof_s, stats = profiled(lambda: wall(bundle.solve_batch)[0], cuda,
                             args.top)
    device_s = stats["device_kernel_s"]

    out = {
        "card": card_line() if cuda else "cpu",
        "method": args.method,
        "batch": args.batch,
        "exit_ok_escalated": float(esc.exit_ok.float().mean()),
        "escalated_s": esc_s,
        "warm_stage_s": warm_s,
        "profiled_warm_stage_s": prof_s,
        # Kernel time against the profiled and the unprofiled wall time:
        # the profiler slows the host, not the kernels.
        "device_idle_share": (1.0 - device_s / prof_s) if cuda else None,
        "device_idle_share_unprofiled": (1.0 - device_s / warm_s)
        if cuda else None,
        **stats,
    }
    if args.method == "panoc":
        out.update(iterations=args.iters,
                   warm_stage_s_per_iteration=warm_s / args.iters,
                   kernel_launches_per_iteration=stats["kernel_launches"]
                   / args.iters,
                   device_events_per_iteration=stats["device_events"]
                   / args.iters)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
