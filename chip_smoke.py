#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dyobav_tpu_torch/csrc/`, holds each
kernel against its plain PyTorch version at the shapes the paths below give
it, then drives the port's paths through the entry points a user calls,
with the kernels' launch counts set to 0 just before each path and read
just after:

1. `build_mpc_solver(MpcConfiguration(), CircularRobotSpecification(),
   SolverConfiguration()).solve_batch_escalated` over B=2048
   receding-horizon problems (the problem generator of `bench.py`: seed 0,
   straight references, one lateral ellipse): once cold, one warm step, one
   timed solve;
2. the closed-loop batched simulation: `MainBase` -> `random_scenarios(base,
   256, seed=0)` -> `build_batch_sim(..., n_steps=SIM_STEPS,
   multistart=True)`, run once, and the same sim at 8 scenarios against the
   port's own CPU run;
3. `batched_spd_solve(A, b, force_kernel=True)`, the entry point of the
   second kernel, on 8192 systems.

Each phase prints a line; the line before the last is the kernel table as
JSON and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises and the script exits non-zero without that line.
It needs a CUDA device and the repository beside it; it imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense, no sparsity) used for the kernels' lower bounds: device-memory
# bytes/s and fp32 flop/s outside the tensor cores.
PEAKS = (3.35e12, 67e12)

BATCH = 2048        # receding-horizon problems, as bench.py
WARM_STEPS = 1      # warm steps before the timed solve (bench.py takes 3)
ITERS = 1           # timed escalated solves
REF_BATCH = 16      # problems of the card-vs-CPU reference check
SIM_BATCH = 256     # scenarios of the closed-loop simulation
SIM_STEPS = 10      # control steps of it (depth; an episode is 120)
SIM_REF_BATCH = 8   # scenarios of the sim's card-vs-CPU check
SIM_REF_STEPS = 3   # control steps of it
LANES_BATCH = 8192  # systems of the second kernel's entry-point call


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_problems(cfg, batch: int, seed: int = 0):
    """bench.py's scenario batch: returns make_Z(states, u_prev, k) -> (B,
    n_params) float32 numpy and the step-0 states / u_prev / U0."""
    from dyobav_tpu_torch.ops.params import empty_params, pack, tuning_vector
    import torch

    rng = np.random.default_rng(seed)
    N = cfg.N_hor
    x0s = rng.uniform(-5, 5, batch)
    y0s = rng.uniform(-5, 5, batch)
    headings = rng.uniform(-np.pi, np.pi, batch)
    coss, sins = np.cos(headings), np.sin(headings)
    obs_xy = np.stack([x0s + coss * 2.2 - sins * 0.3,
                       y0s + sins * 2.2 + coss * 0.3], axis=1)
    base = empty_params(cfg)

    def make_Z(states: np.ndarray, u_prev: np.ndarray, k: int) -> np.ndarray:
        steps = np.arange(k + 1, k + N + 1)
        ref = np.zeros((batch, N, 3), np.float32)
        ref[:, :, 0] = x0s[:, None] + coss[:, None] * 0.24 * steps
        ref[:, :, 1] = y0s[:, None] + sins[:, None] * 0.24 * steps
        ref[:, :, 2] = headings[:, None]
        ell = np.zeros((batch, cfg.Ndynobs, N + 1, cfg.ndynobs), np.float32)
        ell[:, 0, :, 0] = obs_xy[:, None, 0]
        ell[:, 0, :, 1] = obs_xy[:, None, 1]
        ell[:, 0, :, 2:] = [0.4, 0.4, 0.0, 1.0]

        def lanes(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)

        def tile(t):
            return t.expand((batch,) + tuple(t.shape))

        p = base._replace(
            u_prev=lanes(u_prev), s0=lanes(states), sN=lanes(ref[:, -1]),
            q=tile(torch.as_tensor(tuning_vector(cfg), dtype=torch.float32)),
            ref_states=lanes(ref),
            ref_speed=tile(torch.full((N,), 1.2)),
            others0=tile(base.others0), others_pred=tile(base.others_pred),
            stc_obs=tile(base.stc_obs), dyn_obs=lanes(ell),
            q_stc=tile(torch.full((N,), 10.0)),
            q_dyn=tile(torch.full((N,), 10.0)))
        return pack(p).numpy()

    states = np.stack([x0s, y0s, headings], axis=1).astype(np.float32)
    u_prev = np.tile(np.array([1.2, 0.0], np.float32), (batch, 1))
    U0 = np.tile(np.tile(np.array([1.2, 0.0], np.float32), N), (batch, 1))
    return make_Z, states, u_prev, U0


def spd_inputs(lead, n, n_indef, device, seed=0):
    """SPD systems (M Mᵀ/n + I) with the first `n_indef` of the flattened
    batch replaced by symmetric indefinite ones."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    B = int(np.prod(lead))
    M = torch.randn(B, n, n, generator=gen, device=device)
    A = M @ M.transpose(1, 2) / n + torch.eye(n, device=device)
    S = torch.randn(n_indef, n, n, generator=gen, device=device)
    A[:n_indef] = S + S.transpose(1, 2)
    g = torch.randn(B, n, generator=gen, device=device)
    return A.reshape(*lead, n, n), g.reshape(*lead, n)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd_bound_ms(batch: int, n: int, peaks) -> tuple[float, str]:
    """Least time for `batch` solves of n x n f32 systems, the larger of
    two: the bytes that must move -- the lower triangle of each row-major
    A (all that the factorization and both substitutions read), counted
    in the 32-byte sectors that hold it, plus g read and d written once --
    at the memory rate, and the factorization's and substitutions' flops
    at the fp32 CUDA-core rate."""
    rows = np.arange(batch * n, dtype=np.int64)    # row (b, i) is b * n + i
    start = rows * n * 4                           # its first byte in A
    end = start + (rows % n + 1) * 4               # one past its diagonal
    sectors = int(((end - 1) // 32 - start // 32 + 1).sum())
    bytes_moved = 32.0 * sectors + 2 * 4.0 * batch * n
    update_pairs = sum((m * (m + 1)) // 2 for m in range(n))
    flops = batch * (2 * update_pairs          # trailing updates
                     + n * (n + 1) // 2 + n    # column scaling + rsqrt
                     + 2 * n * (n - 1) + 2 * n)  # substitutions
    t_bytes, t_ops = bytes_moved / peaks[0], flops / peaks[1]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, source, replaces, kernel, plain, shapes, device,
                 peaks):
    """One SPD kernel against its plain version at each shape (leading
    dims of 40x40 systems, 1/64 of them indefinite); returns the kernel
    table entry: the first shape's numbers at the top level, the others'
    under `other_shapes`."""
    import torch

    n = 40
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": None}
    rows = []
    for lead in shapes:
        B = int(np.prod(lead))
        n_indef = max(B // 64, 1)
        A, g = spd_inputs(lead, n, n_indef, device)
        d = kernel(A, g)
        torch.cuda.synchronize()
        ref = plain(A, g)
        torch.cuda.synchronize()
        d2, r2 = d.reshape(B, n), ref.reshape(B, n)
        # Indefinite systems: a clamped pivot gives non-finite or huge
        # values; the kernel must give the plain version's, entry for entry.
        if not torch.equal(torch.isfinite(d2), torch.isfinite(r2)):
            raise AssertionError(f"{name} {lead}: finiteness differs from "
                                 "the plain version")
        fin = torch.isfinite(r2).all(-1)
        if not bool(fin[n_indef:].all()):
            raise AssertionError(f"{name} {lead}: an SPD system came out "
                                 "non-finite")
        clamped = fin[:n_indef]
        if bool(clamped.any()):
            a, b = d2[:n_indef][clamped], r2[:n_indef][clamped]
            if not float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()
                         ) <= 1e-3:
                raise AssertionError(f"{name} {lead}: clamped systems differ")
        # Tolerance on the definite systems: the same algorithm in the same
        # order without FMA contraction; only rsqrt / sqrt / division may
        # round differently, so the solutions (of scale 1) agree to 1e-5
        # absolute and 1e-4 of their scale.
        err = float((d2[n_indef:] - r2[n_indef:]).abs().max())
        rel = err / float(r2[n_indef:].abs().max())
        if not (err <= 1e-5 and rel <= 1e-4):
            raise AssertionError(f"{name} {lead}: max abs err {err}, "
                                 f"rel {rel}")
        ms = cuda_ms(lambda: kernel(A, g), 20)
        plain_ms = cuda_ms(lambda: plain(A, g), 2)
        # Yardstick only (the port's kernels never call it): the library's
        # batched Cholesky factor and solve on the same inputs.
        library_ms = cuda_ms(lambda: torch.cholesky_solve(
            g[..., None], torch.linalg.cholesky_ex(A)[0])[..., 0], 5)
        bound, bound_by = spd_bound_ms(B, n, peaks)
        print(f"kernel {name} {tuple(lead) + (n, n)}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"non-finite (indefinite) systems={int((~fin).sum())}/"
              f"{n_indef} ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} "
              f"({bound_by})", flush=True)
        rows.append({
            "shape": list(lead) + [n, n], "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms})
    entry.update(rows[0], other_shapes=rows[1:])
    return entry


def reference_check(cfg, robot, scfg, make_Z, states, u_prev, U0, n_ref):
    """The card's answers against the port's own CPU run (plain SPD
    version) on the first n_ref problems of the batch."""
    import torch

    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    Z = make_Z(states, u_prev, 0)[:n_ref]
    gpu = build_mpc_solver(cfg, robot, scfg).solve_batch_escalated(
        Z, U0[:n_ref])
    cpu = build_mpc_solver(cfg, robot, scfg, device="cpu"
                           ).solve_batch_escalated(Z, U0[:n_ref])
    torch.cuda.synchronize()
    eg, ec = gpu.exit_ok.cpu().numpy(), cpu.exit_ok.numpy()
    both = eg & ec
    du = np.abs(gpu.u.cpu().numpy()[:, :cfg.nu]
                - cpu.u.numpy()[:, :cfg.nu]).max(axis=1)
    n_far = int((du[both] > 1e-3).sum())
    print(f"reference check (B={n_ref}, card vs the port on the CPU): "
          f"exit_ok {eg.mean():.4f} vs {ec.mean():.4f}, disagree on "
          f"{int((eg != ec).sum())} lanes; first-action deviation on "
          f"{int(both.sum())} lanes both converge: max {du[both].max():.3e}, "
          f"> 1e-3 on {n_far}", flush=True)
    # The plain and kernel SPD solves round differently, and lanes near a
    # kink of the cost may settle one LM rung apart: allow a quarter of
    # the lanes to differ, no more.
    if abs(eg.mean() - ec.mean()) > 0.25 or n_far > max(n_ref // 4, 1):
        raise AssertionError("card and CPU runs of the port disagree")


def reset_counts():
    from dyobav_tpu_torch.ops import engine, spd, spd_lanes

    spd.spd_solve.launches = 0
    spd_lanes.batched_spd_solve.launches = 0
    engine.any_lane.syncs = 0


def drive_solve_path(cfg, robot, scfg, device):
    """Path 1: the escalated NMPC solve at B=2048.  Returns kernel 1's
    launches on it."""
    import torch

    from dyobav_tpu_torch.motion.models import unicycle_step
    from dyobav_tpu_torch.ops import spd
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    B = BATCH
    make_Z, states, u_prev, U0 = make_problems(cfg, B)

    # The card against the port's CPU run on a small batch (launches made
    # here are not the path's: the counts are reset after it).
    reference_check(cfg, robot, scfg, make_Z, states, u_prev, U0, REF_BATCH)

    bundle = build_mpc_solver(cfg, robot, scfg)
    step = torch.func.vmap(lambda s, u: unicycle_step(s, u, cfg.ts))
    reset_counts()
    Z = make_Z(states, u_prev, 0)
    t0 = time.perf_counter()
    sol = bundle.solve_batch_escalated(Z, U0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    exit_ok_cold = float(sol.exit_ok.float().mean())
    infeas_cold = float(np.percentile(sol.infeasibility.cpu().numpy(), 95))
    print(f"cold solve B={B}: {cold_s:.2f} s, exit_ok_cold={exit_ok_cold:.4f}"
          f" infeas_p95={infeas_cold:.3e} launches="
          f"{spd.spd_solve.launches}", flush=True)
    st = torch.as_tensor(states, device=device)
    for k in range(WARM_STEPS):
        u = sol.u
        st = step(st, u[:, :cfg.nu])
        u_prev_k = u[:, :cfg.nu].cpu().numpy()
        U0_k = torch.cat([u[:, cfg.nu:], u[:, -cfg.nu:]], dim=1)
        Z = make_Z(st.cpu().numpy(), u_prev_k, k + 1)
        t0 = time.perf_counter()
        sol = bundle.solve_batch_escalated(Z, U0_k)
        torch.cuda.synchronize()
        print(f"warm step {k + 1}: {time.perf_counter() - t0:.2f} s, "
              f"exit_ok={float(sol.exit_ok.float().mean()):.4f}", flush=True)
    exit_ok = float(sol.exit_ok.float().mean())
    infeas_p95 = float(np.percentile(sol.infeasibility.cpu().numpy(), 95))
    Z_dev = torch.as_tensor(Z, device=device)
    launches_before = spd.spd_solve.launches
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = bundle.solve_batch_escalated(Z_dev, U0_k)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = spd.spd_solve.launches
    timed_launches = launches - launches_before
    print(json.dumps({
        "main_path": "solve_batch_escalated", "batch": B,
        "warm_steps": WARM_STEPS, "exit_ok": exit_ok,
        "exit_ok_cold": exit_ok_cold, "infeas_p95": infeas_p95,
        "solves_per_s": B * ITERS / elapsed, "timed_solves": ITERS,
        "s_per_escalated_solve": elapsed / ITERS,
        "spd_launches_timed": timed_launches,
        "spd_launches_main_path": launches}), flush=True)

    for name, val in (("u", out.u), ("cost", out.cost),
                      ("pred_states", out.pred_states)):
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"solve path: non-finite {name}")
    if tuple(out.u.shape) != (B, cfg.nu * cfg.N_hor) or tuple(
            out.pred_states.shape) != (B, cfg.N_hor, cfg.ns):
        raise AssertionError(f"solve path: shapes {tuple(out.u.shape)}, "
                             f"{tuple(out.pred_states.shape)}")
    if launches <= 0 or timed_launches <= 0:
        raise AssertionError("solve path never launched spd_cholesky")
    if not exit_ok >= 0.5:
        raise AssertionError(f"solve path: exit_ok {exit_ok} below 0.5")
    return launches


def drive_sim_path(cfg, robot, scfg):
    """Path 2: the closed-loop batched simulation at SIM_BATCH scenarios.
    Returns kernel 1's launches on it."""
    import torch

    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim.batch import BatchResult, build_batch_sim
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import random_scenarios

    B, T = SIM_BATCH, SIM_STEPS
    base = MainBase(max_run_time_step=T, evaluation=True, seed=0)
    n_obs = len(base.geo_map.processed_obstacle_list)
    batch = random_scenarios(base, B, seed=0)
    run = build_batch_sim(cfg, robot, scfg, n_steps=T, multistart=True)
    reset_counts()
    t0 = time.perf_counter()
    res = run(batch, np.arange(B))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches, syncs = spd.spd_solve.launches, engine.any_lane.syncs

    r = {f: getattr(res, f).cpu().numpy() for f in BatchResult._fields}
    start, goal = batch.robot_start[:, :2], batch.goal[:, :2]
    d_start = np.linalg.norm(start - goal, axis=1)
    d_final = np.linalg.norm(r["final_state"][:, :2] - goal, axis=1)
    # A random route may start by leading away from its last node: hold a
    # lane to the goal only where its reference trajectory itself is 0.3 m
    # nearer the goal after T steps.
    d_ref = np.linalg.norm(batch.ref_traj[:, T - 1, :2] - goal, axis=1)
    approaching = ~r["success"] & (d_ref < d_start - 0.3)
    nearer = (d_final < d_start - 0.3)[approaching]
    fail_per_step = float(r["solver_fail_steps"].mean()) / T
    print(json.dumps({
        "main_path": "build_batch_sim", "scenarios": B, "steps": T,
        "obstacles": n_obs, "sim_s": sim_s, "s_per_step": sim_s / T,
        "control_steps_per_s": B * T / sim_s,
        "solver_fail_steps_mean": float(r["solver_fail_steps"].mean()),
        "escalation_overflow_steps_mean": float(
            r["escalation_overflow_steps"].mean()),
        "spd_launches_per_step": launches / T, "spd_launches": launches,
        "host_syncs_per_step": syncs / T,
        "collided": int(r["collided"].sum()),
        "collided_static": int(r["collided_static"].sum()),
        "success": int(r["success"].sum()),
        "lanes_route_approaches_goal": int(approaching.sum()),
        "nearer_goal_share": float(nearer.mean()) if nearer.size else None,
        "nearer_goal_share_all_lanes": float(
            (d_final < d_start - 0.3).mean()),
        "min_clearance_min": float(r["min_clearance"].min()),
        "min_static_clearance_min": float(r["min_static_clearance"].min()),
        "deviation_mean": float(r["deviation_mean"].mean())}), flush=True)
    # The cold pre-solve of step 0 is inside sim_s and the launch count.

    for f, val in r.items():
        if val.shape[0] != B:
            raise AssertionError(f"sim path: {f} has shape {val.shape}")
        if val.dtype.kind == "f" and not np.isfinite(val).all():
            raise AssertionError(f"sim path: non-finite {f}")
    if n_obs != 55:
        raise AssertionError(f"sim path: {n_obs} obstacles, expected 55")
    if r["collided_static"].mean() > 0.02:
        raise AssertionError("sim path: more than 2 % of the lanes ended "
                             "inside a static polygon")
    # tests/test_batch_sim.py's bar (0.3 m nearer the goal after 10 steps),
    # for 90 % of the lanes that are not done and whose route approaches
    # the goal in these steps (a pedestrian in the way may hold a lane up).
    # The set itself comes from the port's reference trajectories: 0.719 of
    # these routes approach their goal in 10 steps, so fewer than 0.6 would
    # mean shortened or reversed references, not unlucky routes.
    if approaching.sum() < 0.6 * B:
        raise AssertionError(f"sim path: only {int(approaching.sum())} of "
                             f"{B} routes approach their goal")
    if nearer.mean() < 0.9:
        raise AssertionError(f"sim path: only {nearer.mean():.3f} of the "
                             "lanes whose route approaches the goal got "
                             "0.3 m nearer it")
    if fail_per_step > 0.5:
        raise AssertionError(f"sim path: {fail_per_step:.3f} non-converged "
                             "solves per lane and step")
    if launches <= 0:
        raise AssertionError("sim path never launched spd_cholesky")
    return launches


def sim_reference_check(cfg, robot, scfg):
    """The sim on the card against the port's own CPU run: same scenarios,
    same stagger stream."""
    import torch

    from dyobav_tpu_torch.sim.batch import build_batch_sim
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import random_scenarios

    B, T = SIM_REF_BATCH, SIM_REF_STEPS
    base = MainBase(max_run_time_step=T, evaluation=True, seed=0)
    batch = random_scenarios(base, B, seed=1)
    rng = np.random.default_rng(1)
    stream = (rng.choice([-1.0, 1.0], (B, T, 1))
              * rng.integers(0, 11, (B, T, 1)) / 10.0 * 0.5).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res, (traj, _) = build_batch_sim(
            cfg, robot, scfg, n_steps=T, multistart=True, record_traj=True,
            stagger_stream=stream, device=dev)(batch, np.arange(B))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (res, traj.cpu().numpy(), time.perf_counter() - t0)
    (rg, tg, sg), (rc, tc, s_cpu) = out["cuda"], out["cpu"]
    dev_m = np.abs(tg[:, :, :2] - tc[:, :, :2]).max(axis=(0, 2))   # (B,)
    flags_equal = all(
        torch.equal(getattr(rg, f).cpu(), getattr(rc, f))
        for f in ("success", "collided", "collided_static", "steps_used"))
    print(f"sim reference check (B={B}, {T} steps, card vs the port on the "
          f"CPU): max robot position deviation per lane "
          f"{np.array2string(dev_m, precision=2)} m, flags equal "
          f"{flags_equal}; card {sg:.1f} s, CPU {s_cpu:.1f} s", flush=True)
    # The two runs share every operation but the SPD kernel (which equals
    # its plain version bit for bit) and the libraries' rounding: 1e-3 m
    # at every step on every lane.
    if not (dev_m.max() <= 1e-3 and flags_equal):
        raise AssertionError("card and CPU runs of the sim disagree")


def drive_lanes_path(device):
    """Path 3: the second kernel's entry point (check_kernel has already
    held it against its plain version at this size).  Returns its
    launches."""
    import torch

    from dyobav_tpu_torch.ops import spd_lanes

    A, b = spd_inputs((LANES_BATCH,), 40, LANES_BATCH // 64, device, seed=1)
    reset_counts()
    x = spd_lanes.batched_spd_solve(A, b, force_kernel=True)
    torch.cuda.synchronize()
    launches = spd_lanes.batched_spd_solve.launches
    print(f"entry point batched_spd_solve(force_kernel=True) "
          f"{tuple(A.shape)}: launches={launches}", flush=True)
    if tuple(x.shape) != tuple(b.shape) or launches != 1:
        raise AssertionError("batched_spd_solve(force_kernel=True) did not "
                             "launch spd_lanes once")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration,
                                          SolverConfiguration)
    from dyobav_tpu_torch.kernels import build
    from dyobav_tpu_torch.ops import spd, spd_lanes

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"card: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)
    # Build the kernels from the checkout's sources.
    for name in ("spd_cholesky", "spd_lanes"):
        res = build.build(name)
        usage = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {name}: {res.seconds:.2f} s nvcc "
              f"({'built' if res.log else 'reused'} {res.path.name}); "
              + " | ".join(usage), flush=True)

    # Each kernel against its plain version at the shapes the paths give
    # it: the solve's warm stage (B, 4 rungs) and escalation stage (K
    # slots, 4 rungs); the sim's warm multistart stage (5 candidates x
    # SIM_BATCH lanes, 4 rungs), its cold re-solve of the distressed lanes
    # (5 candidates x K_sim slots) and its step-0 cold pre-solve (SIM_BATCH
    # lanes); the second kernel at the solve's 8192 systems, at its
    # docstring's 512 and at a ragged 200.
    K = max(BATCH // 16, min(BATCH, 16), 1)
    K_sim = max(SIM_BATCH // 2, min(SIM_BATCH, 8), 1)
    entry1 = check_kernel(
        "spd_cholesky", "dyobav_tpu_torch/csrc/spd_cholesky.cu",
        "dyobav_tpu/ops/pallas_spd.py:46", spd.spd_solve,
        spd.spd_solve_plain,
        [(BATCH, 4), (K, 4), (5 * SIM_BATCH, 4), (5 * K_sim, 4),
         (SIM_BATCH, 4)], device, PEAKS)
    entry2 = check_kernel(
        "spd_lanes", "dyobav_tpu_torch/csrc/spd_lanes.cu",
        "docs/negative_results/pallas_linalg_lanes.py:30",
        lambda A, b: spd_lanes.batched_spd_solve(A, b, force_kernel=True),
        spd_lanes.batched_spd_solve_plain,
        [(LANES_BATCH,), (512,), (200,)], device, PEAKS)

    cfg, robot, scfg = (MpcConfiguration(), CircularRobotSpecification(),
                        SolverConfiguration())
    solve_launches = drive_solve_path(cfg, robot, scfg, device)
    sim_launches = drive_sim_path(cfg, robot, scfg)
    sim_reference_check(cfg, robot, scfg)
    lanes_launches = drive_lanes_path(device)

    entry1["launches"] = solve_launches + sim_launches
    entry1["launches_by_path"] = {"solve_batch_escalated": solve_launches,
                                  "build_batch_sim": sim_launches}
    entry2["launches"] = lanes_launches
    entry2["launches_by_path"] = {"batched_spd_solve": lanes_launches}
    print(json.dumps({"kernels": [entry1, entry2]}), flush=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
