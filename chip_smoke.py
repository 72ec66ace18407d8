#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dyobav_tpu_torch/csrc/`, holds each
kernel against its plain PyTorch version at the main path's shapes, then
drives the main path -- `build_mpc_solver(MpcConfiguration(),
CircularRobotSpecification(), SolverConfiguration()).solve_batch_escalated`
over B=2048 receding-horizon problems (the problem generator of `bench.py`:
seed 0, straight references, one lateral ellipse) -- once cold, then after
3 warm steps, and times it.  Each phase prints a line; the line before the
last is the kernel table as JSON and the last line is

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
WARM_STEPS = 3      # warm steps before the timed solves, as bench.py
ITERS = 2           # timed escalated solves
REF_BATCH = 16      # problems of the card-vs-CPU reference check


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


def check_spd_kernel(device, peaks, shapes):
    """Kernel against its plain version at each main-path shape; returns
    the kernel table entry (timed at the first shape)."""
    import torch

    from dyobav_tpu_torch.ops import spd

    n = 40
    entry = None
    for lead in shapes:
        B = int(np.prod(lead))
        n_indef = max(B // 64, 1)
        A, g = spd_inputs(lead, n, n_indef, device)
        d = spd.spd_solve(A, g)
        torch.cuda.synchronize()
        ref = spd.spd_solve_plain(A, g)
        torch.cuda.synchronize()
        d2, r2 = d.reshape(B, n), ref.reshape(B, n)
        fin_k, fin_p = torch.isfinite(d2).all(-1), torch.isfinite(r2).all(-1)
        if not torch.equal(fin_k, fin_p):
            raise AssertionError(
                f"spd_cholesky {lead}: finiteness differs from the plain "
                f"version on {int((fin_k != fin_p).sum())} systems")
        if not bool(fin_p[n_indef:].all()):
            raise AssertionError(f"spd_cholesky {lead}: an SPD system "
                                 "came out non-finite")
        # Tolerance: the same algorithm in the same order; the kernel's
        # rsqrtf and the plain version's rsqrt may round differently, so
        # SPD solutions agree to 1e-4 of their scale.
        err = (d2[n_indef:] - r2[n_indef:]).abs().max()
        rel = float(err / r2[n_indef:].abs().max())
        if not rel <= 1e-4:
            raise AssertionError(f"spd_cholesky {lead}: max rel err {rel}")
        ms = cuda_ms(lambda: spd.spd_solve(A, g), 20)
        plain_ms = cuda_ms(lambda: spd.spd_solve_plain(A, g), 3)
        # Yardstick only (the port never calls it): the library's batched
        # Cholesky factor and solve on the same inputs.
        library_ms = cuda_ms(lambda: torch.cholesky_solve(
            g[..., None], torch.linalg.cholesky_ex(A)[0])[..., 0], 5)
        bound, bound_by = spd_bound_ms(B, n, peaks)
        print(f"kernel spd_cholesky {tuple(lead) + (n, n)}: "
              f"max_abs_err={float(err):.3e} max_rel_err={rel:.3e} "
              f"non-finite (indefinite) systems={int((~fin_k).sum())}/"
              f"{n_indef} ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} "
              f"({bound_by})", flush=True)
        if entry is None:
            entry = {
                "name": "spd_cholesky", "route": "cuda",
                "source": "dyobav_tpu_torch/csrc/spd_cholesky.cu",
                "replaces": "dyobav_tpu/ops/pallas_spd.py:46",
                "launches": None, "max_abs_err": float(err),
                "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": list(lead) + [n, n]}
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
    from dyobav_tpu_torch.motion.models import unicycle_step
    from dyobav_tpu_torch.ops import spd
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

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
    # Phase 2: build the path's kernel from the checkout's source.
    res = build.build("spd_cholesky")
    usage = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build spd_cholesky: {res.seconds:.2f} s nvcc "
          f"({'built' if res.log else 'reused'} {res.path.name}); "
          + " | ".join(usage), flush=True)

    # Phase 3: each kernel against its plain version at the main path's
    # shapes: the warm stage's (B, 4 rungs) and the escalation stage's
    # (K slots, 4 rungs).
    B = BATCH
    K = max(B // 16, min(B, 16), 1)
    entry = check_spd_kernel(device, PEAKS, [(B, 4), (K, 4)])

    cfg, robot, scfg = (MpcConfiguration(), CircularRobotSpecification(),
                        SolverConfiguration())
    make_Z, states, u_prev, U0 = make_problems(cfg, B)

    # Phase 4a: the card against the port's CPU run on a small batch.
    reference_check(cfg, robot, scfg, make_Z, states, u_prev, U0, REF_BATCH)

    # Phase 4b: the main path, with the launch counts read around it.
    bundle = build_mpc_solver(cfg, robot, scfg)
    step = torch.func.vmap(lambda s, u: unicycle_step(s, u, cfg.ts))
    spd.spd_solve.launches = 0
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
    U0_w = U0_k
    exit_ok = float(sol.exit_ok.float().mean())
    infeas_p95 = float(np.percentile(sol.infeasibility.cpu().numpy(), 95))
    Z_dev = torch.as_tensor(Z, device=device)
    launches_before = spd.spd_solve.launches
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = bundle.solve_batch_escalated(Z_dev, U0_w)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = spd.spd_solve.launches
    timed_launches = launches - launches_before
    solves_per_s = B * ITERS / elapsed
    print(json.dumps({
        "main_path": "solve_batch_escalated", "batch": B,
        "warm_steps": WARM_STEPS, "exit_ok": exit_ok,
        "exit_ok_cold": exit_ok_cold, "infeas_p95": infeas_p95,
        "solves_per_s": solves_per_s, "timed_solves": ITERS,
        "s_per_escalated_solve": elapsed / ITERS,
        "spd_launches_timed": timed_launches,
        "spd_launches_main_path": launches}), flush=True)

    # Checks on what came out.
    for name, val in (("u", out.u), ("cost", out.cost),
                      ("pred_states", out.pred_states)):
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"main path: non-finite {name}")
    if tuple(out.u.shape) != (B, cfg.nu * cfg.N_hor) or tuple(
            out.pred_states.shape) != (B, cfg.N_hor, cfg.ns):
        raise AssertionError(f"main path: shapes {tuple(out.u.shape)}, "
                             f"{tuple(out.pred_states.shape)}")
    if launches <= 0 or timed_launches <= 0:
        raise AssertionError("main path never launched spd_cholesky")
    if not exit_ok >= 0.5:
        raise AssertionError(f"main path: exit_ok {exit_ok} below 0.5")

    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
