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
   second kernel, on 8192 systems;
4. the SWTA neural predictor: the trained net strictly loaded from
   `Model/wsd_1t20_full_torch.pt` against the port's CPU run on 20 real
   input stacks (`MmpInterface.get_motion_prediction` as well), then
   `build_batch_sim(..., predictor=make_wta_predictor(...))` at
   WTA_BATCH scenarios for WTA_STEPS steps (the `build_batch_sim[wta]`
   path, which runs kernel 1 through its solves), and the same sim at
   WTA_REF_BATCH scenarios against the port's CPU run;
5. the per-episode harness, the entry point of
   `python -m dyobav_tpu_torch.sim eval`: scenario 1 with the cvmp
   predictor for HARNESS_REF_STEPS steps on the card against the port's
   CPU run (`harness_card_vs_cpu`), then `MainBase(scenario_index=0,
   evaluation=True).run("mpc", "cvmp")` at the shipped
   `SolverConfiguration()` for HARNESS_STEPS steps (`harness[mpc+cvmp]`)
   and `run("mpc", "mmp")` at the entry's mmp budget (cold profile (30,
   10, 10, 1, 10.0)) for HARNESS_MMP_STEPS steps (`harness[mpc+mmp]`):
   one 5-candidate `solve_batch` a step, kernel 1 at (5, 4).  A step
   solves one robot, so the host sets its time: these run in a second
   process (its own launch counts) beside paths 1-4, started once the
   kernels are timed.  Each fails on a non-finite action, a robot inside
   a static polygon, or a robot not 0.1 m nearer its goal along its route.
   The same process then runs the paper's baselines: a whole episode of
   `run("dwa", "cvmp")` on scenario 0 (`harness[dwa+cvmp]`, at most 120
   steps), the DWA harness on the card against the port's CPU run for
   DWA_REF_STEPS steps (`harness_dwa_card_vs_cpu`), `run("dwa", "kfmp")`
   for HARNESS_DWA_STEPS steps (`harness[dwa+kfmp]`) and `run("mpc",
   "kfmp")` at the shipped budget for HARNESS_KFMP_STEPS steps
   (`harness[mpc+kfmp]`, kernel 1 at (5, 4)), with the same checks;
6. the PANOC method: `build_mpc_solver(..., SolverConfiguration(
   max_inner_iters=300, max_outer_iters=10, inner_iters_later=150),
   method="panoc").solve_batch_escalated` once on path 1's B=2048 step-0
   problems (`solve_batch_escalated[panoc]`), after its card-vs-CPU check
   on PANOC_REF_BATCH of them at a 5-iteration budget.  PANOC solves no
   linear system: it runs no hand-written kernel, and the script fails if
   it launches one.  Its ~1,650 eager iterations run in a third process
   beside the others;
7. the off-default solver modes (`hessian_mode="structured"`, `"jacfwd"`,
   `linear_solver="schulz"`, `fused=False`): `solve_batch_escalated` on
   path 1's first MODE_BATCH step-0 problems at MODE_BUDGET, each on the
   card against the port's CPU run (`solve_batch_escalated[<mode>]`, in
   PANOC's process after it).  Schulz solves with matrix products and
   must launch no kernel; the others launch kernel 1;
8. the deployment node, the robot-on-the-floor entry:
   `NavigationNode(fused_step=build_step_program(...))` on a
   `LocalTransport`, scenario 0 at the shipped `SolverConfiguration()`,
   in the world of `scripts/deploy_latency_torch.py` (the pedestrian
   drifts, the robot follows the commanded action), in the harness's
   process after its phases: the cold start and DEPLOY_REF_TICKS ticks on
   the card against the port's CPU run (`deploy_card_vs_cpu`), then
   DEPLOY_TICKS ticks with cvmp (`deploy[cvmp]`) and DEPLOY_WTA_TICKS with
   the neural predictor on the strictly loaded net (`deploy[wta]`).  Each
   fails on a non-finite action, a negative speed, a cmd_vel count other
   than the ticks, or other than two host syncs a tick (the node's one
   copy and the multistart's one sync).  The cold start runs kernel 1 at
   (1, 4), a tick at (5, 4);
9. the decentralized fleet, in PANOC's process after the solver modes:
   tests/test_fleet.py's head-on corridor at lateral offsets 0.2 and 0.35
   (two robots, no pedestrian) at the shipped `SolverConfiguration()` for
   FLEET_REF_STEPS steps on the card against the port's CPU run
   (`fleet_card_vs_cpu`), then `MainBase` -> `random_fleet_scenarios(base,
   FLEET_BATCH, n_robots=FLEET_ROBOTS, n_humans=1, seed=0)` ->
   `build_fleet_sim(..., n_steps=FLEET_STEPS, multistart=True)`
   (`build_fleet_sim`: 128 solve lanes, all 10 other-robot slots of the
   parameter vector) and the same at FLEET_WTA_BATCH scenarios for
   FLEET_WTA_STEPS steps with the neural predictor on the strictly loaded
   net (`build_fleet_sim[wta]`).  Each fails on a non-finite field, more
   than 2 % of the robots inside a static polygon, more than 0.5
   non-converged solves per robot and step, other than one host sync a
   step, no kernel-1 launch, or fewer than 90 % of the robots that have not
   collided and whose reference approaches the goal ending 0.1 m nearer
   it.  The fleet runs kernel 1 at (5 B R, 4), (5 K, 4) with K = max(B R //
   2, min(B R, 8), 1) and (B R, 4): (640, 4), (320, 4), (128, 4) and
   (320, 4), (160, 4), (64, 4), all among the shapes the other paths give
   it, where they are held and timed.

10. the SWTA training stack, in a fourth process beside the others, on a
   synthetic WSD-format dataset written to a temporary directory (walks on
   the real map's free space from a seed; the 1.77 M-sample set is not in
   the repository): one `NetworkManager._train_step_fused` at full width
   (7 x 293 x 330, TRAIN_REF_BATCH images) on the card against the port's
   CPU run from one seeded init (`train_card_vs_cpu`, TF32 off: in float32
   the loss within 1e-4 relative, each parameter's gradient within
   TRAIN_GRAD_RL2 in relative L2 (float32 gradients are 1e-3 to 1e-2 from
   float64 at this size on either device), the BatchNorm statistics
   within 1e-5; in float64 within 1e-10, 1e-6 and 1e-8), then `python -m
   dyobav_tpu_torch.models.train` through `main(argv)` at batch 20:
   TRAIN_EPOCHS epochs of the device loop in chunks of TRAIN_CHUNK steps
   and a host-paced run (`train[wta]`; it fails on a non-finite loss, on
   a last-chunk mean not below the first's, on other than one host sync a
   chunk, on a kernel-1 launch (training solves no linear system), or if
   the written `.pt` does not load through `load_checkpoint`, give the
   manager's hypotheses and run one `make_wta_predictor` call), and a few
   timed steps of each MDN net (`train[mdn]`, `train[mdnfit]`) on the
   synthetic images with the standard-normal labels of
   tests/test_models.py's MDN tests: the reference's mixture NLL is +inf
   at a fresh init on labels in pixels, in both packages.
11. multi-device sweeps, in the training process after its phases
   (`sweep[devices]`): `python -m dyobav_tpu_torch.sim.sweep` through
   `main(argv)` with SWEEP_ARGS and `--devices 1`, then `--devices 0`
   (JAX's "every device", one unsharded batch in the port): equal
   statistics, `"devices"` 1 both times; `shard_map_batch` of `build_batch_sim`'s run over [cuda:0,
   cuda:0] against the unsharded run at SHARD_BATCH scenarios for
   SHARD_STEPS steps (robots within 1e-4 m at every step, flags and counts
   equal); and a one-process `--distributed` run (NCCL, world size 1, a
   port the system chose): `--devices 1`'s counts, its means within 1e-5.
   Each fails without a kernel-1 launch.  The harness's process also runs
   `run("dwa", "mmp")` on scenario 0 for HARNESS_DWA_MMP_STEPS steps with
   the strictly loaded net (`harness[dwa+mmp]`, after `harness[dwa+kfmp]`),
   with the harness's checks and no kernel-1 launch: with it all six
   (tracker, predictor) pairs run on the card.

Each kernel is timed back to back (`ms`: inputs that fit stay in the L2
cache) and one call at a time after a write that evicts the L2 cache
(`ms_cold`); `bound_share` is its bound over `ms_cold` and fails above
1.05.  The stem kernel (`csrc/stem_expand_pool.cu`, the SWTA net's stem
expanded over the offsets) is held bit for bit to its plain version at
STEM_SHAPES, and each path with the neural predictor (`build_batch_sim[wta]`,
`deploy[wta]`, `build_fleet_sim[wta]`) fails unless it launches it once a
predictor call.  Each phase prints a line; the line before the last is the kernel
table as JSON and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises and the script exits non-zero without that line.
It needs a CUDA device and the repository beside it; it imports no JAX.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import queue
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

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
WTA_BATCH = 64      # scenarios of the neural sim: 64 x 20 offsets = 1280
                    # images a CNN call (the stem's pooled output is 2.0 GB)
WTA_STEPS = 3       # control steps of it
WTA_REF_BATCH = 2   # scenarios of the neural sim's card-vs-CPU check
WTA_REF_STEPS = 2   # control steps of it
HARNESS_STEPS = 4   # control steps of harness[mpc+cvmp] (an episode is 120)
HARNESS_MMP_STEPS = 3   # control steps of harness[mpc+mmp]
HARNESS_REF_STEPS = 3   # control steps of harness_card_vs_cpu, at a small
                        # budget: 3 warm iterations, the cold profile 9
HARNESS_REF_BUDGET = dict(max_inner_iters=3, max_outer_iters=1,
                          inner_iters_later=1, newton_substeps=1,
                          cold_profile=(6, 2, 3, 1, 10.0))
MMP_BUDGET = dict(cold_profile=(30, 10, 10, 1, 10.0))   # sim/entry.py's
HARNESS_DWA_MAX_STEPS = 120   # harness[dwa+cvmp]: a whole episode
DWA_REF_STEPS = 10        # steps of harness_dwa_card_vs_cpu
HARNESS_DWA_STEPS = 10    # control steps of harness[dwa+kfmp]
HARNESS_KFMP_STEPS = 3    # control steps of harness[mpc+kfmp]
PANOC_BUDGET = dict(max_inner_iters=300, max_outer_iters=10,
                    inner_iters_later=150)   # tests/test_panoc.py's OpEn scale
PANOC_REF_BATCH = 8       # problems of the PANOC card-vs-CPU check
PANOC_REF_BUDGET = dict(max_inner_iters=5, max_outer_iters=1)
DEPLOY_REF_TICKS = 2      # ticks of deploy_card_vs_cpu (the first holds
                          # the cold start)
DEPLOY_TICKS = 4          # ticks of deploy[cvmp]
DEPLOY_WTA_TICKS = 3      # ticks of deploy[wta]
MODE_BATCH = 16           # path 1's step-0 problems of the solver modes
# The solver modes' short budget: warm 10 + 4 x 5 iterations with the
# penalty ramped from 10 (tests/test_torch_newton_modes.py's float32
# budget), one escalation stage of 6 + 3 iterations.
MODE_BUDGET = dict(max_inner_iters=10, max_outer_iters=5,
                   inner_iters_later=5, newton_substeps=1,
                   initial_penalty=10.0, cold_profile=(6, 2, 3, 1, 10.0),
                   escalation_ladder=((6, 2, 3, 1, 10.0),))
MODES = (("structured", {"hessian_mode": "structured"}),
         ("jacfwd", {"hessian_mode": "jacfwd"}),
         ("schulz", {"linear_solver": "schulz"}),
         ("staged", {"fused": False}))
FLEET_BATCH = 32          # scenarios of build_fleet_sim: 128 solve lanes
FLEET_ROBOTS = 4          # robots a scenario (the solver holds up to 11)
FLEET_STEPS = 5           # control steps of build_fleet_sim
FLEET_WTA_BATCH = 16      # scenarios of build_fleet_sim[wta]: 64 lanes,
                          # 320 images a CNN call
FLEET_WTA_STEPS = 3       # control steps of it (2 would leave the robots,
                          # accelerating from rest, under 0.12 m of travel)
FLEET_REF_STEPS = 3       # control steps of fleet_card_vs_cpu
TRAIN_SYNTH = dict(n_videos=2, n_peds=4, n_frames=40, seed=0)
                          # synthetic WSD walks on the real map: 4080
                          # samples, 3264 to train (163 steps an epoch)
TRAIN_BATCH = 20          # WtaNetConfiguration.batch_size, the recipe's
TRAIN_EPOCHS = 2          # device-loop epochs of train[wta] (k_top 20, 1)
TRAIN_CHUNK = 20          # optimizer steps a host sync in the device loop
TRAIN_HOST_STEPS = 10     # steps an epoch of train[wta]'s host-paced run
TRAIN_REF_BATCH = 4       # images of train_card_vs_cpu
TRAIN_WARMUP, TRAIN_TIMED = 5, 20   # steps before / in a timed window
TRAIN_GRAD_RL2 = 2e-2     # train_card_vs_cpu: float32 gradient bound
SWEEP_ARGS = ["--n", "8", "--steps", "2"]   # sweep[devices]'s sweep runs
SHARD_BATCH, SHARD_STEPS = 8, 3   # shard_map_batch over [cuda:0, cuda:0]
HARNESS_DWA_MMP_STEPS = 10  # control steps of harness[dwa+mmp]
CHILD_TIMEOUT_S = 600     # wait for the other processes after paths 1-4
STEM_SHAPES = ((64, 20), (1, 20))   # (pedestrians, offsets) of the stem
                          # kernel's rows: the predictor cell's call (the
                          # neural sim's too) and one pedestrian's
STEM_PLANE = (64, 147, 165)   # the stem's channels x rows x columns at the
                              # map's 293 x 330 px

# Stem kernel launches by path, this process's (`count_stem`).
STEM_LAUNCHES = {}


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
    """Mean device time of `reps` back-to-back calls (after one warm-up):
    inputs that fit in the L2 cache stay there from one call to the next."""
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


def l2_flush_buffer(device, props=None):
    """A buffer whose write evicts the whole L2 cache: twice its size
    (`props.L2_cache_size` bytes, the device's own by default)."""
    import torch

    if props is None:
        props = torch.cuda.get_device_properties(device)
    return torch.empty(2 * props.L2_cache_size // 4 + 1, dtype=torch.float32,
                       device=device)


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of `reps` calls, each timed by its own events after
    a write of `flush` has evicted the L2 cache.  A device-side sleep ahead
    of each flush lets the host queue the call before the device reaches
    it, so that the events time the kernel and not the host's launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def spd_bound_bytes(batch: int, n: int) -> int:
    """Bytes that `batch` solves of n x n f32 systems must move: the
    distinct 32-byte sectors that hold the lower triangles of the row-major
    (batch, n, n) A (all that the factorization and both substitutions
    read; rows, and systems, may share a sector), plus g read and d
    written once."""
    rows = np.arange(batch * n, dtype=np.int64)    # row (b, i) is b * n + i
    start = rows * n * 4                           # its first byte in A
    end = start + (rows % n + 1) * 4               # one past its diagonal
    first, last = start // 32, (end - 1) // 32
    # Rows are disjoint and in address order, so a sector is shared, if at
    # all, by a row's last sector and the next row's first.
    sectors = int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())
    return 32 * sectors + 2 * 4 * batch * n


def spd_bound_ms(batch: int, n: int, peaks) -> tuple[float, str]:
    """Least time for `batch` solves of n x n f32 systems, the larger of
    two: `spd_bound_bytes` at the memory rate, and the factorization's and
    substitutions' flops at the fp32 CUDA-core rate."""
    update_pairs = sum((m * (m + 1)) // 2 for m in range(n))
    flops = batch * (2 * update_pairs          # trailing updates
                     + n * (n + 1) // 2 + n    # column scaling + rsqrt
                     + 2 * n * (n - 1) + 2 * n)  # substitutions
    t_bytes, t_ops = spd_bound_bytes(batch, n) / peaks[0], flops / peaks[1]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bound_share(bound_ms: float, ms_cold: float, label: str) -> float:
    """bound_ms / ms_cold; above 1.05 the kernel would beat the card's own
    limits, so the byte count or the timing is wrong: raise."""
    share = bound_ms / ms_cold
    if not share <= 1.05:
        raise AssertionError(f"{label}: bound {bound_ms:.4f} ms over a cold "
                             f"time of {ms_cold:.4f} ms is {share:.3f} > "
                             "1.05, an impossible reading")
    return share


def check_kernel(name, source, replaces, kernel, plain, shapes, device,
                 peaks):
    """One SPD kernel against its plain version at each shape (leading
    dims of 40x40 systems, 1/64 of them indefinite), timed back to back
    (`ms`, L2-warm) and one call at a time after an L2 flush (`ms_cold`,
    against which `bound_share` is taken); returns the kernel table entry:
    the first shape's numbers at the top level, the others' under
    `other_shapes`."""
    import torch

    n = 40
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": None}
    flush = l2_flush_buffer(device)
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
        ms_cold = cold_ms(lambda: kernel(A, g), 20, flush)
        plain_ms = cuda_ms(lambda: plain(A, g), 2)
        # Yardstick only (the port's kernels never call it): the library's
        # batched Cholesky factor and solve on the same inputs.
        library_ms = cuda_ms(lambda: torch.cholesky_solve(
            g[..., None], torch.linalg.cholesky_ex(A)[0])[..., 0], 5)
        bound, bound_by = spd_bound_ms(B, n, peaks)
        share = bound_share(bound, ms_cold, f"{name} {lead}")
        print(f"kernel {name} {tuple(lead) + (n, n)}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"non-finite (indefinite) systems={int((~fin).sum())}/"
              f"{n_indef} ms={ms:.4f} ms_cold={ms_cold:.4f} "
              f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
              f"bound_ms={bound:.4f} ({bound_by}) bound_share={share:.4f}",
              flush=True)
        rows.append({
            "shape": list(lead) + [n, n], "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "ms_cold": ms_cold,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_share": share, "library_ms": library_ms})
    entry.update(rows[0], other_shapes=rows[1:])
    return entry


def stem_bound_ms(P: int, K: int, C: int, Ho: int, Wo: int,
                  peaks) -> tuple[float, str]:
    """Least time of the stem kernel at (P, K, C, Ho, Wo), the larger of
    two: its bytes at the memory rate (s and m read once, the offsets,
    scale and shift, the pooled output written once) and its operations
    at the fp32 rate (o * m, + s, * scale, + shift and the activation's
    product an input element and offset; 8 comparisons an output)."""
    Hp, Wp = (Ho - 1) // 2 + 1, (Wo - 1) // 2 + 1
    n_bytes = 4 * (P * C * Ho * Wo + C * Ho * Wo + K + 2 * C
                   + P * K * C * Hp * Wp)
    ops = 5 * P * K * C * Ho * Wo + 8 * P * K * C * Hp * Wp
    t_bytes, t_ops = n_bytes / peaks[0], ops / peaks[1]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_stem_kernel(device, peaks):
    """The stem kernel (`ops/stem.stem_expand_pool`) against its plain
    version, bit for bit, at STEM_SHAPES on STEM_PLANE: random
    convolutions, BatchNorm statistics and offsets 1..K; timed as
    `check_kernel` times, with the PyTorch chain of the sum, `batch_norm`,
    `leaky_relu` and `max_pool2d` as the yardstick (the port never calls
    it).  Returns the kernel table entry."""
    import torch
    import torch.nn.functional as F

    from dyobav_tpu_torch.ops import stem

    C, Ho, Wo = STEM_PLANE
    entry = {"name": "stem_expand_pool", "route": "cuda",
             "source": "dyobav_tpu_torch/csrc/stem_expand_pool.cu",
             "replaces": None, "launches": None}
    flush = l2_flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for P, K in STEM_SHAPES:
        s = torch.randn(P, C, Ho, Wo, generator=gen, device=device)
        m = torch.randn(C, Ho, Wo, generator=gen, device=device)
        mean = torch.randn(C, generator=gen, device=device)
        var = torch.rand(C, generator=gen, device=device) + 0.5
        gamma = torch.rand(C, generator=gen, device=device) + 0.5
        beta = torch.randn(C, generator=gen, device=device)
        scale = gamma / torch.sqrt(var + 1e-5)
        shift = beta - mean * scale
        offsets = torch.arange(1.0, K + 1, device=device)
        args = (s, m, offsets, scale, shift)
        got = stem.stem_expand_pool(*args)
        want = stem.stem_expand_pool_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"stem_expand_pool {(P, K)}: differs from the plain version "
                f"by {float((got - want).abs().max())}")
        del got, want

        def library():
            z = (s[:, None] + offsets[:, None, None, None] * m).reshape(
                P * K, C, Ho, Wo)
            y = F.batch_norm(z, mean, var, gamma, beta, False, 0.0, 1e-5)
            return F.max_pool2d(F.leaky_relu(y, 0.1, inplace=True), 3, 2,
                                padding=1)

        ms = cuda_ms(lambda: stem.stem_expand_pool(*args), 20)
        ms_cold = cold_ms(lambda: stem.stem_expand_pool(*args), 20, flush)
        plain_ms = cuda_ms(lambda: stem.stem_expand_pool_plain(*args), 2)
        library_ms = cuda_ms(library, 5)
        bound, bound_by = stem_bound_ms(P, K, C, Ho, Wo, peaks)
        share = bound_share(bound, ms_cold, f"stem_expand_pool {(P, K)}")
        print(f"kernel stem_expand_pool {(P, K, C, Ho, Wo)}: equal to the "
              f"plain version; ms={ms:.4f} ms_cold={ms_cold:.4f} "
              f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
              f"bound_ms={bound:.4f} ({bound_by}) bound_share={share:.4f}",
              flush=True)
        rows.append({"shape": [P, K, C, Ho, Wo], "max_abs_err": 0.0,
                     "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "bound_share": share, "library_ms": library_ms})
        del s, m, args
        torch.cuda.empty_cache()
    entry.update(rows[0], other_shapes=rows[1:])
    return entry


def count_stem(name: str, calls: int, before: int) -> None:
    """Records the stem kernel's launches on path `name` since `before`
    in STEM_LAUNCHES; fails unless the predictor launched it once a
    call."""
    from dyobav_tpu_torch.ops import stem

    n = stem.stem_expand_pool.launches - before
    STEM_LAUNCHES[name] = n
    if n != calls:
        raise AssertionError(f"{name}: {n} stem kernel launches in {calls} "
                             "predictor calls")


def sim_kernel_shapes(lanes: int) -> list:
    """Kernel 1's shapes in a batched sim of `lanes` solve lanes: the warm
    multistart (5 candidates a lane), the cold re-solve of the distressed
    lanes (5 candidates x K slots, K as sim/batch.py takes it) and the
    step-0 cold pre-solve, each over 4 LM rungs."""
    K = max(lanes // 2, min(lanes, 8), 1)
    return [(5 * lanes, 4), (5 * K, 4), (lanes, 4)]


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
    engine.to_host.syncs = 0


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


def conv_net_flops(net, shape) -> int:
    """Operations of one forward of `net` on an input of `shape` (batch 1):
    2 x the multiply-adds of its convolutions and dense layers (BatchNorm,
    activations and pooling, under 1 % of them, are not counted)."""
    import torch

    total = [0]

    def count(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            total[0] += (2 * out[0].numel() * m.in_channels // m.groups
                         * m.kernel_size[0] * m.kernel_size[1])
        else:
            total[0] += 2 * m.in_features * m.out_features

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(torch.zeros((1,) + tuple(shape),
                            device=next(net.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def wta_net_check(base, device):
    """Phase wta_net_card_vs_cpu: the strictly loaded net on the card (TF32
    off) against the port on the CPU, on the 20 offsets' input stacks of a
    real trajectory on the label map; then `MmpInterface` on both."""
    import torch

    from dyobav_tpu_torch.models.heatmap import traj_to_input_stack
    from dyobav_tpu_torch.models.wta_net import full_f32, load_checkpoint
    from dyobav_tpu_torch.predictors.mmp import MmpInterface

    path = os.path.join(ROOT, "Model", "wsd_1t20_full_torch.pt")
    nets = {dev: load_checkpoint(path, dev) for dev in (device, "cpu")}
    traj = [(160.0, 50.0 + 3 * i) for i in range(5)]
    stack = traj_to_input_stack(torch.tensor(traj), base.ref_map,
                                torch.arange(1.0, 21.0))     # (20, 7, H, W)
    with torch.no_grad():
        t0 = time.perf_counter()
        cpu = nets["cpu"](stack)
        cpu_s = time.perf_counter() - t0
        x = stack.to(device)
        with full_f32():
            nets[device](x)                       # cuDNN's first call
            card_ms = cuda_ms(lambda: nets[device](x), 5)
            card = nets[device](x).cpu()
        cudnn = torch.backends.cudnn
        matmul = torch.backends.cuda.matmul
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True):
            saved, matmul.allow_tf32 = matmul.allow_tf32, True
            try:
                tf32 = nets[device](x).cpu()
            finally:
                matmul.allow_tf32 = saved
    dev_px = float((card - cpu).abs().max())
    dev_tf32 = float((tf32 - cpu).abs().max())
    preds = {dev: MmpInterface(net=nets[dev], device=dev
                               ).get_motion_prediction(traj, base.ref_map, 20)
             for dev in (device, "cpu")}
    dev_mmp = max(float(np.abs(a - b).max())
                  for a, b in zip(preds[device], preds["cpu"]))
    print(json.dumps({
        "phase": "wta_net_card_vs_cpu", "images": int(stack.shape[0]),
        "max_abs_hypothesis_dev_px": dev_px,
        "mmp_interface_max_dev_px": dev_mmp, "card_ms": card_ms,
        "cpu_s": cpu_s}), flush=True)
    print(f"information only: with TF32 on (cuDNN and cuBLAS) the card's "
          f"hypotheses deviate from the CPU's by {dev_tf32:.4g} px",
          flush=True)
    if not (np.isfinite(card.numpy()).all() and tuple(card.shape)
            == (20, 20, 2)):
        raise AssertionError("wta net: non-finite or misshapen hypotheses")
    if not (dev_px <= 1e-2 and dev_mmp <= 1e-2):
        raise AssertionError(f"wta net: card and CPU deviate by {dev_px} px "
                             f"(MmpInterface {dev_mmp} px), over 1e-2")
    return nets[device]


def make_wta(base, net, device):
    """The neural predictor of `build_batch_sim` on `device`."""
    from dyobav_tpu_torch.predictors.mmp import ObstacleSnapper
    from dyobav_tpu_torch.sim.batch import make_wta_predictor

    return make_wta_predictor(
        net, base.ref_map, base.ct2real, base.config_mpc.N_hor,
        snap_tables=ObstacleSnapper(255.0 - base.ref_map).tables(),
        scale2nn=base.sim_config.scale2nn, device=device)


def drive_wta_sim_path(cfg, robot, scfg, base, net, device):
    """Path 4: the closed-loop batched sim with the neural predictor at
    WTA_BATCH scenarios.  Returns kernel 1's launches on it."""
    import torch

    from dyobav_tpu_torch.ops import engine, spd, stem
    from dyobav_tpu_torch.sim.batch import BatchResult, build_batch_sim
    from dyobav_tpu_torch.sim.scenarios import random_scenarios

    B, T = WTA_BATCH, WTA_STEPS
    batch = random_scenarios(base, B, seed=0)
    predict = make_wta(base, net, device)
    calls = []

    def timed_predict(hist):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = predict(hist)
        end.record()
        calls.append((start, end, hist.shape[0] * hist.shape[2]))
        return out

    run = build_batch_sim(cfg, robot, scfg, n_steps=T, multistart=True,
                          predictor=timed_predict)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stem0 = stem.stem_expand_pool.launches
    t0 = time.perf_counter()
    res = run(batch, np.arange(B))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches, syncs = spd.spd_solve.launches, engine.any_lane.syncs
    ms = [s.elapsed_time(e) for s, e, _ in calls]
    count_stem("build_batch_sim[wta]", len(ms), stem0)
    images = calls[0][2] * cfg.N_hor
    gflop = conv_net_flops(net, (7,) + tuple(base.ref_map.shape)) / 1e9
    steady = float(np.mean(ms[1:])) if len(ms) > 1 else ms[0]
    r = {f: getattr(res, f).cpu().numpy() for f in BatchResult._fields}
    fail_per_step = float(r["solver_fail_steps"].mean()) / T
    print(json.dumps({
        "main_path": "build_batch_sim[wta]", "scenarios": B, "steps": T,
        "sim_s": sim_s, "s_per_step": sim_s / T,
        "control_steps_per_s": B * T / sim_s,
        "predictor_calls": len(ms), "predictor_ms_per_call": ms,
        "predictor_share_of_sim": sum(ms) / 1e3 / sim_s,
        "cnn_images_per_call": images, "cnn_gflop_per_image": gflop,
        "cnn_tflop_per_s_steady": gflop * images / steady,  # GFLOP/ms
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "solver_fail_steps_mean": float(r["solver_fail_steps"].mean()),
        "escalation_overflow_steps_mean": float(
            r["escalation_overflow_steps"].mean()),
        "spd_launches": launches, "spd_launches_per_step": launches / T,
        "stem_launches": STEM_LAUNCHES["build_batch_sim[wta]"],
        "host_syncs_per_step": syncs / T,
        "collided": int(r["collided"].sum()),
        "collided_static": int(r["collided_static"].sum()),
        "min_clearance_min": float(r["min_clearance"].min()),
        "min_static_clearance_min": float(r["min_static_clearance"].min()),
        "deviation_mean": float(r["deviation_mean"].mean())}), flush=True)
    for f, val in r.items():
        if val.shape[0] != B:
            raise AssertionError(f"wta sim: {f} has shape {val.shape}")
        if val.dtype.kind == "f" and not np.isfinite(val).all():
            raise AssertionError(f"wta sim: non-finite {f}")
    if r["collided_static"].mean() > 0.02:
        raise AssertionError("wta sim: more than 2 % of the lanes ended "
                             "inside a static polygon")
    if fail_per_step > 0.5:
        raise AssertionError(f"wta sim: {fail_per_step:.3f} non-converged "
                             "solves per lane and step")
    if len(ms) != T + 1:          # every step and the cold pre-solve
        raise AssertionError(f"wta sim: {len(ms)} predictor calls")
    if launches <= 0:
        raise AssertionError("wta sim never launched spd_cholesky")
    return launches


def wta_sim_reference_check(cfg, robot, scfg, base, net, device):
    """The neural sim on the card against the port's own CPU run: same
    scenarios, same stagger stream."""
    import torch

    from dyobav_tpu_torch.models.wta_net import load_checkpoint
    from dyobav_tpu_torch.sim.batch import build_batch_sim
    from dyobav_tpu_torch.sim.scenarios import random_scenarios

    B, T = WTA_REF_BATCH, WTA_REF_STEPS
    batch = random_scenarios(base, B, seed=1)
    rng = np.random.default_rng(1)
    stream = (rng.choice([-1.0, 1.0], (B, T, 1))
              * rng.integers(0, 11, (B, T, 1)) / 10.0 * 0.5).astype(np.float32)
    nets = {"cuda": net, "cpu": load_checkpoint(
        os.path.join(ROOT, "Model", "wsd_1t20_full_torch.pt"), "cpu")}
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res, (traj, _) = build_batch_sim(
            cfg, robot, scfg, n_steps=T, multistart=True, record_traj=True,
            stagger_stream=stream, device=dev,
            predictor=make_wta(base, nets[dev], dev))(batch, np.arange(B))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (res, traj.cpu().numpy(), time.perf_counter() - t0)
    (rg, tg, sg), (rc, tc, s_cpu) = out["cuda"], out["cpu"]
    dev_m = np.abs(tg[:, :, :2] - tc[:, :, :2]).max(axis=(0, 2))   # (B,)
    flags_equal = all(
        torch.equal(getattr(rg, f).cpu(), getattr(rc, f))
        for f in ("success", "collided", "collided_static", "steps_used"))
    print(f"neural sim reference check (B={B}, {T} steps, card vs the port "
          f"on the CPU): max robot position deviation per lane "
          f"{np.array2string(dev_m, precision=2)} m, flags equal "
          f"{flags_equal}; card {sg:.1f} s, CPU {s_cpu:.1f} s", flush=True)
    if not (dev_m.max() <= 1e-3 and flags_equal):
        raise AssertionError("card and CPU runs of the neural sim disagree")


def harness_reference_check(device):
    """Phase harness_card_vs_cpu: the harness on the card against the
    port's own CPU run, scenario 1 with the cvmp predictor, seed 1 (the
    pedestrian's stagger is drawn from the seeded `random.Random`, so both
    runs see the same)."""
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.sim.harness import MainBase

    T = HARNESS_REF_STEPS
    out = {}
    for dev in (device, "cpu"):
        base = MainBase(max_run_time_step=T, evaluation=True, seed=1,
                        scenario_index=1, device=dev,
                        solver_config=SolverConfiguration(
                            **HARNESS_REF_BUDGET))
        robot, humans = base._prepare_agents()
        intf, pred = base._prepare_interfaces(robot, "cvmp", "mpc")
        t0 = time.perf_counter()
        for _ in range(T):
            base.run_one_step(robot, humans, intf, pred)
        tracker = intf.traj_tracker
        out[dev] = (np.array([s[:2] for s in robot.past_traj[1:]]),
                    [s == "Converged" for s in tracker.solver_status_timelist],
                    tracker.escalation_count, time.perf_counter() - t0)
    (sg, cg, eg, tg), (sc, cc, ec, tc) = out[device], out["cpu"]
    dev_m = np.abs(sg - sc).max(axis=1)                   # (T,)
    print(json.dumps({
        "phase": "harness_card_vs_cpu", "scenario": 1, "steps": T,
        "robot_dev_m_per_step": dev_m.tolist(), "converged_card": cg,
        "converged_cpu": cc, "escalations_card": eg, "escalations_cpu": ec,
        "card_s": tg, "cpu_s": tc}), flush=True)
    # The two runs share every operation but the SPD kernel (bit for bit
    # its plain version) and the libraries' rounding.
    if not (dev_m.shape == (T,) and dev_m.max() <= 1e-3 and cg == cc
            and eg == ec):
        raise AssertionError("card and CPU runs of the harness disagree")


def route_progress(path, start, state) -> float:
    """Arc length along the route (`start`, then the route's waypoints) from
    `start` to the route's point nearest `state`: how far the robot came
    along its route, a whole episode's included."""
    pts = np.array([start[:2]] + [p[:2] for p in path], dtype=np.float64)
    seg = np.diff(pts, axis=0)
    lens = np.linalg.norm(seg, axis=1)
    t = np.clip(np.einsum("ij,ij->i", np.asarray(state[:2]) - pts[:-1], seg)
                / np.maximum(lens ** 2, 1e-12), 0.0, 1.0)
    dist = np.linalg.norm(pts[:-1] + t[:, None] * seg - state[:2], axis=1)
    k = int(np.argmin(dist))
    return float(lens[:k].sum() + t[k] * lens[k])


def harness_dwa_reference_check(device):
    """Phase harness_dwa_card_vs_cpu: the DWA harness on the card against
    the port's own CPU run, scenario 0 with the cvmp predictor, seed 1."""
    from dyobav_tpu_torch.sim.harness import MainBase

    T = DWA_REF_STEPS
    out = {}
    for dev in (device, "cpu"):
        base = MainBase(max_run_time_step=T, evaluation=True, seed=1,
                        scenario_index=0, device=dev)
        robot, humans = base._prepare_agents()
        intf, pred = base._prepare_interfaces(robot, "cvmp", "dwa")
        t0 = time.perf_counter()
        for _ in range(T):
            base.run_one_step(robot, humans, intf, pred)
        out[dev] = (np.array([s[:2] for s in robot.past_traj[1:]]),
                    np.array(intf.traj_tracker.past_actions),
                    time.perf_counter() - t0)
    (sg, ag, tg), (sc, ac, tc) = out[device], out["cpu"]
    dev_m = np.abs(sg - sc).max(axis=1)                   # (T,)
    print(json.dumps({
        "phase": "harness_dwa_card_vs_cpu", "scenario": 0, "steps": T,
        "robot_dev_m_per_step": dev_m.tolist(),
        "action_dev_max": float(np.abs(ag - ac).max()),
        "card_s": tg, "cpu_s": tc}), flush=True)
    if not (dev_m.shape == (T,) and dev_m.max() <= 1e-4):
        raise AssertionError("card and CPU runs of the DWA harness disagree")


def drive_harness_path(tracker, predictor, scfg, T, device, whole=False):
    """`MainBase(scenario_index=0, evaluation=True).run(tracker,
    predictor)` for T steps (or, `whole`, an episode of at most T steps),
    the MPC bundles warmed first as a process's first tracker does.
    Returns kernel 1's launches on the run."""
    import torch

    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim import metrics
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.trackers.mpc_tracker import TrajectoryTracker

    name = f"harness[{tracker}+{predictor}]"
    base = MainBase(max_run_time_step=T, evaluation=True, seed=0,
                    scenario_index=0, solver_config=scfg, device=device)
    t0 = time.perf_counter()
    if tracker == "mpc":
        TrajectoryTracker(base.config_mpc, base.config_robot, scfg,
                          device=device)._warmup()
    warm_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    base.run(tracker, predictor)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = spd.spd_solve.launches
    syncs = engine.any_lane.syncs + engine.to_host.syncs
    robot, _, intf, _ = base.episode
    tracker_ = intf.traj_tracker
    summary = base.results_summary()
    outcome = summary["outcomes"][-1]
    steps = len(tracker_.past_actions)
    progress = route_progress(robot.path, robot.past_traj[0], robot.state)
    static = base.geo_map.processed_obstacle_list
    static_hits = sum(metrics.check_collision(s, static, [])
                      for s in robot.past_traj)
    print(json.dumps({
        "main_path": name, "scenario": 0, "steps": steps,
        "warmup_s": warm_s, "run_s": run_s,
        "solve_s_per_step": base.solve_time_list,
        "solve_ms_mean": 1e3 * float(np.mean(base.solve_time_list)),
        "predictor_ms_per_step": [1e3 * t for t in base.predict_time_list],
        "escalations": outcome["escalations"],
        "converged_rate": summary.get("converged_rate"),
        "statuses": getattr(tracker_, "solver_status_timelist", None),
        "host_syncs_per_step": syncs / max(steps, 1),
        "spd_launches": launches,
        "spd_launches_per_step": launches / max(steps, 1),
        "route_progress_m": progress, "static_collisions": static_hits,
        "outcome": outcome["outcome"],
        **{k: summary[k] for k in ("clearance_mean", "clearance_dyn_mean",
                                   "deviation_mean", "deviation_max")
           if k in summary}}), flush=True)
    if whole:
        if outcome["outcome"] == "timeout" and steps != T:
            raise AssertionError(f"{name}: the episode stopped after {steps}"
                                 " steps without an outcome")
    elif steps != T:
        raise AssertionError(f"{name}: the episode ended after {steps} of "
                             f"{T} steps ({outcome})")
    if not np.isfinite(np.asarray(tracker_.past_actions)).all():
        raise AssertionError(f"{name}: a non-finite action")
    if static_hits:
        raise AssertionError(f"{name}: the robot entered a static polygon")
    if not progress >= 0.1:
        raise AssertionError(f"{name}: the robot came {progress:.3f} m "
                             "nearer its goal along its route, under 0.1")
    if tracker == "mpc" and launches <= 0:
        raise AssertionError(f"{name} never launched spd_cholesky")
    if tracker == "dwa" and launches != 0:
        raise AssertionError(f"{name}: the DWA launched spd_cholesky")
    return launches


def deploy_node(device, predictor=None):
    """`NavigationNode(fused_step=build_step_program(...))` on a
    `LocalTransport`, scenario 0 at the shipped `SolverConfiguration()`;
    returns (node, transport, scenario)."""
    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.sim.batch import build_step_program
    from dyobav_tpu_torch.sim.deploy import LocalTransport, NavigationNode
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import build_scenario

    base = MainBase(max_run_time_step=3, evaluation=True, seed=0,
                    device=device)
    sc = build_scenario(base, scenario_index=0)
    fused = build_step_program(base.config_mpc, base.config_robot,
                               SolverConfiguration(), predictor=predictor,
                               device=device)
    transport = LocalTransport()
    node = NavigationNode(transport, fused_step=fused, scenario=sc,
                          n_humans=int(sc.human_starts.shape[0]),
                          device=device)
    return node, transport, sc


def deploy_ticks(nodes, sc, ticks):
    """Drive `nodes` ((node, transport) pairs) through the same drifting
    world as scripts/deploy_latency_torch.py: the pedestrian moves by
    uniform(-0.1, 0.1) + [0, 0.15] m before each tick but the first
    (`default_rng(0)`), and the robot follows the first node's action.
    Returns per node the (action, wall s, ref_idx) of each tick."""
    import torch

    from dyobav_tpu_torch.motion.models import unicycle_step_np

    rng = np.random.default_rng(0)
    state = np.asarray(sc.robot_start, float)
    humans = np.asarray(sc.human_starts, float)
    out = [[] for _ in nodes]
    for k in range(ticks):
        if k:
            humans = humans + rng.uniform(-0.1, 0.1, humans.shape) + [0.0,
                                                                      0.15]
        for (node, transport), rec in zip(nodes, out):
            transport.publish("actor_poses", {"poses": {
                f"a{i}": (p[0], p[1]) for i, p in enumerate(humans)}})
            transport.publish("robot_pose", {"x": state[0], "y": state[1],
                                             "theta": state[2]})
            t0 = time.perf_counter()
            a = node.control_tick()
            wall = time.perf_counter() - t0
            rec.append((np.asarray(a), wall, int(node.fused["ref_idx"])))
        state = unicycle_step_np(state, np.asarray(out[0][-1][0], float),
                                 0.2)
    torch.cuda.synchronize()
    return out


def deploy_reference_check(device):
    """Phase deploy_card_vs_cpu: the fused step program of scenario 0 with
    cvmp at the shipped budget, its cold start and DEPLOY_REF_TICKS ticks
    on the card against the port's own CPU run, fed the same messages."""
    card_node, card_tr, sc = deploy_node(device)
    cpu_node, cpu_tr, _ = deploy_node("cpu")
    card, cpu = deploy_ticks([(card_node, card_tr), (cpu_node, cpu_tr)], sc,
                             DEPLOY_REF_TICKS)
    dev_a = [float(np.abs(a - b).max()) for (a, _, _), (b, _, _)
             in zip(card, cpu)]
    flags = [[m["converged"] for m in tr.published["viz"]]
             for tr in (card_tr, cpu_tr)]
    idx = [[r for _, _, r in run] for run in (card, cpu)]
    print(json.dumps({
        "phase": "deploy_card_vs_cpu", "scenario": 0,
        "ticks": DEPLOY_REF_TICKS, "action_dev_per_tick": dev_a,
        "converged_card": flags[0], "converged_cpu": flags[1],
        "ref_idx_card": idx[0], "ref_idx_cpu": idx[1],
        "card_s_per_tick": [w for _, w, _ in card],
        "cpu_s_per_tick": [w for _, w, _ in cpu]}), flush=True)
    if not (max(dev_a) <= 1e-3 and flags[0] == flags[1]
            and idx[0] == idx[1]):
        raise AssertionError("card and CPU runs of the step program disagree")


def drive_deploy_path(device, name, ticks, predictor=None):
    """Path `name`: the deployment node on the card for `ticks` ticks (the
    first holds the cold start).  Fails on a non-finite action, a negative
    speed, a cmd_vel count other than the ticks, or other than two host
    syncs a tick (the node's one copy, the multistart's one sync).
    Returns (kernel 1's launches, the per-tick walls)."""
    from dyobav_tpu_torch.ops import engine, spd

    node, transport, sc = deploy_node(device, predictor)
    reset_counts()
    (run,) = deploy_ticks([(node, transport)], sc, ticks)
    launches = spd.spd_solve.launches
    syncs = engine.any_lane.syncs + engine.to_host.syncs
    actions = np.array([a for a, _, _ in run])
    walls = [w for _, w, _ in run]
    print(json.dumps({
        "main_path": name, "scenario": 0, "ticks": ticks,
        "ms_per_tick": [1e3 * w for w in walls],
        "host_copies_per_tick": syncs / ticks,
        "spd_launches": launches, "spd_launches_per_tick": launches / ticks,
        "converged_per_tick": [m["converged"]
                               for m in transport.published["viz"]],
        "cost_per_tick": [m["cost"] for m in transport.published["viz"]],
        "actions": actions.tolist()}), flush=True)
    if not (actions.shape == (ticks, 2) and np.isfinite(actions).all()):
        raise AssertionError(f"{name}: a non-finite or missing action")
    if (actions[:, 0] < 0).any():
        raise AssertionError(f"{name}: a negative speed")
    if len(transport.published["cmd_vel"]) != ticks:
        raise AssertionError(f"{name}: {len(transport.published['cmd_vel'])}"
                             f" cmd_vel messages for {ticks} ticks")
    if syncs != 2 * ticks:
        raise AssertionError(f"{name}: {syncs} host syncs in {ticks} ticks")
    if launches <= 0:
        raise AssertionError(f"{name} never launched spd_cholesky")
    return launches, walls


def deploy_paths(device) -> dict:
    """The deployment node: its card-vs-CPU check, then deploy[cvmp] and
    deploy[wta] (the strictly loaded net, the predictor timed with CUDA
    events); returns kernel 1's launches by path."""
    import torch

    from dyobav_tpu_torch.models.wta_net import load_checkpoint
    from dyobav_tpu_torch.ops import stem
    from dyobav_tpu_torch.sim.harness import MainBase

    deploy_reference_check(device)
    launches = {"deploy[cvmp]": drive_deploy_path(
        device, "deploy[cvmp]", DEPLOY_TICKS)[0]}
    base = MainBase(max_run_time_step=3, evaluation=True, seed=0,
                    device=device)
    net = load_checkpoint(os.path.join(ROOT, "Model",
                                       "wsd_1t20_full_torch.pt"), device)
    predict = make_wta(base, net, device)
    calls = []

    def timed_predict(hist):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = predict(hist)
        end.record()
        calls.append((start, end))
        return out

    stem0 = stem.stem_expand_pool.launches
    launches["deploy[wta]"], walls = drive_deploy_path(
        device, "deploy[wta]", DEPLOY_WTA_TICKS, timed_predict)
    # One call in the cold start, one a tick.
    ms = [s.elapsed_time(e) for s, e in calls]
    count_stem("deploy[wta]", len(ms), stem0)
    print(json.dumps({"phase": "deploy[wta] predictor",
                      "predictor_calls": len(ms),
                      "predictor_ms_per_call": ms,
                      "wall_ms_per_tick": [1e3 * w for w in walls]}),
          flush=True)
    if len(ms) != DEPLOY_WTA_TICKS + 1:
        raise AssertionError(f"deploy[wta]: {len(ms)} predictor calls")
    return launches


def harness_paths(device) -> dict:
    """Path 5 and its card-vs-CPU checks, then the deployment node (path
    8); returns kernel 1's launches by the MPC paths."""
    from dyobav_tpu_torch.configs import SolverConfiguration

    harness_reference_check(device)
    launches = {
        "harness[mpc+cvmp]": drive_harness_path(
            "mpc", "cvmp", SolverConfiguration(), HARNESS_STEPS, device),
        "harness[mpc+mmp]": drive_harness_path(
            "mpc", "mmp", SolverConfiguration(**MMP_BUDGET),
            HARNESS_MMP_STEPS, device)}
    drive_harness_path("dwa", "cvmp", None, HARNESS_DWA_MAX_STEPS, device,
                       whole=True)
    harness_dwa_reference_check(device)
    drive_harness_path("dwa", "kfmp", None, HARNESS_DWA_STEPS, device)
    drive_harness_path("dwa", "mmp", None, HARNESS_DWA_MMP_STEPS, device)
    launches["harness[mpc+kfmp]"] = drive_harness_path(
        "mpc", "kfmp", SolverConfiguration(), HARNESS_KFMP_STEPS, device)
    launches.update(deploy_paths(device))
    return launches


def panoc_reference_check(cfg, robot, Z, U0, device):
    """The PANOC solve on the card against the port's CPU run on the first
    PANOC_REF_BATCH problems, at a 5-iteration budget: over longer budgets
    float32 PANOC parts at knife-edge accept tests between any two
    summation orders (tests/test_torch_panoc.py)."""
    import torch

    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    n = PANOC_REF_BATCH
    scfg = SolverConfiguration(**PANOC_REF_BUDGET)
    out = {}
    for dev in (device, "cpu"):
        sol = build_mpc_solver(cfg, robot, scfg, method="panoc",
                               device=dev).solve_batch(Z[:n], U0[:n])
        out[dev] = (sol.u.cpu().numpy(), sol.exit_ok.cpu().numpy())
    (ug, eg), (uc, ec) = out[device], out["cpu"]
    du = float(np.abs(ug - uc).max())
    print(json.dumps({"phase": "panoc_card_vs_cpu", "batch": n,
                      "budget": PANOC_REF_BUDGET, "u_dev_max": du,
                      "exit_ok_equal": bool((eg == ec).all())}), flush=True)
    if not (du <= 1e-3 and (eg == ec).all()):
        raise AssertionError("card and CPU runs of PANOC disagree")


def drive_panoc_path(device) -> int:
    """Path 6: `solve_batch_escalated` of the PANOC method on the B=2048
    step-0 problems, once.  Returns kernel 1's launches on it (0)."""
    import torch

    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration,
                                          SolverConfiguration)
    from dyobav_tpu_torch.ops import costs, engine, spd
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    cfg, robot = MpcConfiguration(), CircularRobotSpecification()
    make_Z, states, u_prev, U0 = make_problems(cfg, BATCH)
    Z = make_Z(states, u_prev, 0)
    panoc_reference_check(cfg, robot, Z, U0, device)
    scfg = SolverConfiguration(**PANOC_BUDGET)
    bundle = build_mpc_solver(cfg, robot, scfg, method="panoc")
    reset_counts()
    t0 = time.perf_counter()
    sol = bundle.solve_batch_escalated(Z, U0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spd.spd_solve.launches
    syncs = engine.any_lane.syncs + engine.to_host.syncs
    u_lo, u_hi = costs.action_bounds(cfg, robot, device=device)
    excess = float(torch.maximum(u_lo - sol.u, sol.u - u_hi).max())
    infeas = sol.infeasibility.cpu().numpy()
    print(json.dumps({
        "main_path": "solve_batch_escalated[panoc]", "batch": BATCH,
        "budget": PANOC_BUDGET, "wall_s": wall,
        "exit_ok": float(sol.exit_ok.float().mean()),
        "infeas_p95": float(np.percentile(infeas, 95)),
        "residual_p50": float(sol.residual.median()),
        "host_syncs": syncs, "spd_launches": launches,
        "bound_excess_max": excess}), flush=True)
    for name, val in (("u", sol.u), ("cost", sol.cost),
                      ("pred_states", sol.pred_states)):
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"PANOC path: non-finite {name}")
    if tuple(sol.u.shape) != (BATCH, cfg.nu * cfg.N_hor):
        raise AssertionError(f"PANOC path: u of shape {tuple(sol.u.shape)}")
    if excess > 1e-5:
        raise AssertionError(f"PANOC path: a bound violated by {excess}")
    if launches != 0:
        raise AssertionError("PANOC path launched spd_cholesky")
    return launches


def fleet_reference_check(device):
    """Phase fleet_card_vs_cpu: tests/test_fleet.py's head-on corridor at
    lateral offsets 0.2 and 0.35 (B=2, two robots, no pedestrian) at the
    shipped budget for FLEET_REF_STEPS steps, on the card against the
    port's own CPU run."""
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration,
                                          SolverConfiguration)
    from dyobav_tpu_torch.sim.fleet import (FleetResult, FleetScenario,
                                            build_fleet_sim)
    from dyobav_tpu_torch.sim.scenarios import synthetic_fleet_scenario

    cfg, robot = MpcConfiguration(), CircularRobotSpecification()
    batch = FleetScenario(*[np.stack(x) for x in zip(*[
        synthetic_fleet_scenario([[0.0, lat, 0.0], [8.0, -lat, np.pi]],
                                 [[8.0, lat], [0.0, -lat]],
                                 base_speed=robot.lin_vel_max * 0.8,
                                 ts=cfg.ts) for lat in (0.2, 0.35)])])
    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        res = build_fleet_sim(cfg, robot, SolverConfiguration(), n_robots=2,
                              n_steps=FLEET_REF_STEPS, device=dev)(
            batch, np.arange(2))
        out[dev] = ({f: getattr(res, f).cpu().numpy()
                     for f in FleetResult._fields},
                    time.perf_counter() - t0)
    (rg, tg), (rc, tc) = out[device], out["cpu"]
    dev_m = np.abs(rg["final_states"][..., :2]
                   - rc["final_states"][..., :2]).max(axis=-1)   # (B, R)
    inter_dev = float(np.abs(rg["min_inter_robot"]
                             - rc["min_inter_robot"]).max())
    flags = ("success", "done", "collided", "steps_used", "solver_fail_steps",
             "escalation_overflow_steps")
    flags_equal = all(np.array_equal(rg[f], rc[f]) for f in flags)
    print(json.dumps({
        "phase": "fleet_card_vs_cpu", "batch": 2, "robots": 2,
        "steps": FLEET_REF_STEPS, "final_dev_m": dev_m.tolist(),
        "min_inter_robot_dev": inter_dev, "flags_equal": flags_equal,
        "solver_fail_steps": rg["solver_fail_steps"].tolist(),
        "card_s": tg, "cpu_s": tc}), flush=True)
    # The two runs share every operation but the SPD kernel (bit for bit
    # its plain version) and the libraries' rounding.
    if not (dev_m.max() <= 1e-3 and inter_dev <= 1e-3 and flags_equal):
        raise AssertionError("card and CPU runs of the fleet disagree")


def drive_fleet_path(name, base, B, T, device, predictor=None) -> int:
    """Path `name`: `build_fleet_sim` over `random_fleet_scenarios(base, B,
    n_robots=FLEET_ROBOTS, n_humans=1, seed=0)` for T steps at the shipped
    budget.  Returns kernel 1's launches on it."""
    import torch

    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import engine, spd, stem
    from dyobav_tpu_torch.sim.batch import point_in_any_quad
    from dyobav_tpu_torch.sim.fleet import FleetResult, build_fleet_sim
    from dyobav_tpu_torch.sim.scenarios import random_fleet_scenarios

    R = FLEET_ROBOTS
    batch = random_fleet_scenarios(base, B, n_robots=R, n_humans=1, seed=0)
    calls = []

    def timed_predict(hist):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = predictor(hist)
        end.record()
        calls.append((start, end))
        return out

    run = build_fleet_sim(base.config_mpc, base.config_robot,
                          SolverConfiguration(), n_robots=R, n_steps=T,
                          multistart=True, device=device,
                          predictor=timed_predict if predictor else None)
    reset_counts()
    stem0 = stem.stem_expand_pool.launches
    t0 = time.perf_counter()
    res = run(batch, np.arange(B))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = spd.spd_solve.launches
    syncs = engine.any_lane.syncs + engine.to_host.syncs
    if predictor:
        count_stem(name, len(calls), stem0)

    r = {f: getattr(res, f).cpu().numpy() for f in FleetResult._fields}
    pos = r["final_states"][..., :2]                             # (B, R, 2)
    inside = point_in_any_quad(
        torch.as_tensor(pos.reshape(-1, 2)),
        torch.as_tensor(batch.all_polys).repeat_interleave(R, 0)
    ).numpy().reshape(B, R)
    # Robot-robot collisions: a collided robot parks where it collided, as
    # does the robot it hit, inside the other's disk.
    gap = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    gap[:, np.arange(R), np.arange(R)] = np.inf
    robot_robot = r["collided"] & (gap.min(axis=2)
                                   <= 0.5 * base.config_robot.vehicle_width)
    goal = batch.goals[..., :2]
    d_start = np.linalg.norm(batch.robot_starts[..., :2] - goal, axis=-1)
    d_ref = np.linalg.norm(batch.ref_trajs[:, :, T - 1, :2] - goal, axis=-1)
    d_final = np.linalg.norm(pos - goal, axis=-1)
    approaching = ~r["collided"] & (d_ref < d_start - 0.1)
    nearer = (d_final < d_start - 0.1)[approaching]
    fail_per_step = float(r["solver_fail_steps"].mean()) / T
    print(json.dumps({
        "main_path": name, "scenarios": B, "robots": R, "steps": T,
        "solve_lanes": B * R, "sim_s": sim_s, "s_per_step": sim_s / T,
        "control_steps_per_s": B * R * T / sim_s,
        "solver_fail_steps_per_robot": float(r["solver_fail_steps"].mean()),
        "escalation_overflow_steps_per_robot": float(
            r["escalation_overflow_steps"].mean()),
        "spd_launches": launches, "spd_launches_per_step": launches / T,
        "host_syncs_per_step": syncs / T,
        "min_inter_robot_min": float(r["min_inter_robot"].min()),
        "min_inter_robot_median": float(np.median(r["min_inter_robot"])),
        "collided": int(r["collided"].sum()),
        "robot_robot_collided": int(robot_robot.sum()),
        "inside_static": int(inside.sum()), "done": int(r["done"].sum()),
        "robots_route_approaches_goal": int(approaching.sum()),
        "nearer_goal_share": float(nearer.mean()) if nearer.size else None,
        "min_clearance_min": float(r["min_clearance"].min()),
        "min_static_clearance_min": float(r["min_static_clearance"].min()),
        "predictor_ms_per_call": [a.elapsed_time(b) for a, b in calls]}),
        flush=True)
    if predictor and len(calls) != T + 1:    # every step and the pre-solve
        raise AssertionError(f"{name}: {len(calls)} predictor calls")
    # With several robots, a pedestrian and the map's polygons, every
    # distance is finite too.
    for f, val in r.items():
        if val.shape[0] != B or (val.ndim > 1 and val.shape[1] != R):
            raise AssertionError(f"{name}: {f} has shape {val.shape}")
        if val.dtype.kind == "f" and not np.isfinite(val).all():
            raise AssertionError(f"{name}: non-finite {f}")
    if inside.mean() > 0.02:
        raise AssertionError(f"{name}: more than 2 % of the robots ended "
                             "inside a static polygon")
    if fail_per_step > 0.5:
        raise AssertionError(f"{name}: {fail_per_step:.3f} non-converged "
                             "solves per robot and step")
    if syncs != T:
        raise AssertionError(f"{name}: {syncs} host syncs in {T} steps")
    if launches <= 0:
        raise AssertionError(f"{name} never launched spd_cholesky")
    if not nearer.size or nearer.mean() < 0.9:
        raise AssertionError(f"{name}: {nearer.mean() if nearer.size else 0}"
                             " of the robots whose reference approaches the "
                             "goal got 0.1 m nearer it, under 0.9")
    return launches


def fleet_paths(device) -> dict:
    """Path 9: the fleet's card-vs-CPU check, then `build_fleet_sim` and
    `build_fleet_sim[wta]`; returns kernel 1's launches by path."""
    from dyobav_tpu_torch.models.wta_net import load_checkpoint
    from dyobav_tpu_torch.sim.harness import MainBase

    fleet_reference_check(device)
    base = MainBase(max_run_time_step=FLEET_STEPS, evaluation=True, seed=0)
    n_obs = len(base.geo_map.processed_obstacle_list)
    if n_obs != 55:
        raise AssertionError(f"fleet: {n_obs} obstacles, expected 55")
    launches = {"build_fleet_sim": drive_fleet_path(
        "build_fleet_sim", base, FLEET_BATCH, FLEET_STEPS, device)}
    net = load_checkpoint(os.path.join(ROOT, "Model",
                                       "wsd_1t20_full_torch.pt"), device)
    launches["build_fleet_sim[wta]"] = drive_fleet_path(
        "build_fleet_sim[wta]", base, FLEET_WTA_BATCH, FLEET_WTA_STEPS,
        device, predictor=make_wta(base, net, device))
    return launches


def solver_paths(device) -> dict:
    """Path 6, then path 7 (the solver modes, whose CPU references would
    lengthen the main process, the longest), then path 9 (the fleet);
    returns kernel 1's launches by the paths that launch it."""
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration)

    drive_panoc_path(device)
    launches = drive_mode_paths(MpcConfiguration(),
                                CircularRobotSpecification(), device)
    launches.update(fleet_paths(device))
    return launches


def train_card_vs_cpu(dh, ref_map, device):
    """One `_train_step_fused` at full width from one seeded init on the
    card and on the CPU (TF32 off), in float32 and in float64: loss,
    gradients, BatchNorm statistics.  At this size float32 gradients are
    ill-conditioned (a loss of ~1e4 on labels hundreds of pixels from a
    fresh net, sums through 37 BatchNorm layers, a map channel in 0-255):
    each device's float32 is 1e-3 to 1e-2 in relative L2 from float64, so
    float32 is held within TRAIN_GRAD_RL2 and float64 within 1e-6 (losses
    1e-4 and 1e-10, statistics 1e-5 and 1e-8)."""
    import torch

    from dyobav_tpu_torch.configs import WtaNetConfiguration
    from dyobav_tpu_torch.models.manager import NetworkManager

    batch = dh.next_batch()

    def step(dev, dtype):
        mgr = NetworkManager(WtaNetConfiguration(), seed=0, verbose=False,
                             device=dev)
        mgr.build_network()
        mgr.net.to(dtype)
        t0 = time.perf_counter()
        loss = mgr._train_step_fused(batch["traj"], batch["offset"],
                                     batch["label"], ref_map, 1).item()
        return (loss, time.perf_counter() - t0,
                {k: p.grad.cpu().double()
                 for k, p in mgr.net.named_parameters()},
                {k: v.cpu().double() for k, v in mgr.net.state_dict().items()
                 if "running" in k})

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    runs = {(dev, dt): step(dev, dt) for dev in (device, "cpu")
            for dt in (torch.float32, torch.float64)}
    line = {"phase": "train_card_vs_cpu", "images": TRAIN_REF_BATCH}
    gaps = {}
    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        card, cpu = runs[(device, dt)], runs[("cpu", dt)]
        grad = {k: rel(card[2][k], cpu[2][k]) for k in cpu[2]}
        worst = max(grad, key=grad.get)
        gaps[name] = (abs(card[0] - cpu[0]) / abs(cpu[0]), grad[worst],
                      max(rel(card[3][k], cpu[3][k]) for k in cpu[3]))
        line.update({
            f"{name}_loss_card": card[0], f"{name}_loss_cpu": cpu[0],
            f"{name}_loss_rel": gaps[name][0],
            f"{name}_grad_rel_l2_max": grad[worst],
            f"{name}_grad_rel_l2_max_param": worst,
            f"{name}_grad_rel_l2_median": float(np.median(list(
                grad.values()))),
            f"{name}_batch_stats_rel_l2_max": gaps[name][2],
            f"{name}_card_s": card[1], f"{name}_cpu_s": cpu[1]})
    ref = runs[("cpu", torch.float64)][2]
    for dev in (device, "cpu"):
        g = runs[(dev, torch.float32)][2]
        line[f"f32_{'card' if dev == device else 'cpu'}_vs_f64_grad_max"] = \
            max(rel(g[k], ref[k]) for k in ref)
    print(json.dumps(line), flush=True)
    loss32, grad32, stats32 = gaps["f32"]
    loss64, grad64, stats64 = gaps["f64"]
    if not (np.isfinite(line["f32_loss_card"]) and loss32 <= 1e-4
            and loss64 <= 1e-10):
        raise AssertionError(f"train: card and CPU losses part: {gaps}")
    if grad32 > TRAIN_GRAD_RL2 or grad64 > 1e-6:
        raise AssertionError(f"train: card and CPU gradients part: {gaps}")
    if stats32 > 1e-5 or stats64 > 1e-8:
        raise AssertionError(f"train: BatchNorm statistics part: {gaps}")


def timed_steps(mgr, batches, ref_map, k_top=1) -> tuple[float, list]:
    """Mean ms a `_train_step_fused` (CUDA events) over the last
    TRAIN_TIMED of `batches` (trajectories, offsets, labels), staged on the
    device first as the device loop stages them, after TRAIN_WARMUP; and
    every step's loss."""
    import torch

    ref = torch.as_tensor(ref_map, device=mgr.device)
    staged = [tuple(torch.as_tensor(a, device=mgr.device) for a in b)
              for b in batches]
    losses = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i, (t, o, y) in enumerate(staged):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            start.record()
        losses.append(mgr._train_step_fused(t, o, y, ref, k_top))
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / (len(staged) - TRAIN_WARMUP),
            [float(v) for v in torch.stack(losses).cpu()])


def drive_train_path(data, tmp, dh, ref_map, device):
    """`train[wta]`: the CLI at batch 20 on the card, the device loop and
    the host loop, then its checkpoint; and a timed window of steps."""
    import torch

    from dyobav_tpu_torch.configs import WtaNetConfiguration
    from dyobav_tpu_torch.models import train
    from dyobav_tpu_torch.models.manager import NetworkManager
    from dyobav_tpu_torch.models.wta_net import full_f32, load_checkpoint
    from dyobav_tpu_torch.ops import engine, spd
    from dyobav_tpu_torch.sim.harness import MainBase

    out = os.path.join(tmp, "wsd_smoke")
    argv = ["--data", data, "--out", out, "--batch-size", str(TRAIN_BATCH),
            "--epochs", str(TRAIN_EPOCHS), "--chunk-steps", str(TRAIN_CHUNK)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, syncs = spd.spd_solve.launches, engine.to_host.syncs
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(out + "_profile.json") as f:
        prof = json.load(f)
    n_train = len(dh.train_idx)
    chunks = n_train // TRAIN_BATCH // TRAIN_CHUNK
    loss, val = np.array(prof["loss"]), np.array(prof["val_loss"])
    reset_counts()
    t0 = time.perf_counter()
    train.main(["--data", data, "--out", out + "_host", "--batch-size",
                str(TRAIN_BATCH), "--epochs", "2", "--device-loop", "0",
                "--steps-per-epoch", str(TRAIN_HOST_STEPS), "--val-every",
                "5", "--recalibrate-bn", "0"])
    host_wall = time.perf_counter() - t0
    host_launches, host_syncs = spd.spd_solve.launches, engine.to_host.syncs
    with open(out + "_host_profile.json") as f:
        host_loss = np.array(json.load(f)["loss"])

    # The written checkpoint: strictly loaded, the manager's hypotheses,
    # one predictor call.
    net = load_checkpoint(out + ".pt", device)
    mgr = NetworkManager(WtaNetConfiguration(), verbose=False, device=device)
    mgr.load_checkpoint(out + ".pt")
    b = dh.next_batch()
    images = mgr._images(b["traj"], b["offset"], ref_map)
    with torch.no_grad(), full_f32():
        hyp_net = net(images).cpu().numpy()
    hyp_mgr = mgr.inference(images)
    ckpt_dev = float(np.abs(hyp_net - hyp_mgr).max())
    base = MainBase(max_run_time_step=3, evaluation=True, seed=0,
                    device=device)
    hist = torch.tensor([[[[-2.0 + 0.2 * i, -5.0]] for i in range(5)]],
                        device=device)
    mu, std, alpha = make_wta(base, net, device)(hist)
    pred_ok = bool(torch.isfinite(mu).all() and torch.isfinite(std).all()
                   and torch.isfinite(alpha).all())

    # A timed window of the device loop's step at batch 20.
    mgr = NetworkManager(WtaNetConfiguration(), verbose=False, device=device)
    mgr.build_network()
    staged = [dh.next_batch() for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    ms, _ = timed_steps(mgr, [(x["traj"], x["offset"], x["label"])
                              for x in staged], ref_map)
    gflop = conv_net_flops(mgr.net, (7,) + tuple(ref_map.shape)) / 1e9
    print(json.dumps({
        "main_path": "train[wta]", "batch": TRAIN_BATCH,
        "epochs": TRAIN_EPOCHS, "train_samples": n_train,
        "steps": chunks * TRAIN_CHUNK * TRAIN_EPOCHS, "chunks": len(loss),
        "cli_wall_s": wall, "ms_per_step": ms,
        "samples_per_s": TRAIN_BATCH / ms * 1e3,
        "forward_gflop_per_image": gflop,
        "tflop_per_s": 3 * gflop * TRAIN_BATCH / ms,      # GFLOP/ms
        "peak_device_gb": peak_gb,
        "host_syncs_per_chunk": (syncs - TRAIN_EPOCHS) / len(loss),
        "loss_first20_mean": float(loss[0]),
        "loss_last20_mean": float(loss[-1]),
        "loss_epoch1_last20_mean": float(loss[chunks - 1]),
        "val_loss": val.tolist(), "spd_launches": launches,
        "host_loop_wall_s": host_wall, "host_loop_steps": len(host_loss),
        "host_loop_syncs": host_syncs, "host_loop_loss": host_loss.tolist(),
        "checkpoint_vs_manager_max_dev_px": ckpt_dev,
        "predictor_ok": pred_ok}), flush=True)
    if not (np.isfinite(loss).all() and np.isfinite(host_loss).all()
            and np.isfinite(val).all()):
        raise AssertionError("train[wta]: a non-finite loss")
    if len(loss) != chunks * TRAIN_EPOCHS or len(host_loss) != 2 * \
            TRAIN_HOST_STEPS:
        raise AssertionError(f"train[wta]: {len(loss)} chunk losses, "
                             f"{len(host_loss)} host-loop losses")
    if not (loss[-1] < loss[0] and loss[chunks - 1] < loss[0]):
        raise AssertionError("train[wta]: the last 20 steps' mean loss is "
                             "not below the first 20's")
    if syncs != len(loss) + TRAIN_EPOCHS:      # a chunk each + validation
        raise AssertionError(f"train[wta]: {syncs} host syncs for "
                             f"{len(loss)} chunks")
    if launches or host_launches:
        raise AssertionError("train[wta] launched spd_cholesky")
    if not (ckpt_dev <= 1e-5 and pred_ok):
        raise AssertionError(f"train[wta]: the checkpoint's net is "
                             f"{ckpt_dev} px from the manager's, or the "
                             "predictor gave a non-finite field")


def drive_train_mdn_path(kind, dh, ref_map, device):
    """`train[mdn]` / `train[mdnfit]`: a timed window of full-width steps
    at batch 20 on the synthetic images, with standard-normal labels (those
    of tests/test_models.py's MDN tests)."""
    from dyobav_tpu_torch.configs import WtaNetConfiguration
    from dyobav_tpu_torch.models import losses
    from dyobav_tpu_torch.models import mdn
    from dyobav_tpu_torch.models.manager import NetworkManager

    net, loss = {"mdn": (mdn.ConvMixtureDensityNet(), losses.mdn_nll_loss),
                 "mdnfit": (mdn.ConvMultiHypoMixtureDensityFit(),
                            losses.smdn_nll_loss)}[kind]
    mgr = NetworkManager(WtaNetConfiguration(), net=net, loss=loss,
                         verbose=False, device=device)
    mgr.build_network()
    rng = np.random.default_rng(1)
    staged = [dh.next_batch() for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    ms, vals = timed_steps(mgr, [
        (x["traj"], x["offset"],
         rng.normal(size=(TRAIN_BATCH, 2)).astype(np.float32))
        for x in staged], ref_map)
    gflop = conv_net_flops(mgr.net, (7,) + tuple(ref_map.shape)) / 1e9
    print(json.dumps({
        "main_path": f"train[{kind}]", "batch": TRAIN_BATCH,
        "steps": len(vals), "ms_per_step": ms,
        "samples_per_s": TRAIN_BATCH / ms * 1e3,
        "tflop_per_s": 3 * gflop * TRAIN_BATCH / ms,      # GFLOP/ms
        "loss_first": vals[0], "loss_last": vals[-1]}), flush=True)
    if not np.isfinite(vals).all():
        raise AssertionError(f"train[{kind}]: a non-finite loss")


def train_paths(device) -> dict:
    """Path 10: the training stack on a synthetic WSD dataset; launches no
    kernel (returns no launch counts)."""
    import shutil
    import tempfile

    import torch

    from dyobav_tpu_torch.models.data import (DataHandler, WsdDataset,
                                              write_synthetic_wsd)

    torch.set_num_threads(2)        # the CPU runs of train_card_vs_cpu
    tmp = tempfile.mkdtemp(prefix="wsd_smoke_")
    try:
        data = write_synthetic_wsd(
            os.path.join(tmp, "data"),
            os.path.join(ROOT, "data", "warehouse_sim_original", "label.png"),
            **TRAIN_SYNTH)
        ds = WsdDataset(data)
        ref_map = ds.ref_map(ds.samples[0].video)
        train_card_vs_cpu(DataHandler(ds, batch_size=TRAIN_REF_BATCH, seed=3),
                          ref_map, device)
        dh = DataHandler(ds, batch_size=TRAIN_BATCH, seed=0)
        drive_train_path(data, tmp, dh, ref_map, device)
        for kind in ("mdn", "mdnfit"):
            drive_train_mdn_path(kind, dh, ref_map, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {}


def sweep_quality(out: dict) -> dict:
    """The sweep JSON's keys that must not depend on how the batch is
    split: all but the device and host counts and the timings."""
    return {k: v for k, v in out.items() if k not in (
        "devices", "hosts", "wall_s_first", "wall_s_steady",
        "control_steps_per_s")}


def run_sweep(argv) -> tuple[dict, float, int]:
    """`python -m dyobav_tpu_torch.sim.sweep` through `main(argv)`: (its
    JSON, wall s, kernel-1 launches)."""
    import contextlib
    import io

    from dyobav_tpu_torch.ops import spd
    from dyobav_tpu_torch.sim import sweep

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sweep.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"sweep {argv} exited {rc}")
    return (json.loads(buf.getvalue().strip().splitlines()[-1]), wall,
            spd.spd_solve.launches)


def shard_map_check(device) -> tuple[int, int]:
    """`shard_map_batch` of `build_batch_sim`'s run over [cuda:0, cuda:0]
    against the unsharded run at SHARD_BATCH scenarios for SHARD_STEPS
    steps (the shipped budget, the global seeds): robot positions within
    1e-4 m at every step, flags and counts equal.  Returns kernel 1's
    launches on the unsharded and the sharded runs."""
    import torch

    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import spd
    from dyobav_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                                shard_map_batch)
    from dyobav_tpu_torch.sim.batch import BatchResult, build_batch_sim
    from dyobav_tpu_torch.sim.harness import MainBase
    from dyobav_tpu_torch.sim.scenarios import random_scenarios

    B, T = SHARD_BATCH, SHARD_STEPS
    base = MainBase(max_run_time_step=T, evaluation=True, seed=0)
    batch = random_scenarios(base, B, seed=0)
    run = build_batch_sim(base.config_mpc, base.config_robot,
                          SolverConfiguration(), n_steps=T, record_traj=True,
                          device=device)

    def lanes_first(sc, seeds):
        res, (traj, _) = run(sc, seeds)
        return res, traj.transpose(0, 1)

    out, launches, walls = [], [], []
    mesh = make_mesh(devices=[device, device])
    for sharded in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        if sharded:
            out.append(shard_map_batch(lanes_first, mesh)(
                shard_batch(mesh, batch), shard_batch(mesh, np.arange(B))))
        else:
            out.append(lanes_first(batch, np.arange(B)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(spd.spd_solve.launches)
    (one, traj1), (two, traj2) = out
    dev = float((traj2 - traj1)[..., :2].abs().max())
    print(json.dumps({
        "main_path": "shard_map_batch[cuda:0 x 2]", "scenarios": B,
        "steps": T, "wall_s_unsharded": walls[0], "wall_s_sharded": walls[1],
        "spd_launches_unsharded": launches[0],
        "spd_launches_sharded": launches[1],
        "robot_dev_max_m": dev}), flush=True)
    if traj2.shape != (B, T, 3) or not torch.isfinite(traj2).all():
        raise AssertionError("shard_map_batch: a bad robot trajectory")
    if dev > 1e-4:
        raise AssertionError(f"shard_map_batch: robots {dev:.3e} m from "
                             "the unsharded run")
    for f in BatchResult._fields:
        a, b = getattr(one, f), getattr(two, f)
        if not a.is_floating_point() and not torch.equal(a, b):
            raise AssertionError(f"shard_map_batch: {f} differs from the "
                                 "unsharded run")
    if min(launches) <= 0:
        raise AssertionError("shard_map_batch never launched spd_cholesky")
    return launches[0], launches[1]


def sweep_paths(device) -> dict:
    """`sweep[devices]`: `sim.sweep` with `--devices 1` and `--devices 0`
    (one unsharded batch both): the same statistics; `shard_map_check`;
    a one-process `--distributed` run (NCCL, world size 1, a port the
    system chose) whose statistics are `--devices 1`'s (counts equal, the
    means, which it sums in float64, within 1e-5).  Returns kernel 1's
    launches by run."""
    import socket

    import torch

    one, wall1, n1 = run_sweep(SWEEP_ARGS + ["--devices", "1"])
    every, wall0, n0 = run_sweep(SWEEP_ARGS + ["--devices", "0"])
    n_unsharded, n_sharded = shard_map_check(device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        dist, wall_d, n_d = run_sweep(SWEEP_ARGS + ["--distributed"])
    finally:
        for key in env:
            os.environ.pop(key)
    print(json.dumps({
        "main_path": "sweep[devices]", "args": SWEEP_ARGS,
        "devices_1": one, "devices_0": every, "distributed": dist,
        "wall_s": {"devices_1": wall1, "devices_0": wall0,
                   "distributed": wall_d},
        "spd_launches": {"devices_1": n1, "devices_0": n0,
                         "distributed": n_d},
        "cuda_devices": torch.cuda.device_count()}), flush=True)
    if one["devices"] != 1 or every["devices"] != 1:
        raise AssertionError(f"sweep[devices]: devices {one['devices']} "
                             f"and {every['devices']}")
    if sweep_quality(every) != sweep_quality(one):
        raise AssertionError("sweep[devices]: --devices 0 and --devices 1 "
                             "disagree")
    if dist["hosts"] != 1 or dist["devices"] != 1:
        raise AssertionError(f"sweep[distributed]: {dist}")
    for key in ("n_scenarios", "robots", "success_rate", "collision_rate",
                "solver_fail_steps_mean", "steps_used_mean",
                "deviation_max"):
        if dist[key] != one[key]:
            raise AssertionError(f"sweep[distributed]: {key} {dist[key]} "
                                 f"against {one[key]}")
    for key in ("min_clearance_mean", "min_static_clearance_mean",
                "deviation_mean", "smoothness_mean"):
        gap = np.abs(np.subtract(dist[key], one[key])).max()
        if gap > 1e-5 * max(1.0, np.abs(one[key]).max()):
            raise AssertionError(f"sweep[distributed]: {key} {dist[key]} "
                                 f"against {one[key]}")
    if not all(np.isfinite(v) for v in (one["deviation_mean"],
                                        one["min_static_clearance_mean"])):
        raise AssertionError(f"sweep[devices]: non-finite statistics {one}")
    if min(n1, n0, n_d) <= 0:
        raise AssertionError("sweep[devices] never launched spd_cholesky")
    return {"sweep[devices=1]": n1, "sweep[devices=0]": n0,
            "shard_map_batch[unsharded]": n_unsharded,
            "shard_map_batch[cuda:0 x 2]": n_sharded,
            "sweep[distributed]": n_d}


def train_sweep_paths(device) -> dict:
    """Path 10, then path 11 (`sweep_paths`) in the same process."""
    train_paths(device)
    return sweep_paths(device)


CHILD_PHASES = {"harness": harness_paths, "solvers": solver_paths,
                "train": train_sweep_paths}


def child_main(results, name: str, device: str) -> None:
    """Body of a process that drives CHILD_PHASES[name] on `device` beside
    the other paths (each step of the harness solves one robot and PANOC
    iterates eagerly, so the host, not the card, sets their time): puts
    (name, "ok", result) or (name, "error", traceback) on `results`."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        spd_launches = CHILD_PHASES[name](torch.device(device))
        results.put((name, "ok", (spd_launches, dict(STEM_LAUNCHES))))
    except BaseException:
        results.put((name, "error", traceback.format_exc()))
        raise


def drive_mode_paths(cfg, robot, device) -> dict:
    """Path 7: `solve_batch_escalated` in each off-default solver mode
    (MODES) on path 1's first MODE_BATCH step-0 problems at MODE_BUDGET,
    on the card against the port's CPU run: u within 1e-3 and the flags
    equal on at least 3/4 of the lanes.  Schulz must launch no kernel, the
    others kernel 1.  Returns kernel 1's launches by the modes that launch
    it."""
    import torch

    from dyobav_tpu_torch.configs import SolverConfiguration
    from dyobav_tpu_torch.ops import spd
    from dyobav_tpu_torch.ops.engine import build_mpc_solver

    make_Z, states, u_prev, U0 = make_problems(cfg, BATCH)
    Z, U = make_Z(states, u_prev, 0)[:MODE_BATCH], U0[:MODE_BATCH]
    launches = {}
    for name, change in MODES:
        scfg = SolverConfiguration(**MODE_BUDGET, **change)
        bundle = build_mpc_solver(cfg, robot, scfg, device=device)
        reset_counts()
        t0 = time.perf_counter()
        card = bundle.solve_batch_escalated(Z, U)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = spd.spd_solve.launches
        t0 = time.perf_counter()
        cpu = build_mpc_solver(cfg, robot, scfg, device="cpu"
                               ).solve_batch_escalated(Z, U)
        cpu_s = time.perf_counter() - t0
        uc, ec = card.u.cpu().numpy(), card.exit_ok.cpu().numpy()
        du = np.abs(uc - cpu.u.numpy()).max(axis=1)
        agree = (du <= 1e-3) & (ec == cpu.exit_ok.numpy())
        print(json.dumps({
            "main_path": f"solve_batch_escalated[{name}]",
            "batch": MODE_BATCH, "option": change, "wall_s": wall,
            "cpu_s": cpu_s, "spd_launches": n,
            "exit_ok_card": float(ec.mean()),
            "exit_ok_cpu": float(cpu.exit_ok.float().mean()),
            "lanes_agree": float(agree.mean()),
            "u_dev_max": float(du.max())}), flush=True)
        if not np.isfinite(uc).all():
            raise AssertionError(f"mode {name}: a non-finite u")
        if agree.mean() < 0.75:
            raise AssertionError(f"mode {name}: card and CPU agree on "
                                 f"{agree.mean():.3f} of the lanes")
        if name == "schulz":
            if n != 0:
                raise AssertionError("the Schulz solve launched "
                                     "spd_cholesky")
        elif n <= 0:
            raise AssertionError(f"mode {name} never launched spd_cholesky")
        else:
            launches[f"solve_batch_escalated[{name}]"] = n
    return launches


def drive_paths(device):
    """Paths 1-4 and their checks; returns kernel 1's launches by path and
    kernel 2's launches."""
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration,
                                          SolverConfiguration)
    from dyobav_tpu_torch.sim.harness import MainBase

    cfg, robot, scfg = (MpcConfiguration(), CircularRobotSpecification(),
                        SolverConfiguration())
    launches = {"solve_batch_escalated": drive_solve_path(cfg, robot, scfg,
                                                          device),
                "build_batch_sim": drive_sim_path(cfg, robot, scfg)}
    sim_reference_check(cfg, robot, scfg)
    lanes_launches = drive_lanes_path(device)
    base = MainBase(max_run_time_step=WTA_STEPS, evaluation=True, seed=0)
    net = wta_net_check(base, device)
    launches["build_batch_sim[wta]"] = drive_wta_sim_path(
        cfg, robot, scfg, base, net, device)
    wta_sim_reference_check(cfg, robot, scfg, base, net, device)
    return launches, lanes_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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
    # Build the kernels from the checkout's sources, one nvcc each, all
    # started together.
    names = ("spd_cholesky", "spd_lanes", "stem_expand_pool")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
    for name, res in zip(names, builds):
        usage = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {name}: {res.seconds:.2f} s nvcc "
              f"({'built' if res.log else 'reused'} {res.path.name}); "
              + " | ".join(usage), flush=True)

    # Each kernel against its plain version at the shapes the paths give
    # it: the solve's warm stage (B, 4 rungs) and escalation stage (K
    # slots, 4 rungs); each batched sim's three stages (`sim_kernel_shapes`)
    # at SIM_BATCH and WTA_BATCH lanes; the harness's and the deployment
    # tick's one robot (5 candidates, 4 rungs) and the deployment's cold
    # start (one lane); the fleets' stages at their scenarios x robots
    # lanes, all among the others' (the dict keeps each shape once, in
    # order); sweep[devices]'s 8 lanes and its two shards' 4 each; the
    # second kernel at the solve's 8192 systems, at its docstring's 512
    # and at a ragged 200.
    K = max(BATCH // 16, min(BATCH, 16), 1)
    shapes = ([(BATCH, 4), (K, 4)] + sim_kernel_shapes(SIM_BATCH)
              + sim_kernel_shapes(WTA_BATCH) + [(5, 4), (1, 4)]
              + sim_kernel_shapes(FLEET_BATCH * FLEET_ROBOTS)
              + sim_kernel_shapes(FLEET_WTA_BATCH * FLEET_ROBOTS)
              + sim_kernel_shapes(SHARD_BATCH)
              + sim_kernel_shapes(SHARD_BATCH // 2))
    entry1 = check_kernel(
        "spd_cholesky", "dyobav_tpu_torch/csrc/spd_cholesky.cu",
        "dyobav_tpu/ops/pallas_spd.py:46", spd.spd_solve,
        spd.spd_solve_plain, list(dict.fromkeys(shapes)), device, PEAKS)
    entry2 = check_kernel(
        "spd_lanes", "dyobav_tpu_torch/csrc/spd_lanes.cu",
        "docs/negative_results/pallas_linalg_lanes.py:30",
        lambda A, b: spd_lanes.batched_spd_solve(A, b, force_kernel=True),
        spd_lanes.batched_spd_solve_plain,
        [(LANES_BATCH,), (512,), (200,)], device, PEAKS)
    entry3 = check_stem_kernel(device, PEAKS)

    # The harness's paths with the deployment node, PANOC's with the solver
    # modes and the fleet, and the training stack run in three more
    # processes beside the others (their launch counts are their own),
    # started once the kernels are timed.
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    children = [ctx.Process(target=child_main, args=(results, name, "cuda:0"))
                for name in CHILD_PHASES]
    for child in children:
        child.start()
    payloads = {}
    try:
        launches, lanes_launches = drive_paths(device)
        for _ in children:
            try:
                name, status, payload = results.get(timeout=CHILD_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(
                    "a child process gave no result in "
                    f"{CHILD_TIMEOUT_S} s") from None
            if status != "ok":
                raise AssertionError(f"the {name} process failed:\n{payload}")
            payloads[name] = payload
        for child in children:
            child.join(timeout=60)
    finally:
        for child in children:
            if child.is_alive():
                child.terminate()
                child.join()
    for child in children:
        if child.exitcode != 0:
            raise AssertionError(f"a child process exited {child.exitcode}")
    for spd_launches, stem_launches in payloads.values():
        launches.update(spd_launches)
        STEM_LAUNCHES.update(stem_launches)

    entry1["launches"] = sum(launches.values())
    entry1["launches_by_path"] = launches
    entry2["launches"] = lanes_launches
    entry2["launches_by_path"] = {"batched_spd_solve": lanes_launches}
    entry3["launches"] = sum(STEM_LAUNCHES.values())
    entry3["launches_by_path"] = STEM_LAUNCHES
    print(json.dumps({"kernels": [entry1, entry2, entry3]}), flush=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
