#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time.

    python3 scripts/profile_torch_train.py                   # SWTA, card
    python3 scripts/profile_torch_train.py --net mdn
    python3 scripts/profile_torch_train.py --device cpu --steps 2

Writes a synthetic WSD-format dataset (walks on the real warehouse map's
free space, `models/data.write_synthetic_wsd`) to a temporary directory,
builds `NetworkManager` at full width (7 x 293 x 330 inputs, the
reference's AdamW and batch of 20) with the net `--net`, stages
`--steps` + 5 batches on the device as `train_on_device` does, runs 5
steps of `_train_step_fused` unprofiled, then profiles the next `--steps`
under `torch.profiler` (host and device), and prints one JSON line: ms a
step (wall, around a device synchronize), the device's own time a step
(its events: kernels, memcpy, memset, and the `Optimizer.step` range the
profiler lists among them), its idle share, kernel launches and aten
calls a step, and the kernels and host operators that take the most
time.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
WARMUP = 5
BATCH = 20          # WtaNetConfiguration.batch_size, the recipe's


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="wta", choices=["wta", "mdn", "mdnfit"])
    ap.add_argument("--steps", type=int, default=10,
                    help="profiled steps after the warm-up")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line
    from dyobav_tpu_torch.configs import WtaNetConfiguration
    from dyobav_tpu_torch.models import losses, mdn
    from dyobav_tpu_torch.models.data import (DataHandler, WsdDataset,
                                              write_synthetic_wsd)
    from dyobav_tpu_torch.models.manager import NetworkManager
    from dyobav_tpu_torch.ops.engine import resolve_device
    from profile_torch_solve import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    net, loss = {"wta": (None, None),
                 "mdn": (mdn.ConvMixtureDensityNet(), losses.mdn_nll_loss),
                 "mdnfit": (mdn.ConvMultiHypoMixtureDensityFit(),
                            losses.smdn_nll_loss)}[args.net]
    mgr = NetworkManager(WtaNetConfiguration(), net=net, loss=loss,
                         verbose=False, device=dev)
    mgr.build_network()
    tmp = tempfile.mkdtemp(prefix="wsd_profile_")
    try:
        data = write_synthetic_wsd(
            os.path.join(tmp, "data"),
            os.path.join(ROOT, "data", "warehouse_sim_original", "label.png"))
        ds = WsdDataset(data)
        dh = DataHandler(ds, batch_size=BATCH, seed=0)
        ref = torch.as_tensor(ds.ref_map(ds.samples[0].video), device=dev)
        batches = [dh.next_batch() for _ in range(WARMUP + args.steps)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = torch.Generator().manual_seed(1)
    staged = [(torch.as_tensor(b["traj"], device=dev),
               torch.as_tensor(b["offset"], device=dev),
               # the MDN nets train on standard-normal labels (their
               # mixture NLL is +inf at a fresh init on labels in pixels)
               (torch.as_tensor(b["label"]) if args.net == "wta" else
                torch.randn(BATCH, 2, generator=rng)).to(dev))
              for b in batches]

    def run(part):
        t0 = time.perf_counter()
        for t, o, y in part:
            mgr._train_step_fused(t, o, y, ref, 1)
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    warm_s = run(staged[:WARMUP])
    wall_s, stats = profiled(lambda: run(staged[WARMUP:]), cuda, args.top)
    n = args.steps
    print(json.dumps({
        "card": card_line() if cuda else "cpu", "net": args.net,
        "batch": BATCH, "steps": n, "warmup_s": warm_s,
        "ms_per_step": 1e3 * wall_s / n,
        "device_ms_per_step": 1e3 * stats["device_kernel_s"] / n,
        "device_idle_share": (1.0 - stats["device_kernel_s"] / wall_s)
        if cuda else None,
        "kernel_launches_per_step": stats["kernel_launches"] / n,
        "aten_calls_per_step": stats["aten_calls"] / n,
        "top_device_ms": stats["top_device_ms"],
        "top_host_ms": stats["top_host_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
