"""SWTA predictor training entry point, the port of
`dyobav_tpu.models.train`.

The counterpart of the reference's `pre_load.main_train` (pre_load.py:71-89):
config -> dataset -> manager -> train with the evolving-WTA k_top schedule
-> final checkpoint `<out>.pt` + loss profile `<out>_profile.json`.

    python -m dyobav_tpu_torch.models.train --data data/WSD_1t20_train \\
        --epochs 20 --out Model/wsd_1t20

Per-epoch checkpoints `model_ckp_<epoch>.pt` land beside `<out>`.  It runs
on the current CUDA device (raises without one) unless `--device cpu`
asks for the CPU.  A `--net wta` checkpoint loads with
`models.wta_net.load_checkpoint` and runs in `sim.batch.make_wta_predictor`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..configs import WtaNetConfiguration
from . import losses
from .data import DataHandler, WsdDataset
from .manager import NetworkManager


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="data/WSD_1t20_train")
    ap.add_argument("--out", default="Model/wsd_1t20",
                    help="writes <out>.pt and <out>_profile.json")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-samples", type=int, default=0,
                    help="subsample the index for quick runs (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="cap batches per epoch (0 = full epoch)")
    ap.add_argument("--resume", default="",
                    help=".pt checkpoint to load before training "
                         "(continuation / fine-tuning run)")
    ap.add_argument("--k-top", type=int, default=0,
                    help="fixed WTA k_top for every epoch (0 = evolving "
                         "schedule). k=1 sharpens a pre-trained model's "
                         "hypothesis spread.")
    ap.add_argument("--relax", type=float, default=0.0,
                    help="relaxed-WTA epsilon (only applied at k_top=1): "
                         "pulls non-winning hypotheses gently toward the "
                         "label, shrinking outlier spread")
    ap.add_argument("--recalibrate-bn", type=int, default=100,
                    help="BatchNorm running-stat refresh batches after "
                         "training (0 = skip)")
    ap.add_argument("--val-every", type=int, default=20,
                    help="batches between validation / loss-sync points of "
                         "the host-paced loop (each is a host sync)")
    ap.add_argument("--device-loop", type=int, default=1,
                    help="1 = stage the whole index on the device and run "
                         "chunked epochs (one host sync per --chunk-steps "
                         "optimizer steps); 0 = host-paced loop")
    ap.add_argument("--chunk-steps", type=int, default=512,
                    help="optimizer steps per host sync in the device loop")
    ap.add_argument("--net", default="wta", choices=["wta", "mdn", "mdnfit"],
                    help="predictor family: SWTA multi-hypothesis (default), "
                         "classic MDN head, or WTA+sampling-MDN fit "
                         "(reference net.py:106/145/194)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    ds = WsdDataset(args.data)
    if args.max_samples and len(ds) > args.max_samples:
        rng = np.random.default_rng(args.seed)
        keep = rng.choice(len(ds), args.max_samples, replace=False)
        ds.samples = [ds.samples[i] for i in keep]
    H, W = ds.image_shape()
    print(f"Dataset: {len(ds)} samples, image {H}x{W}")

    cfg = WtaNetConfiguration(epoch=args.epochs, batch_size=args.batch_size,
                              learning_rate=args.lr, x_max_px=W, y_max_px=H)
    dh = DataHandler(ds, batch_size=args.batch_size, seed=args.seed)
    if args.steps_per_epoch:
        real_bpe = dh.batches_per_epoch
        dh.batches_per_epoch = lambda: min(args.steps_per_epoch, real_bpe())

    from .wta_net import backbone_fc_input
    fc_input = backbone_fc_input(H, W)
    if args.net == "mdn":
        from .mdn import ConvMixtureDensityNet
        net = ConvMixtureDensityNet(dim_out=cfg.dim_out,
                                    num_components=cfg.num_hypos,
                                    fc_input=fc_input)
        mgr = NetworkManager(cfg, net=net, loss=losses.mdn_nll_loss,
                             seed=args.seed, device=args.device)
    elif args.net == "mdnfit":
        from .mdn import ConvMultiHypoMixtureDensityFit
        net = ConvMultiHypoMixtureDensityFit(
            dim_out=cfg.dim_out, num_hypos=cfg.num_hypos, num_gaus=5,
            fc_input=fc_input)
        mgr = NetworkManager(cfg, net=net, loss=losses.smdn_nll_loss,
                             seed=args.seed, device=args.device)
    else:
        mgr = NetworkManager(cfg, seed=args.seed, device=args.device)
    mgr.build_network(input_shape=(1, cfg.input_channel, H, W))
    if args.resume:
        mgr.load_checkpoint(args.resume)
        print(f"Resumed from {args.resume}")
    n_params = sum(p.numel() for p in mgr.net.parameters())
    print(f"Model: {n_params} parameters")

    if args.k_top:
        k_top_list = [args.k_top] * args.epochs
    else:
        k_top_list = losses.default_k_top_schedule(args.epochs, cfg.num_hypos)
    t0 = time.time()
    ckpt_dir = os.path.dirname(args.out) or "."
    if args.device_loop and not args.steps_per_epoch:
        mgr.train_on_device(dh, args.batch_size, args.epochs,
                            k_top_list=k_top_list,
                            chunk_steps=args.chunk_steps,
                            checkpoint_dir=ckpt_dir, relax=args.relax)
    else:
        mgr.train(dh, args.batch_size, args.epochs, k_top_list=k_top_list,
                  val_after_batch=args.val_every, checkpoint_dir=ckpt_dir,
                  relax=args.relax)
    hours = (time.time() - t0) / 3600
    print(f"\nTraining done: {n_params} parameters. Cost time: {hours:.4f}h.")

    if mgr.complete and args.recalibrate_bn:
        mgr.recalibrate_batch_stats(dh, n_batches=args.recalibrate_bn)

    if mgr.complete:
        os.replace(mgr.save_checkpoint(ckpt_dir), args.out + ".pt")
        with open(args.out + "_profile.json", "w") as f:
            json.dump({"loss": mgr.Loss, "val_loss": mgr.Val_loss}, f)
        print(f"Saved checkpoint to {args.out}.pt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
