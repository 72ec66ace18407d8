"""Network manager: training loop, checkpointing, batched inference, the
port of `dyobav_tpu.models.manager`.

The reference's `NetworkManager` (`pkg_motion_prediction/
network_manager.py:21-243`): AdamW(beta = (0.99, 0.999), weight decay 1e-4)
over every parameter, exponential learning-rate decay gamma = 0.99 per
epoch, the per-epoch evolving-WTA k_top schedule, NaN abort, early stopping
on the validation loss, per-epoch checkpoints, and a no-grad `inference`
returning (B, M, C).

A train step is one forward, backward and optimizer step in full float32
(`wta_net.full_f32`: TF32 off, as the JAX package's default dtype).  Losses
stay on the device and reach the host in bursts, through
`ops.engine.to_host` (which counts the syncs): every `val_after_batch`
steps in the host-paced `train`, once a chunk of `chunk_steps` steps in
`train_on_device`.  Checkpoints are torch `state_dict` `.pt` files with the
reference's key names, the format `models.wta_net.load_checkpoint` loads.

Inputs are NCHW: images (B, 7, H, W), `build_network`'s `input_shape`
(1, 7, H, W).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np
import torch

from ..configs import WtaNetConfiguration
from ..ops.engine import resolve_device, to_host
from ..utils.profiling import span
from . import losses
from .heatmap import traj_to_input_batch
from .wta_net import ConvMultiHypoNet, backbone_fc_input, full_f32


class NetworkManager:
    """Net/loss-agnostic, like the reference manager (network_manager.py:
    21-64 takes the net class and a loss dict): `net` is any `nn.Module`
    whose forward on (B, 7, H, W) images gives what the loss takes, and
    `loss` is a callable `(outputs, labels, k_top=..., relax=...) -> scalar`
    or a reference-style dict with a "loss" entry.  The defaults are the
    SWTA pipeline (`ConvMultiHypoNet` sized to the input in
    `build_network`, evolving-WTA meta-loss); the MDN variants train with
    e.g. `mdn.ConvMixtureDensityNet` + `losses.mdn_nll_loss`.

    `device`: None is the current CUDA device (raises without one).
    """

    def __init__(self, config: WtaNetConfiguration, net=None,
                 loss: Dict | Callable | None = None, seed: int = 0,
                 verbose: bool = True, device=None):
        self.config = config
        self.vb = verbose
        self.M = config.num_hypos
        self.lr = config.learning_rate
        self.wr = config.weight_regularization
        self.device = resolve_device(device)
        self.net = net
        self._default_net = net is None
        if isinstance(loss, dict):
            loss = loss.get("loss")
        self.loss_fn = loss or losses.wta_meta_loss
        self.seed = seed
        self.optimizer: torch.optim.Optimizer | None = None
        self.Loss: List[float] = []
        self.Val_loss: List[float] = []
        self.complete = False

    def _t(self, x) -> torch.Tensor:
        """`x` on the device in the net's dtype (float32 unless the caller
        converted the net)."""
        dtype = next(self.net.parameters()).dtype
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _images(self, trajs, offsets, ref_map) -> torch.Tensor:
        """The (B, 7, H, W) stacks of raw records, rasterized on the device
        in float32 (as the JAX package does), in the net's dtype."""
        return self._t(traj_to_input_batch(
            torch.as_tensor(trajs, device=self.device),
            torch.as_tensor(ref_map, device=self.device),
            torch.as_tensor(offsets, device=self.device)))

    # ------------------------------------------------------------------ build
    def build_network(self, input_shape=None):
        """Initialize the parameters from `seed` (the reference's
        `build_Network`, network_manager.py:79-94) on the manager's device
        and create the optimizer.  The default net's `fc_input` follows
        `input_shape` (1, C, H, W); None: the config's image size."""
        cfg = self.config
        input_shape = input_shape or (1, cfg.input_channel, cfg.y_max_px,
                                      cfg.x_max_px)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            if self._default_net:
                self.net = ConvMultiHypoNet(
                    dim_out=cfg.dim_out, num_hypos=cfg.num_hypos,
                    input_channel=input_shape[1],
                    fc_input=backbone_fc_input(*input_shape[2:]))
            else:
                for m in self.net.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters()
        self.net.to(self.device)
        # The epoch decay scales the base rate at each epoch boundary
        # (`set_epoch_lr`), as the reference counts epochs, not steps.
        self.optimizer = torch.optim.AdamW(
            self.net.parameters(), lr=self.lr, betas=(0.99, 0.999), eps=1e-8,
            weight_decay=self.wr)
        return self.net

    # alias for reference-API parity
    build_Network = build_network

    def set_epoch_lr(self, epoch: int, gamma: float = 0.99):
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr * (gamma ** epoch)

    # ------------------------------------------------------------------ steps
    def _step(self, images, labels, k_top: int, relax: float):
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        with full_f32():
            loss = self.loss_fn(self.net(images), labels, k_top=k_top,
                                relax=relax)
            loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _train_step(self, images, labels, k_top: int, relax: float = 0.0):
        """One optimizer step on (B, 7, H, W) images; returns the loss as a
        0-d tensor on the device."""
        return self._step(self._t(images), self._t(labels), k_top, relax)

    def _train_step_fused(self, trajs, offsets, labels, ref_map, k_top: int,
                          relax: float = 0.0):
        """Train step with the inputs rasterized on the device: only the
        raw (B, 5, 2) trajectories and offsets cross to it."""
        return self._step(self._images(trajs, offsets, ref_map),
                          self._t(labels), k_top, relax)

    @torch.no_grad()
    def _forward_eval(self, images):
        self.net.eval()
        with full_f32():
            return self.net(images)

    def _eval_step(self, images, labels, k_top: int):
        return self.loss_fn(self._forward_eval(self._t(images)),
                            self._t(labels), k_top=k_top)

    def _eval_step_fused(self, trajs, offsets, labels, ref_map, k_top: int):
        return self.loss_fn(
            self._forward_eval(self._images(trajs, offsets, ref_map)),
            self._t(labels), k_top=k_top)

    def inference(self, input_data):
        """Batched no-grad forward (network_manager.py:102-115) of
        (B, 7, H, W) images -> (B, M, C) hypotheses for the SWTA net, or a
        tuple of numpy arrays (e.g. (alpha, mu, sigma)) for the MDN nets."""
        out = self._forward_eval(self._t(input_data))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    # --------------------------------------------------- device-resident train
    def _eval_chunk(self, trajs, offsets, labels, n_batches: int, batch_size,
                    ref_map, k_top: int) -> float:
        """The mean loss of n_batches validation batches: the span
        `train.validate`."""
        with span("train.validate", trajs):
            vals = [self._eval_step_fused(trajs[s:s + batch_size],
                                          offsets[s:s + batch_size],
                                          labels[s:s + batch_size], ref_map,
                                          k_top)
                    for s in range(0, n_batches * batch_size, batch_size)]
            return float(to_host(torch.stack(vals).mean()))

    def train_on_device(self, data_handler, batch_size: int, epochs: int,
                        k_top_list: List[int] | None = None,
                        chunk_steps: int = 512, relax: float = 0.0,
                        checkpoint_dir: str | None = None,
                        val_batches: int = 16):
        """Full-dataset training with the index staged on the device.

        The raw index is small (13 floats a sample), so the whole train /
        val split lives on the device and an epoch is: one `torch.randperm`
        from a device generator seeded `seed + 1`, then chunks of
        `chunk_steps` optimizer steps, each gathering its batches on the
        device, with one host sync a chunk (its losses, the NaN check).
        Needs a single shared reference map (the warehouse dataset's);
        datasets of several maps go to the host-paced `train` loop.

        The epoch semantics are the reference recipe's (network_manager.py:
        129-217): per-epoch k_top and LR decay, NaN abort, early stopping,
        per-epoch checkpoints.  The trailing `n_steps % chunk_steps`
        minibatches of an epoch are dropped, as in the JAX package; the
        chunk shrinks to the epoch when the epoch is shorter, and
        validation is skipped when the validation split is smaller than
        one batch.  The permutation is torch's, not `jax.random`'s.
        """
        ds = data_handler.ds
        maps = [ds.ref_map(v) for v in {s.video for s in ds.samples}]
        if not all(np.array_equal(maps[0], m) for m in maps[1:]):
            print("train_on_device: dataset has multiple reference maps; "
                  "falling back to the host-paced train loop.")
            return self.train(data_handler, batch_size, epochs,
                              k_top_list=k_top_list, relax=relax,
                              checkpoint_dir=checkpoint_dir)
        ref_map = self._t(maps[0])
        k_top_list = k_top_list or losses.default_k_top_schedule(epochs, self.M)
        if len(k_top_list) != epochs:
            raise ValueError("k_top_list length must equal number of epochs.")

        def stage(indices):
            samples = [ds.samples[i] for i in indices]
            return (self._t(np.stack([s.traj for s in samples])),
                    self._t(np.array([s.offset for s in samples], np.float32)),
                    self._t(np.stack([s.label for s in samples])))

        trajs, offsets, labels = stage(data_handler.train_idx)
        n_train = len(data_handler.train_idx)
        if n_train < batch_size:
            raise ValueError(
                f"train_on_device needs at least one full batch "
                f"({n_train} train samples < batch_size {batch_size}).")
        n_val = min(len(data_handler.val_idx), val_batches * batch_size)
        # Validation (and early stopping) is skipped when the val split is
        # smaller than one batch: no batch would give a NaN val loss.
        has_val = n_val >= batch_size
        if has_val:
            vtr, voff, vlab = stage(data_handler.val_idx[:n_val])

        steps_per_epoch = n_train // batch_size
        chunk_steps = max(1, min(chunk_steps, steps_per_epoch))
        n_chunks = max(1, steps_per_epoch // chunk_steps)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        min_val, stall = np.inf, 0
        for ep in range(epochs):
            self.set_epoch_lr(ep)
            k_top = int(k_top_list[ep])
            r = relax if k_top == 1 else 0.0
            perm = torch.randperm(n_train, generator=gen, device=self.device)[
                :n_chunks * chunk_steps * batch_size].reshape(
                n_chunks, chunk_steps, batch_size)
            ep_losses = []
            for ci in range(n_chunks):
                with span("train.chunk", trajs):
                    chunk = torch.stack([
                        self._train_step_fused(trajs[idx], offsets[idx],
                                               labels[idx], ref_map, k_top, r)
                        for idx in perm[ci]])
                    vals = to_host(chunk)
                if np.isnan(vals).any():
                    print("Loss is NaN — training aborted.")
                    self.complete = False
                    return
                # per-chunk mean keeps the profile compact
                self.Loss.append(float(vals.mean()))
                ep_losses.append(vals.mean())
                if self.vb:
                    print(f"\rEpoch {ep + 1}/{epochs} k={k_top} "
                          f"chunk {ci + 1}/{n_chunks} "
                          f"loss={self.Loss[-1]:.4f}   ", end="", flush=True)
            val = (self._eval_chunk(vtr, voff, vlab, n_val // batch_size,
                                    batch_size, ref_map, k_top)
                   if has_val else float("nan"))
            self.Val_loss.append(val)
            if self.vb:
                print(f"\rEpoch {ep + 1}/{epochs} k={k_top} done "
                      f"loss={np.mean(ep_losses):.4f} val={val:.4f}   ",
                      flush=True)
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, ep)
            if has_val and self.config.early_stopping > 0:
                if val < min_val:
                    min_val, stall = val, 0
                else:
                    stall += 1
                    if stall >= self.config.early_stopping:
                        print(f"\nEarly stopping at epoch {ep + 1}.")
                        break
        self.complete = True

    # ------------------------------------------------------------------ train
    def train(self, data_handler, batch_size: int, epochs: int,
              k_top_list: List[int] | None = None, val_after_batch: int = 20,
              rasterize=None, checkpoint_dir: str | None = None,
              relax: float = 0.0):
        """Epoch loop mirroring network_manager.train (:129-217): per-epoch
        k_top, NaN abort, val tracking, early stopping, checkpoints.

        When a batch's samples share one map (always, for the warehouse
        dataset), its inputs are rasterized on the device inside the step;
        a custom `rasterize(batch) -> (images, labels)` callable takes the
        host path instead.  `batch_size` is the data handler's.
        """
        from .data import rasterize_batch
        fused = rasterize is None
        rasterize = rasterize or (lambda b: rasterize_batch(
            b, data_handler.ds, self.device))
        k_top_list = k_top_list or losses.default_k_top_schedule(epochs, self.M)
        if len(k_top_list) != epochs:
            raise ValueError("k_top_list length must equal number of epochs.")
        ref_maps, shared_map = {}, None
        if fused:
            arrs = {v: data_handler.ds.ref_map(v)
                    for v in {s.video for s in data_handler.ds.samples}}
            first = next(iter(arrs.values()))
            # Static-environment datasets reuse one map for every video
            # (the warehouse case): one device copy for every batch.
            if all(np.array_equal(first, a) for a in arrs.values()):
                shared_map = self._t(first)
            ref_maps = {v: self._t(a) for v, a in arrs.items()}
        min_val, stall = np.inf, 0
        sync_every = max(int(val_after_batch), 1)
        for ep in range(epochs):
            self.set_epoch_lr(ep)
            k_top = int(k_top_list[ep])
            r = relax if k_top == 1 else 0.0
            n_batches = data_handler.batches_per_epoch()
            pending: List[torch.Tensor] = []

            def sync_losses() -> bool:
                """Drain the pending device losses; True on a NaN."""
                if not pending:
                    return False
                vals = to_host(torch.stack(pending))
                pending.clear()
                self.Loss.extend(float(v) for v in vals)
                return bool(np.isnan(vals).any())

            for bi in range(n_batches):
                batch = data_handler.next_batch()
                one_video = len(set(batch["video"])) == 1
                if fused and (shared_map is not None or one_video):
                    the_map = (shared_map if shared_map is not None
                               else ref_maps[batch["video"][0]])
                    loss = self._train_step_fused(
                        batch["traj"], batch["offset"], batch["label"],
                        the_map, k_top, r)
                else:
                    images, labels = rasterize(batch)
                    loss = self._train_step(images, labels, k_top, r)
                pending.append(loss)
                if (bi + 1) % sync_every == 0:
                    if sync_losses():
                        print("Loss is NaN — training aborted.")
                        self.complete = False
                        return
                    self.Val_loss.append(self._validate(
                        data_handler, rasterize, k_top,
                        shared_map=shared_map, ref_maps=ref_maps))
                    if self.vb:
                        print(f"\rEpoch {ep + 1}/{epochs} k={k_top} "
                              f"batch {bi + 1}/{n_batches} "
                              f"loss={self.Loss[-1]:.4f}   ", end="",
                              flush=True)
            if sync_losses():
                print("Loss is NaN — training aborted.")
                self.complete = False
                return
            val = self._validate(data_handler, rasterize, k_top,
                                 shared_map=shared_map, ref_maps=ref_maps)
            self.Val_loss.append(val)
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, ep)
            if self.config.early_stopping > 0:
                if val < min_val:
                    min_val, stall = val, 0
                else:
                    stall += 1
                    if stall >= self.config.early_stopping:
                        print(f"\nEarly stopping at epoch {ep + 1}.")
                        break
        self.complete = True

    def recalibrate_batch_stats(self, data_handler, n_batches: int = 100):
        """Refresh the BatchNorm running statistics against the FINAL
        parameters: train-mode forwards only, no gradient, no update.

        Needed when running stats lag the trained parameters, e.g. after
        training with a slow BN momentum, or after porting weights.
        """
        ref_maps = {v: self._t(data_handler.ds.ref_map(v))
                    for v in {s.video for s in data_handler.ds.samples}}
        self.net.train()
        with torch.no_grad(), full_f32():
            for _ in range(n_batches):
                batch = data_handler.next_batch()
                self.net(self._images(batch["traj"], batch["offset"],
                                      ref_maps[batch["video"][0]]))

    def _validate(self, data_handler, rasterize, k_top: int,
                  shared_map=None, ref_maps=None) -> float:
        vals = []
        for batch in data_handler.val_batches(max_batches=2):
            the_map = shared_map
            if the_map is None and ref_maps and len(set(batch["video"])) == 1:
                the_map = ref_maps[batch["video"][0]]
            if the_map is not None:
                val = self._eval_step_fused(batch["traj"], batch["offset"],
                                            batch["label"], the_map, k_top)
            else:
                images, labels = rasterize(batch)
                val = self._eval_step(images, labels, k_top)
            vals.append(float(to_host(val)))
        return float(np.mean(vals)) if vals else np.nan

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, directory: str, epoch: int | None = None) -> str:
        """The net's `state_dict` (CPU tensors) as
        `<directory>/model_ckp_<epoch>.pt`, or `model.pt`; returns the
        path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.abspath(os.path.join(
            directory, f"model_ckp_{epoch}.pt" if epoch is not None
            else "model.pt"))
        torch.save({k: v.detach().cpu()
                    for k, v in self.net.state_dict().items()}, path)
        return path

    def load_checkpoint(self, path: str):
        """Strictly load a torch `state_dict` file (`.pt` / `.pth`, as
        `save_checkpoint` writes and as the reference's network_manager.py:
        102-115 loads); any other path raises."""
        if not path.endswith((".pt", ".pth")):
            raise ValueError(f"{path}: not a .pt / .pth state_dict file "
                             "(the port has no orbax checkpoints)")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        if self.optimizer is None:
            self.build_network()
        sd = torch.load(path, map_location="cpu", weights_only=True)
        self.net.load_state_dict(sd, strict=True)
