"""Driver of the training cells: `models/manager.NetworkManager.
train_on_device`, the index staged on the card, epochs back to back.

Set-up writes the traffic's walks (WSD format) under TMPDIR, indexes them
with the program's `WsdDataset`, builds the manager and its AdamW, and
gives the net weights made on the card from the seed.  It then drives that
manager through its first `checked_steps` optimizer steps, one
`train_on_device` call each on 20 rows of its own (drawn from the seed, all
different; the last call also validates on 20 more, which warms the
evaluation's shapes), keeping what the reference follows: each step's
loss, the first gradient as AdamW holds it after one step, and the weights
and BatchNorm statistics after the last.  The window then calls
`train_on_device` for one epoch at a time on the program's own split
(`DataHandler`, 80/20 from the seed), in chunks of `chunk_steps` steps
with one host sync a chunk.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..generators import walks
from ..reference import swta_net
from ..yardstick import profiler

TRACE_CHUNKS = 2


class Rows:
    """A feed of the dataset's rows `train_idx` (and `val_idx`), as
    `train_on_device` reads a data handler."""

    def __init__(self, ds, train_idx, val_idx=()):
        self.ds = ds
        self.train_idx = np.asarray(train_idx, np.int64)
        self.val_idx = np.asarray(val_idx, np.int64)


def make_weights(net, seed: int, device) -> dict:
    """Weights of `net` drawn on the card from `seed` in one call: each
    convolution and dense weight and bias uniform in +-1/sqrt(fan in)
    (torch's default scale), BatchNorm scale 1 and shift 0, running
    statistics 0 and 1.  Returns float32 copies by `state_dict` key."""
    params = dict(net.named_parameters())
    total = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    mods = dict(net.named_modules())
    for name, p in params.items():
        mod = mods[name.rsplit(".", 1)[0]]
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            val = (torch.ones_like(p) if name.endswith("weight")
                   else torch.zeros_like(p))
        else:
            w = getattr(mod, "weight")
            fan_in = w[0].numel()
            val = u[at:at + p.numel()].reshape(p.shape) / fan_in ** 0.5
        at += p.numel()
        out[name] = val
    for name, b in net.named_buffers():
        if name.endswith("running_mean"):
            out[name] = torch.zeros_like(b)
        elif name.endswith("running_var"):
            out[name] = torch.ones_like(b)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(out[name])
        for name, b in net.named_buffers():
            if name in out:
                b.copy_(out[name])
    return {k: v.detach().clone() for k, v in out.items()}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dyobav_tpu_torch.configs import WtaNetConfiguration
        from dyobav_tpu_torch.models.data import DataHandler, WsdDataset
        from dyobav_tpu_torch.models.manager import NetworkManager

        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.root = tempfile.mkdtemp(prefix="navbench_walks_")
        label = os.path.join(harness.ROOT, config["map"]["label_png"])
        walks.write(self.root, label, traffic, seed)
        obsv, off_max = config["obsv_len"], traffic["pred_offset_max"]
        self.ds = WsdDataset(self.root, obsv_len=obsv,
                             pred_offset_max=off_max)
        self.samples = walks.index(self.root, obsv, off_max)
        wcfg = WtaNetConfiguration(**{k: config[k] for k in (
            "input_channel", "y_max_px", "x_max_px", "fc_input", "num_hypos",
            "dim_out", "obsv_len", "pred_len", "batch_size", "learning_rate",
            "weight_regularization")})
        self.mgr = NetworkManager(wcfg, seed=seed, verbose=False,
                                  device=self.device)
        self.mgr.build_network()
        self.w0 = make_weights(self.mgr.net, seed, self.device)
        self.B = traffic["batch"]

        # The steps the reference follows.
        n_checked = traffic["checked_steps"]
        rng = np.random.default_rng([seed, 1])
        perm = rng.permutation(len(self.ds))
        self.step_rows = [perm[k * self.B:(k + 1) * self.B]
                          for k in range(n_checked)]
        val_rows = perm[n_checked * self.B:(n_checked + 1) * self.B]
        self.losses, self.grad1 = [], None
        for k, rows in enumerate(self.step_rows):
            feed = Rows(self.ds, rows,
                        val_rows if k == n_checked - 1 else ())
            self.mgr.train_on_device(feed, self.B, epochs=1, chunk_steps=1)
            self.losses.append(self.mgr.Loss[-1])
            if k == 0:
                beta1 = self.mgr.optimizer.param_groups[0]["betas"][0]
                state = self.mgr.optimizer.state
                self.grad1 = {
                    n: (state[p]["exp_avg"] / (1.0 - beta1)).clone()
                    if "exp_avg" in state[p] else torch.zeros_like(p)
                    for n, p in self.mgr.net.named_parameters()}
        self.after = {k: v.detach().clone()
                      for k, v in self.mgr.net.state_dict().items()}
        self.handler = DataHandler(self.ds, self.B,
                                   val_fraction=traffic["val_fraction"],
                                   seed=seed)
        harness.sync(self.device)

    def _epoch(self, feed) -> tuple:
        """One `train_on_device` epoch on `feed`: (steps, seconds, ok)."""
        steps_per_epoch = len(feed.train_idx) // self.B
        chunk = max(1, min(self.traffic["chunk_steps"], steps_per_epoch))
        steps = (steps_per_epoch // chunk) * chunk
        t0 = time.perf_counter()
        self.mgr.train_on_device(feed, self.B, epochs=1, chunk_steps=chunk)
        harness.sync(self.device)
        return steps, time.perf_counter() - t0, self.mgr.complete

    def window(self, seconds: float) -> dict:
        steps = failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n, _, ok = self._epoch(self.handler)
            steps += n
            failed += 0 if ok else self.traffic["chunk_steps"]
        elapsed = time.perf_counter() - t0
        return {"metrics": {"train_samples_per_s": self.B * steps / elapsed},
                "attempted": steps, "failed": failed}

    def traced(self) -> dict:
        steps, steps_s, ok = self._epoch(self.handler)
        n = TRACE_CHUNKS * self.traffic["chunk_steps"] * self.B
        feed = Rows(self.ds, self.handler.train_idx[:n])
        tr = profiler.trace(lambda: self._epoch(feed))
        obs = {"traces": {"train": tr},
               "work": {"flops_per_image": swta_net.flops_per_image(
                   self.cfg["y_max_px"], self.cfg["x_max_px"],
                   self.cfg["input_channel"], self.cfg["num_hypos"],
                   self.cfg["dim_out"]),
                   "batch": self.B, "steps": steps, "steps_s": steps_s,
                   "traced_steps": n // self.B}}
        return {"observations": obs, "attempted": steps + n // self.B,
                "failed": 0 if ok and self.mgr.complete else steps,
                "busy_s": tr["busy_s"], "window_s": tr["wall_s"],
                "breakdown": {"device_ops": tr["device_ops"],
                              "idle_gaps": tr["idle_gaps"]}}

    def release(self):
        self.mgr = self.ds = self.handler = None
        shutil.rmtree(self.root, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype, tf32: bool = False) -> dict:
        """The reference's losses, first gradient, weights and running
        statistics after the checked steps, from the same weights and rows,
        in `dtype` (float64; float32 with TF32 on for the control)."""
        from ..yardstick.png import gray_map

        opt = self.cfg["optimizer"]
        lr, wd = self.cfg["learning_rate"], self.cfg["weight_regularization"]
        b1, b2 = opt["betas"]
        sd = {k: v.to(dtype) for k, v in self.w0.items()}
        names = [k for k in sd if not k.endswith(("running_mean",
                                                  "running_var"))]
        ref_map = torch.as_tensor(gray_map(os.path.join(
            harness.ROOT, self.cfg["map"]["label_png"])), dtype=dtype,
            device=self.device)
        trajs, offsets, labels = self.samples
        m = {k: torch.zeros_like(sd[k]) for k in names}
        v = {k: torch.zeros_like(sd[k]) for k in names}
        losses, grad1 = [], None
        cudnn = torch.backends.cudnn
        matmul = torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        try:
            matmul.allow_tf32 = tf32
            with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                             deterministic=cudnn.deterministic,
                             allow_tf32=tf32):
                for t, rows in enumerate(self.step_rows, start=1):
                    x = swta_net.input_stack(
                        torch.as_tensor(trajs[rows], dtype=dtype,
                                        device=self.device), ref_map,
                        torch.as_tensor(offsets[rows], dtype=dtype,
                                        device=self.device))
                    lab = torch.as_tensor(labels[rows], dtype=dtype,
                                          device=self.device)
                    leaves = {k: sd[k].clone().requires_grad_(True)
                              for k in names}
                    stats = {}
                    hyp = swta_net.forward(dict(sd, **leaves), x, train=True,
                                           stats=stats)
                    # Winner-takes-all: each sample's closest hypothesis,
                    # squared distance over the batch size, batch mean.
                    d = ((hyp - lab[:, None]) ** 2).sum(-1) / hyp.shape[0]
                    loss = d.amin(1).mean()
                    grads = torch.autograd.grad(loss, [leaves[k]
                                                       for k in names])
                    losses.append(float(loss.detach()))
                    g = dict(zip(names, grads))
                    if grad1 is None:
                        grad1 = {k: x.detach() for k, x in g.items()}
                    with torch.no_grad():
                        for k in names:
                            p = sd[k] * (1.0 - lr * wd)
                            m[k] = b1 * m[k] + (1.0 - b1) * g[k]
                            v[k] = b2 * v[k] + (1.0 - b2) * g[k] ** 2
                            mh = m[k] / (1.0 - b1 ** t)
                            vh = v[k] / (1.0 - b2 ** t)
                            sd[k] = p - lr * mh / (vh.sqrt() + opt["eps"])
                        sd.update({k: s.detach() for k, s in stats.items()})
        finally:
            matmul.allow_tf32 = saved
        return {"losses": losses, "grad1": grad1, "after": sd}

    def judge(self, control: bool = False) -> dict:
        """Gaps of each step's loss, the first gradient's and the weights'
        change's norms (worst leaf) and the running statistics, against
        the float64 reference; control=True judges the reference in
        float32 with TF32 on in the program's place."""
        ref = self.reference_steps(torch.float64)
        if control:
            ctl = self.reference_steps(torch.float32, tf32=True)
            losses, grad1, after = ctl["losses"], ctl["grad1"], ctl["after"]
        else:
            losses, grad1, after = self.losses, self.grad1, self.after
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"]))
        g_ref = {k: float(x.norm()) for k, x in ref["grad1"].items()}
        med = float(np.median(list(g_ref.values())))
        moving = [k for k, n in g_ref.items() if n >= 1e-3 * med]
        grad_gap = max(abs(float(grad1[k].double().norm()) - g_ref[k])
                       / max(g_ref[k], med) for k in moving)
        d_ref = {k: float((ref["after"][k] - self.w0[k].double()).norm())
                 for k in moving}
        d_med = float(np.median(list(d_ref.values())))
        change_gap = max(
            abs(float((after[k].double() - self.w0[k].double()).norm())
                - d_ref[k]) / max(d_ref[k], d_med) for k in moving)
        stats = {k: float(ref["after"][k].norm()) for k in ref["after"]
                 if k.endswith(("running_mean", "running_var"))}
        s_med = float(np.median(list(stats.values())))
        bn_gap = max(float((after[k].double() - ref["after"][k]).norm())
                     / max(n, s_med) for k, n in stats.items())
        return {"loss_gap": loss_gap,
                "loss1_gap": abs(losses[0] - ref["losses"][0])
                / abs(ref["losses"][0]),
                "grad1_norm_gap": grad_gap,
                "change_norm_gap": change_gap, "bn_stats_gap": bn_gap,
                "leaves_compared": len(moving)}
