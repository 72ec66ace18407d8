"""Driver of the predictor cells: `sim/batch.make_wta_predictor`'s
`predict` on batches of pedestrian histories, calls back to back.

Set-up loads the trained net (`models/wta_net.load_checkpoint`), builds
the snap tables from the map (`predictors/mmp.ObstacleSnapper`) and the
predictor, and makes two calls (cuDNN's and cuBLAS's first calls, every
shape the window uses).  A call is the histories' copy to the card, the
predictor and a synchronize.  The traced run times a few calls with the
host clock and profiles three more.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import harness
from ..generators.pedestrians import PedestrianHistories
from ..reference import swta_net
from ..reference.swta_predict import Predictor
from ..yardstick import profiler
from ..yardstick.png import gray_map

WARMUP_CALLS = 2
TIMED_TRACE_CALLS = 10
PROFILED_CALLS = 3


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dyobav_tpu_torch.maps.transforms import \
            ScaleOffsetReverseTransform
        from dyobav_tpu_torch.models.wta_net import load_checkpoint
        from dyobav_tpu_torch.predictors.mmp import ObstacleSnapper
        from dyobav_tpu_torch.sim.batch import make_wta_predictor

        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        m, p = config["map"], config["predictor"]
        self.gray = gray_map(os.path.join(harness.ROOT, m["label_png"]))
        self.checkpoint = os.path.join(harness.ROOT, config["checkpoint"])
        net = load_checkpoint(self.checkpoint, self.device)
        transform = ScaleOffsetReverseTransform(
            scale=m["scale2real"], offsetx_after=m["corner_coords"][0],
            offsety_after=m["corner_coords"][1], y_reverse=not m["image_axis"],
            y_max_before=m["sim_height"])
        self.predict = make_wta_predictor(
            net, self.gray, transform, p["n_hor"],
            snap_tables=ObstacleSnapper(255.0 - self.gray).tables(),
            obsv_len=config["obsv_len"], max_clusters=p["max_clusters"],
            enlarge=p["enlarge"], scale2nn=m["scale2nn"], device=self.device)
        self.gen = PedestrianHistories(traffic, m, self.gray, seed)
        self.next_call = 0
        self.outputs = {}           # call index -> (mu, std, alpha)
        for _ in range(WARMUP_CALLS):
            self._call(keep=False)

    def _call(self, keep: bool) -> float:
        """One call on the next histories; its host seconds."""
        hist = self.gen.call(self.next_call)
        t0 = time.perf_counter()
        out = self.predict(torch.as_tensor(hist, device=self.device))
        harness.sync(self.device)
        dt = time.perf_counter() - t0
        if keep:
            self.outputs[self.next_call] = out
        self.next_call += 1
        return dt

    def _failed(self) -> int:
        return sum(int(not all(bool(torch.isfinite(t).all()) for t in o))
                   for o in self.outputs.values())

    def window(self, seconds: float) -> dict:
        times = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            times.append(self._call(keep=True))
        p95 = float(np.percentile(np.asarray(times) * 1e3, 95))
        return {"metrics": {"predict_p95_ms": p95},
                "attempted": len(times), "failed": self._failed()}

    def _images_per_call(self) -> int:
        t = self.traffic
        return t["lanes"] * t["humans"] * self.cfg["predictor"]["n_hor"]

    def traced(self) -> dict:
        calls_s = sum(self._call(keep=True) for _ in range(TIMED_TRACE_CALLS))
        tr = profiler.trace(lambda: [self._call(keep=True)
                                     for _ in range(PROFILED_CALLS)])
        obs = {"traces": {"predict": tr},
               "work": {"flops_per_image": swta_net.flops_per_image(
                   self.cfg["y_max_px"], self.cfg["x_max_px"],
                   self.cfg["input_channel"], self.cfg["num_hypos"],
                   self.cfg["dim_out"]),
                   "images_per_call": self._images_per_call(),
                   "calls": TIMED_TRACE_CALLS, "calls_s": calls_s}}
        return {"observations": obs, "attempted": len(self.outputs),
                "failed": self._failed(), "busy_s": tr["busy_s"],
                "window_s": tr["wall_s"],
                "breakdown": {"device_ops": tr["device_ops"],
                              "idle_gaps": tr["idle_gaps"]}}

    def release(self):
        self.predict = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked_calls(self) -> list:
        """The calls judged: a sample drawn from the seed."""
        keys = sorted(self.outputs)
        rng = np.random.default_rng([self.seed, 2])
        n = min(self.traffic["checked_calls"], len(keys))
        return sorted(int(k) for k in rng.choice(keys, n, replace=False))

    def judge(self, control: bool = False) -> dict:
        """The f64 reference's readings of the sampled calls; control=True
        judges the reference computed in float32 with TF32 instead.  Each
        (lane, offset, pedestrian) set is held to the nearest of the
        reference's candidate answers whose alphas it matches."""
        ref = Predictor(self.cfg, self.gray, self.checkpoint,
                        torch.float64, self.device)
        ctl = (Predictor(self.cfg, self.gray, self.checkpoint, torch.float32,
                         self.device, tf32=True) if control else None)
        C = self.cfg["predictor"]["max_clusters"]
        mu_gap = std_gap = 0.0
        mismatch = skipped = sets = 0
        for i in self.checked_calls():
            hist = self.gen.call(i)
            cands = ref.predict(hist)
            if control:
                mu, std, al = ctl.answer(hist)
            else:
                mu, std, al = (t.double().cpu().numpy()
                               for t in self.outputs[i])
                B, N = mu.shape[:2]
                mu = mu.reshape(B, N, -1, C, 2)
                std = std.reshape(B, N, -1, C, 2)
                al = al.reshape(B, N, -1, C)
            for ix, cs in cands.items():
                sets += 1
                if cs is None:
                    skipped += 1
                    continue
                best = None
                for mu_c, std_c, al_c in cs:
                    if not np.array_equal(al[ix], al_c):
                        continue
                    g = (float(np.abs(mu[ix] - mu_c).max()),
                         float(np.abs(std[ix] - std_c).max()))
                    if best is None or max(g) < max(best):
                        best = g
                if best is None:
                    mismatch += 1
                else:
                    mu_gap, std_gap = max(mu_gap, best[0]), max(std_gap,
                                                                best[1])
        return {"mu_gap_m": mu_gap, "std_gap_m": std_gap,
                "alpha_mismatch": mismatch,
                "ambiguous_share": skipped / max(sets, 1)}
