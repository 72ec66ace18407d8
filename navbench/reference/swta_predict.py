"""Plain reference of the SWTA predictor's output for a batch of lanes.

From world-frame pedestrian histories to the (mu, std, alpha) slots the
MPC reads, as the reference repository's pipeline defines them
(`pkg_motion_prediction`: inputs, net, obstacle snap; `utils_test`:
DBSCAN with eps 1 m and min_samples 2, then an axis-aligned Gaussian per
cluster with its std enlarged): histories -> pixel frame -> input stacks
for every offset 1..N -> the net (`swta_net`, eval mode) -> hypotheses
inside an obstacle move to the nearest obstacle-edge cell -> world frame
-> clusters, in slots ordered by their first member, at most
`max_clusters` of them.

Clustering and the snap are discontinuous: a pair of hypotheses at eps
or a hypothesis on a cell's edge can go either way under rounding.  So
each (lane, offset) set gets every answer that moving its hypotheses by
`delta_px` (the snap) and its pair distances by `delta_m` (the eps-graph)
can give, and an answer is held to the nearest of them; a set with too
many such answers is left out (ambiguous).
"""
from __future__ import annotations

import numpy as np
import torch

from . import swta_net


def snap_tables(ref_map: np.ndarray):
    """(occupied (H, W) bool, nearest row, nearest col (H, W)): for every
    cell the nearest cell of the obstacles' edge ring (the dilated
    obstacle mask less its erosion), on the map's occupancy 255 - gray."""
    from scipy import ndimage

    occ = 255.0 - np.asarray(ref_map, np.float64)
    occ = occ / max(occ.max(), 1e-9)
    occupied = occ > 0
    dilated = ndimage.binary_dilation(occupied, np.ones((3, 3)))
    edge = dilated & ~ndimage.binary_erosion(dilated)
    _, nearest = ndimage.distance_transform_edt(~edge, return_indices=True)
    return occupied, nearest[0], nearest[1]


def _snap(pts: np.ndarray, tables) -> np.ndarray:
    occupied, near_r, near_c = tables
    H, W = occupied.shape
    cols = np.clip(np.trunc(pts[..., 0]).astype(np.int64), 0, W - 1)
    rows = np.clip(np.trunc(pts[..., 1]).astype(np.int64), 0, H - 1)
    inside = occupied[rows, cols]
    out = pts.copy()
    out[..., 0] = np.where(inside, near_c[rows, cols], pts[..., 0])
    out[..., 1] = np.where(inside, near_r[rows, cols], pts[..., 1])
    return out


def _components(adj: np.ndarray) -> np.ndarray:
    """Component of each point of the graph `adj`, numbered by first
    member."""
    n = adj.shape[0]
    lab = -np.ones(n, np.int64)
    cur = 0
    for i in range(n):
        if lab[i] >= 0:
            continue
        lab[i], stack = cur, [i]
        while stack:
            j = stack.pop()
            for k in np.nonzero(adj[j] & (lab < 0))[0]:
                lab[k] = cur
                stack.append(k)
        cur += 1
    return lab


def cluster(points: np.ndarray, adj: np.ndarray, enlarge: float,
            max_clusters: int):
    """(mu (C, 2), std (C, 2), alpha (C,)) of one hypothesis set whose
    eps-graph is `adj`: clusters of two or more points in slots by their
    first member."""
    C = max_clusters
    mu, std, alpha = np.zeros((C, 2)), np.zeros((C, 2)), np.zeros(C)
    lab = _components(adj)
    slot = 0
    for c in range(lab.max() + 1):
        members = points[lab == c]
        if len(members) < 2:
            continue
        if slot == C:
            break
        mu[slot] = members.mean(0)
        std[slot] = members.std(0) * enlarge
        alpha[slot] = 1.0
        slot += 1
    return mu, std, alpha


def _snap_options(h: np.ndarray, tables, delta_px: float) -> list:
    """Where hypothesis h (px) may land after the snap when it moves by up
    to delta_px in x and y: itself where its cell is free, the cell's
    nearest edge cell where it is occupied."""
    occupied, near_r, near_c = tables
    H, W = occupied.shape
    out = []
    for dx in (-delta_px, 0.0, delta_px):
        for dy in (-delta_px, 0.0, delta_px):
            c = min(max(int(np.trunc(h[0] + dx)), 0), W - 1)
            r = min(max(int(np.trunc(h[1] + dy)), 0), H - 1)
            o = ((float(near_c[r, c]), float(near_r[r, c]))
                 if occupied[r, c] else (float(h[0]), float(h[1])))
            if o not in out:
                out.append(o)
    return out


class Predictor:
    """The reference predictor on `device` in `dtype`.

    cfg: the configuration file's "predictor" and "map" groups and the
    checkpoint path; ref_map: the (H, W) gray map channel.
    """

    def __init__(self, cfg: dict, ref_map: np.ndarray, checkpoint: str,
                 dtype=torch.float64, device="cpu", tf32: bool = False):
        self.cfg, self.dtype, self.device, self.tf32 = cfg, dtype, device, tf32
        self.map_np = np.asarray(ref_map, np.float64)
        self.ref_map = torch.as_tensor(self.map_np, dtype=dtype, device=device)
        self.tables = snap_tables(self.map_np)
        self.sd = swta_net.load(checkpoint, dtype, device)
        m = cfg["map"]
        self.k = np.array([m["scale2real"], m["scale2real"]])
        self.b = np.array(m["corner_coords"], np.float64)
        self.ym, self.yr = float(m["sim_height"]), not m["image_axis"]
        self.s2nn = float(m["scale2nn"])

    def world_to_px(self, xy):
        px = (xy - self.b) / self.k
        if self.yr:
            px = np.stack([px[..., 0], self.ym - px[..., 1]], -1)
        return px * self.s2nn

    def px_to_world(self, px):
        px = px / self.s2nn
        if self.yr:
            px = np.stack([px[..., 0], self.ym - px[..., 1]], -1)
        return px * self.k + self.b

    def hypotheses(self, hist_world: np.ndarray, block: int = 64):
        """(B, 5, H, 2) histories -> (B, N, H, M, 2) hypotheses in pixels,
        before the snap."""
        N = self.cfg["predictor"]["n_hor"]
        B, L, Hh = hist_world.shape[:3]
        trajs = self.world_to_px(np.swapaxes(hist_world, 1, 2).astype(
            np.float64)).reshape(B * Hh, L, 2)
        t = torch.as_tensor(trajs, dtype=self.dtype, device=self.device)
        t = t[:, None].expand(B * Hh, N, L, 2).reshape(B * Hh * N, L, 2)
        off = torch.arange(1, N + 1, dtype=self.dtype, device=self.device
                           ).repeat(B * Hh)
        outs = []
        cudnn = torch.backends.cudnn
        matmul = torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        try:
            matmul.allow_tf32 = self.tf32
            with torch.no_grad(), cudnn.flags(
                    enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                    deterministic=cudnn.deterministic, allow_tf32=self.tf32):
                for s in range(0, t.shape[0], block):
                    x = swta_net.input_stack(t[s:s + block], self.ref_map,
                                             off[s:s + block])
                    outs.append(swta_net.forward(self.sd, x).double().cpu())
        finally:
            matmul.allow_tf32 = saved
        hyp = torch.cat(outs).numpy().reshape(B, Hh, N, -1, 2)
        return np.swapaxes(hyp, 1, 2)

    def candidates(self, hyp: np.ndarray, delta_m: float, delta_px: float,
                   cap: int = 64):
        """Every answer one set of hypotheses (M, 2) px may round to: each
        hypothesis's snap options within delta_px, and for each, each pair
        within delta_m of eps joined or not.  A list of (mu, std, alpha),
        or None past `cap` candidates (the set is ambiguous)."""
        from itertools import product

        p = self.cfg["predictor"]
        eps, C = p["eps"], p["max_clusters"]
        options = [_snap_options(h, self.tables, delta_px) for h in hyp]
        choices = [range(len(o)) for o in options]
        n_snap = int(np.prod([len(o) for o in options]))
        if n_snap > cap:
            return None
        out = []
        for pick in product(*choices):
            px = np.array([o[k] for o, k in zip(options, pick)])
            pts = self.px_to_world(px)
            d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
            adj = d <= eps - delta_m
            iu = np.argwhere(np.triu(np.abs(d - eps) < delta_m, 1))
            if n_snap * 2 ** len(iu) > cap:
                return None
            for bits in product((False, True), repeat=len(iu)):
                a = adj.copy()
                for (i, j), b in zip(iu, bits):
                    a[i, j] = a[j, i] = b
                out.append(cluster(pts, a, p["enlarge"], C))
        return out

    def predict(self, hist_world: np.ndarray, delta_m: float = 5e-3,
                delta_px: float = 0.05):
        """For (B, 5, H, 2) world-frame histories: the candidates of every
        (lane, offset, pedestrian) set, {(b, n, h): list or None}."""
        hyp = self.hypotheses(hist_world)
        return {ix: self.candidates(hyp[ix], delta_m, delta_px)
                for ix in np.ndindex(*hyp.shape[:3])}

    def answer(self, hist_world: np.ndarray):
        """This predictor's own answer, (mu (B, N, H, C, 2), std, alpha):
        the candidate with no rounding moved (the control's answer)."""
        p = self.cfg["predictor"]
        hyp = self.hypotheses(hist_world)
        world = self.px_to_world(_snap(hyp, self.tables))
        lead, C = hyp.shape[:3], p["max_clusters"]
        mu, std = np.zeros(lead + (C, 2)), np.zeros(lead + (C, 2))
        alpha = np.zeros(lead + (C,))
        for ix in np.ndindex(*lead):
            pts = world[ix]
            adj = ((pts[:, None] - pts[None]) ** 2).sum(-1) <= p["eps"] ** 2
            mu[ix], std[ix], alpha[ix] = cluster(pts, adj, p["enlarge"], C)
        return mu, std, alpha
