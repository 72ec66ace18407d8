"""Cluster-Gaussian-Fit (CGF) of the WTA hypotheses, the port of
`dyobav_tpu.ops.cluster`.

The reference clusters the predicted hypotheses of each horizon step with
sklearn DBSCAN (eps=1, min_samples=2) and fits an axis-aligned Gaussian per
cluster (`utils_test.fit_DBSCAN` / `fit_cluster2gaussian`).  With
min_samples=2 DBSCAN is exactly the connected components of the
eps-adjacency graph with singleton components dropped as noise, so the
on-device version (`cluster_gaussian_fit`) takes the transitive closure of
the adjacency by ceil(log2 n) boolean squarings (`cluster_membership`) and
masked segment statistics into fixed `max_clusters` slots: no `nonzero`,
no host sync; no matrix product touches the coordinates, so the caller's
TF32 setting cannot round them.  `fit_dbscan_np` and `fit_cluster2gaussian`
are the host-side mirrors the tests hold it against.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def fit_dbscan_np(data: np.ndarray, eps: float, min_sample: int
                  ) -> List[np.ndarray]:
    """Host-side DBSCAN for min_sample <= 2: eps-graph components (in order
    of their smallest member), singletons dropped."""
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    if n == 0:
        return []
    d2 = np.sum((data[:, None] - data[None]) ** 2, axis=-1)
    adj = d2 <= eps * eps
    labels = -np.ones(n, dtype=int)
    current = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        stack = [i]                                   # BFS over the eps graph
        labels[i] = current
        while stack:
            j = stack.pop()
            for k in np.where(adj[j])[0]:
                if labels[k] < 0:
                    labels[k] = current
                    stack.append(k)
        current += 1
    clusters = []
    for c in range(current):
        members = np.where(labels == c)[0]
        if members.size >= min_sample:
            clusters.append(data[members])
    return clusters


def fit_cluster2gaussian(clusters: List[np.ndarray], enlarge: float = 1.0,
                         extra_margin: float = 0.0
                         ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-cluster mean and (enlarged) std (utils_test.py:145-151)."""
    mu_list, std_list = [], []
    for cluster in clusters:
        mu_list.append(np.mean(cluster, axis=0))
        std_list.append(np.std(cluster, axis=0) * enlarge + extra_margin)
    return mu_list, std_list


def cluster_membership(points: torch.Tensor, eps: float = 1.0,
                       max_clusters: int = 8) -> torch.Tensor:
    """(..., n, 2) points -> (..., max_clusters, n) bool: point j belongs to
    the cluster in slot c.  Clusters are the eps-graph's components of two
    or more points, in slots by their smallest member index; those ranked
    max_clusters or later are dropped."""
    n = points.shape[-2]
    dev = points.device
    d2 = torch.sum((points[..., :, None, :] - points[..., None, :, :]) ** 2,
                   dim=-1)
    reach = d2 <= eps * eps                               # (..., n, n), refl.
    # Transitive closure by repeated boolean squaring (0/1 products: exact
    # under TF32 too).
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        r = reach.to(points.dtype)
        reach = reach | ((r @ r) > 0)

    # Component label = smallest reachable index.
    idx = torch.arange(n, device=dev)
    label = torch.amin(torch.where(reach, idx, n), dim=-1)          # (..., n)
    comp_size = torch.sum(label[..., :, None] == label[..., None, :], dim=-1)
    valid = comp_size >= 2                                # singleton = noise

    # Roots (label == own index, valid), ranked by index into cluster slots;
    # every point inherits its root's slot.
    is_root = (label == idx) & valid
    rank = torch.cumsum(is_root.to(torch.int64), dim=-1) - 1
    slot_of_point = torch.where(is_root, rank, -1)
    root_slot = torch.gather(slot_of_point, -1, label)
    slots = torch.arange(max_clusters, device=dev)
    return (root_slot[..., None, :] == slots[:, None]) & valid[..., None, :]


def cluster_gaussian_fit(points: torch.Tensor, eps: float = 1.0,
                         enlarge: float = 2.0, extra_margin: float = 0.0,
                         max_clusters: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """On-device CGF of hypothesis sets with any leading dims.

    Args:
        points: (..., n, 2) hypotheses.
    Returns:
        mu:    (..., max_clusters, 2) cluster means (zeros when inactive)
        std:   (..., max_clusters, 2) enlarged stds (zeros when inactive)
        alpha: (..., max_clusters) 1.0 for active clusters else 0.0
    in the slots of `cluster_membership`.
    """
    member = cluster_membership(points, eps, max_clusters).to(points.dtype)
    count = torch.sum(member, dim=-1)                     # (..., C)
    alpha = (count > 0).to(points.dtype)
    safe = torch.clamp(count, min=1.0)[..., None]
    # Masked sums, not `member @ points`: a caller's TF32 setting would
    # round a matrix product's world coordinates (~15 m) by ~1e-2 m.
    mu = torch.sum(member[..., None] * points[..., None, :, :], dim=-2) / safe
    # Two passes, as np.std takes them: the mean of squared deviations.  The
    # JAX package's one pass, E[x^2] - mu^2, cancels in float32 at map
    # coordinates (E[x^2] ~ 225 m^2 holds only ~1e-5 m^2 of a variance).
    dev = points[..., None, :, :] - mu[..., :, None, :]     # (..., C, n, 2)
    var = torch.sum(member[..., None] * dev * dev, dim=-2) / safe
    std = torch.sqrt(var) * enlarge + extra_margin
    return mu * alpha[..., None], std * alpha[..., None], alpha


def cluster_gaussian_fit_horizon(points_t: torch.Tensor, eps: float = 1.0,
                                 enlarge: float = 2.0,
                                 extra_margin: float = 0.0,
                                 max_clusters: int = 8):
    """`cluster_gaussian_fit` over the horizon axis, the JAX package's name
    for it: points_t (T, n, 2) -> (T, max_clusters, 2 / 2 / .)."""
    return cluster_gaussian_fit(points_t, eps, enlarge, extra_margin,
                                max_clusters)
