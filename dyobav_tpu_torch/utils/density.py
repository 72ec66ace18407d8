"""Density-estimation utilities for evaluating multimodal predictions, the
port of `dyobav_tpu.utils.density`.

The evaluation helpers of the reference's `src/utils_test.py`: Gaussian
kernel + Parzen-window density (:16-30), per-component Gaussian
probabilities and mixture evaluation (:43-77), as float32 torch functions
on batches of hypotheses.
"""
from __future__ import annotations

import math

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def gaussian_kernel(x, mu=None, sigma: float = 0.05) -> torch.Tensor:
    """Isotropic 2-D Gaussian kernel value(s) at x (..., 2)."""
    x = _f32(x)
    if mu is not None:
        x = x - _f32(mu, x.device)
    det = sigma * sigma
    quad = torch.sum(x * x, dim=-1) / sigma
    return torch.exp(-quad / 2.0) / (2.0 * math.pi * math.sqrt(det))


def parzen_density(x, data, bandwidth: float = 1.0,
                   sigma: float = 0.05) -> torch.Tensor:
    """Parzen-window density estimate of `data` (n, 2) at points x (..., 2)."""
    x = _f32(x)
    data = _f32(data, x.device)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    diff = (flat[:, None, :] - data[None, :, :]) / bandwidth
    k = gaussian_kernel(diff, sigma=sigma)
    return (torch.mean(k, dim=-1) / bandwidth).reshape(lead)


def gau_prob(mu: torch.Tensor, sigma: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Per-component diagonal-Gaussian probability: (B,G,C),(B,G,C),(B,C)
    -> (B,G)."""
    x = x[:, None, :]
    p = (torch.exp(-((x - mu) / sigma) ** 2 / 2)
         / (sigma * math.sqrt(2.0 * math.pi)))
    return torch.prod(p, dim=2)


def multi_gau_prob(alp, mu, sigma, x) -> torch.Tensor:
    """Mixture probability at x: weights (B,G) -> (B,)."""
    return torch.sum(alp * gau_prob(mu, sigma, x), dim=1)


def multi_gau_grid(alp, mu, sigma, xx: torch.Tensor, yy: torch.Tensor,
                   floor_ratio: float = 0.1) -> torch.Tensor:
    """Mixture density over a meshgrid, floored at `floor_ratio` x max
    (utils_test.cal_multiGauProbDistr semantics)."""
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
    p = multi_gau_prob(alp, mu, sigma, pts)
    p = torch.where(p < torch.amax(p) * floor_ratio, torch.zeros_like(p), p)
    return p.reshape(xx.shape)
