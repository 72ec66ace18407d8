"""Winner-takes-all meta-loss family and MDN losses, the port of
`dyobav_tpu.models.losses`.

The reference's loss zoo (`pkg_motion_prediction/net_module/loss_functions.py`):
  - `meta_loss` (:6-37): vanilla WTA (min over hypotheses), relaxed WTA,
    and evolving top-k WTA;
  - `ameta_loss` (:39-76): adaptive threshold-based clustering loss;
  - base per-hypothesis losses `loss_mse` / `loss_mae` / `loss_nll`
    (:236-263), with the reference's 1/B batch-size scaling;
  - Gaussian-mixture utilities `cal_gau_prob`, `loss_nll_mdn` (:190-204),
    `loss_mahalanobis` (:206-224), `loss_central_oracle` (:226-233).

Minima and maxima over hypotheses use `torch.amin` / `amax`, which split
the gradient evenly among tied entries as `jnp.min` does (`torch.min` with
a dim sends all of it to one index).  The k smallest distances come from
`torch.topk(..., largest=False)`, the counterpart of `jax.lax.top_k` on
negated distances.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


# ------------------------------------------------------------- base losses
def loss_mse(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, M, C) vs (B, M, C) -> (B, M); includes the reference's /B scaling
    (loss_functions.py:236-241)."""
    return torch.sum((data - labels) ** 2, dim=2) / data.shape[0]


def loss_mae(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(data - labels), dim=2) / data.shape[0]


def loss_msle(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.sum((torch.log(data) - torch.log(labels)) ** 2, dim=2)
            / data.shape[0])


def cal_gau_prob(mu: torch.Tensor, sigma: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """P(x) per diagonal Gaussian component: (B,M,C),(B,M,C),(B,C) -> (B,M)."""
    x = x[:, None, :]
    norm = torch.rsqrt(torch.tensor(2.0 * math.pi, dtype=mu.dtype,
                                    device=mu.device))
    prob = norm * torch.exp(-((x - mu) / sigma) ** 2 / 2) / sigma
    return torch.prod(prob, dim=2)


def loss_nll(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-hypothesis NLL where data rows are (x, y, sx, sy) (:255-263)."""
    mu, sigma = data[:, :, :2], data[:, :, 2:]
    return -torch.log(cal_gau_prob(mu, sigma, labels[:, 0, :]) + 1e-6)


# -------------------------------------------------------------- meta losses
def _distances(hypos, labels, base_loss):
    M = hypos.shape[1]
    return base_loss(hypos, labels[:, None, :].expand(-1, M, -1))


def _k_smallest_mean(D: torch.Tensor, k: int) -> torch.Tensor:
    topk = torch.topk(D, k, dim=1, largest=False).values
    return torch.mean(torch.sum(topk, dim=1)) / k


def meta_loss(hypos: torch.Tensor, labels: torch.Tensor,
              base_loss: Callable = loss_mse, k_top: int = 1,
              relax: float = 0.0) -> torch.Tensor:
    """WTA meta-loss (loss_functions.py:6-37).

    Args:
        hypos: (B, M, C) hypotheses.  labels: (B, C) ground truth.
        k_top=1, relax=0   -> vanilla WTA (min over hypotheses)
        k_top=1, relax>0   -> relaxed WTA
        k_top=n>1, relax=0 -> evolving WTA (mean of n smallest)
    """
    if not (k_top >= 0 and 0 <= relax < 1):
        raise ValueError(f"k_top {k_top} must be >= 0 and relax {relax} "
                         "in [0, 1)")
    M = hypos.shape[1]
    k_top = min(k_top, M)
    D = _distances(hypos, labels, base_loss)           # (B, M)

    if relax == 0.0 and k_top == 1:
        return torch.mean(torch.amin(D, dim=1))
    if relax > 0.0 and k_top == 1:
        loss = (1 - 2 * relax) * torch.mean(torch.amin(D, dim=1))
        return loss + relax / (M - 1) * torch.sum(torch.mean(D, dim=0))
    if relax == 0.0 and k_top > 1:
        return _k_smallest_mean(D, k_top)
    raise ValueError("Unknown meta-loss mode; check relax/k_top.")


def ameta_loss(hypos: torch.Tensor, labels: torch.Tensor,
               base_loss: Callable = loss_mse, k_top: int = 1) -> torch.Tensor:
    """Adaptive meta-loss (loss_functions.py:39-76): hypotheses within 10 %
    of the min-max distance band share the gradient."""
    M = hypos.shape[1]
    D = _distances(hypos, labels, base_loss)
    if k_top > 1:
        return _k_smallest_mean(D, min(k_top, M))
    d_min = torch.amin(D, dim=1)
    d_max = torch.amax(D, dim=1)
    thresh = d_min + 0.1 * (d_max - d_min)
    active = D <= thresh[:, None]
    if k_top == 0:
        D = d_min[:, None].expand(-1, M)
    return torch.sum(torch.mean(D * active, dim=0)) / M


# ------------------------------------------------------------ MDN utilities
def cal_multi_gau_prob(alp, mu, sigma, x):
    return torch.sum(alp * cal_gau_prob(mu, sigma, x), dim=1)


def loss_nll_mdn(alp, mu, sigma, data):
    """Mixture NLL (loss_functions.py:190-204)."""
    alp = alp / torch.sum(alp, dim=1, keepdim=True)
    return torch.mean(-torch.log(cal_multi_gau_prob(alp, mu, sigma, data)))


def loss_mahalanobis(alp, mu, sigma, data):
    """Weighted Mahalanobis distance (loss_functions.py:206-224)."""
    alp = alp / torch.sum(alp, dim=1, keepdim=True)
    diff = data[:, None, :] - mu
    md = torch.sqrt(diff[:, :, 0] ** 2 / sigma[:, :, 0]
                    + diff[:, :, 1] ** 2 / sigma[:, :, 1])
    return md, torch.sum(md * alp, dim=1)


def loss_central_oracle(mu, data):
    """Best-component squared error (loss_functions.py:226-233)."""
    mse = torch.sum((mu - data[:, None, :]) ** 2, dim=2)
    return torch.amin(mse, dim=1)


# ------------------------------------------------- manager loss adapters
# `NetworkManager` takes any (net, loss) pair; the adapters share one
# signature (outputs, labels, k_top, relax) -> scalar.

def wta_meta_loss(outputs, labels, k_top: int = 1, relax: float = 0.0):
    """Default SWTA objective: evolving/relaxed WTA over (B, M, C) hypos."""
    return meta_loss(outputs, labels, loss_mse, k_top=k_top, relax=relax)


def mdn_nll_loss(outputs, labels, k_top: int = 1, relax: float = 0.0):
    """Classic-MDN objective: mixture NLL; outputs = (alpha, mu, sigma) with
    sigma a standard deviation (`mdn.ClassicMixtureDensityModule`)."""
    del k_top, relax
    alp, mu, sigma = outputs
    return loss_nll_mdn(alp, mu, sigma, labels)


def smdn_nll_loss(outputs, labels, k_top: int = 1, relax: float = 0.0):
    """Sampling-MDN objective: mixture NLL; outputs = (alpha, mu, sigma^2)
    with a VARIANCE third element (`mdn.SamplingMixtureDensityModule`)."""
    del k_top, relax
    alp, mu, var = outputs
    return loss_nll_mdn(alp, mu, torch.sqrt(var + 1e-6), labels)


def default_k_top_schedule(num_epochs: int, num_hypos: int) -> list:
    """Evolving-WTA schedule: anneal k from M to 1 over training (the
    paper's coarse-to-fine recipe)."""
    if num_epochs <= 1:
        return [1] * num_epochs
    return [max(1, int(round(num_hypos * (1.0 - ep / (num_epochs - 1)) ** 2)))
            for ep in range(num_epochs)]
