"""Mixture-density network variants of the predictor head, the port of
`dyobav_tpu.models.mdn`.

The reference's MDN alternatives (`pkg_motion_prediction/net_module/
module_mdn.py` and the MDN nets in `net.py:145-226`) as NCHW `nn.Module`s
on the port's `ResNet34Lite`:

  * `ClassicMixtureDensityModule`: one linear layer emitting (alpha, mu,
    sigma) for M diagonal Gaussians (module_mdn.py:6-22);
  * `SamplingMixtureDensityModule`: soft-assignment GMM fit over the K WTA
    hypotheses, responsibilities from a learned K x M mapping, then the
    weighted mean / variance per component (module_mdn.py:24-58),
    vectorized;
  * the component-selection helpers `take_main_components` /
    `take_good_components` (module_mdn.py:60-103);
  * the assemblies `ConvMixtureDensityNet` / `ConvMultiHypoMixtureDensityFit`
    and the two-stage `conv_mixture_density_fit` (net.py:145-226).

The backbone's feature map is flattened channel-major (NCHW), where the
JAX package flattens it NHWC; `convert.mdn_state_dict_from_flax` permutes
`fc1`'s input axis accordingly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .wta_net import LEAKY_POST, ResNet34Lite


class ClassicMixtureDensityModule(nn.Module):
    def __init__(self, in_features: int, dim_output: int,
                 num_components: int):
        super().__init__()
        self.dim_output, self.num_components = dim_output, num_components
        self.layer = nn.Linear(in_features,
                               (2 * dim_output + 1) * num_components)

    def forward(self, x):
        M, C = self.num_components, self.dim_output
        p = self.layer(x)
        alpha = torch.softmax(p[:, :M], dim=1)
        mu = p[:, M:(C + 1) * M].reshape(-1, M, C)
        sigma = torch.exp(p[:, (C + 1) * M:]).reshape(-1, M, C)
        return alpha, mu, sigma


class SamplingMixtureDensityModule(nn.Module):
    def __init__(self, dim_input: int, num_hypos: int, num_gaus: int):
        super().__init__()
        self.dim_input, self.num_hypos, self.num_gaus = (dim_input, num_hypos,
                                                          num_gaus)
        self.layer = nn.Linear(dim_input * num_hypos, num_hypos * num_gaus)

    def forward(self, hypos_flat: torch.Tensor):
        """hypos_flat: (B, K*C) WTA hypotheses -> (alpha (B,M), mu (B,M,C),
        sigma^2 (B,M,C)) soft-fit GMM."""
        K, M, C = self.num_hypos, self.num_gaus, self.dim_input
        z = self.layer(hypos_flat).reshape(-1, K, M)
        xK = hypos_flat.reshape(-1, K, C)
        gamma = torch.softmax(z, dim=2)                   # (B, K, M)
        alpha = torch.sum(gamma, dim=1) / K               # (B, M)
        w = gamma / torch.clamp(torch.sum(gamma, dim=1, keepdim=True),
                                min=1e-12)
        mu = torch.einsum("bkm,bkc->bmc", w, xK)
        diff_sq = (xK[:, :, None, :] - mu[:, None, :, :]) ** 2
        sigma = torch.einsum("bkm,bkmc->bmc", w, diff_sq)
        return alpha, mu, sigma


def take_main_components(alp, mu, sigma, main: int = 3):
    """Largest-weight components of one GMM (module_mdn.py:60-86)."""
    alp, mu, sigma = alp[0], mu[0], sigma[0]
    if alp.shape[0] <= main:
        return alp[None], mu[None], sigma[None]
    order = torch.argsort(-alp, stable=True)[:main]
    return alp[order][None], mu[order][None], sigma[order][None]


def take_good_components(alp, mu, sigma, thre: float = 0.1):
    """Components above a fraction of the max weight (module_mdn.py:88-103),
    as host numpy arrays (the output length depends on the data)."""
    alp, mu, sigma = (np.asarray(a) for a in (alp, mu, sigma))
    if alp.shape[0] <= 1:
        return alp, mu, sigma
    idx = alp > thre * alp.max()
    return alp[idx], mu[idx], sigma[idx]


class _ConvFeatures(nn.Module):
    """ResNet34Lite -> NCHW flatten -> FC + LeakyReLU(0.01), the trunk both
    MDN nets share (keys `resnet34.*`, `fc1`)."""

    def __init__(self, input_channel: int, fc_input: int, fc_features: int,
                 use_bn: bool):
        super().__init__()
        self.resnet34 = ResNet34Lite(input_channel, use_bn=use_bn)
        self.fc1 = nn.Linear(fc_input, fc_features)

    def features(self, x):
        feat = self.resnet34(x)
        return F.leaky_relu(self.fc1(feat.reshape(feat.shape[0], -1)),
                            LEAKY_POST)


class ConvMixtureDensityNet(_ConvFeatures):
    """Backbone -> FC -> classic MDN head (net.py:145-171)."""

    def __init__(self, dim_out: int = 2, num_components: int = 20,
                 fc_features: int = 128, use_bn: bool = True,
                 input_channel: int = 7, fc_input: int = 3200):
        super().__init__(input_channel, fc_input, fc_features, use_bn)
        self.mdn = ClassicMixtureDensityModule(fc_features, dim_out,
                                               num_components)

    def forward(self, x):
        return self.mdn(self.features(x))


class ConvMultiHypoMixtureDensityFit(_ConvFeatures):
    """Backbone -> FC -> WTA hypotheses -> sampling-MDN fit
    (net.py:194-226)."""

    def __init__(self, dim_out: int = 2, num_hypos: int = 20,
                 num_gaus: int = 5, fc_features: int = 128,
                 use_bn: bool = True, input_channel: int = 7,
                 fc_input: int = 3200):
        super().__init__(input_channel, fc_input, fc_features, use_bn)
        self.layer_hypos = nn.Linear(fc_features, dim_out * num_hypos)
        self.smdn = SamplingMixtureDensityModule(dim_out, num_hypos,
                                                 num_gaus)

    def forward(self, x):
        return self.smdn(self.layer_hypos(self.features(x)))


def conv_mixture_density_fit(wta_net, smdn_module):
    """Two-stage `ConvMixtureDensityFit` (net.py:174-191): a trained WTA net
    (frozen by the caller) + a trainable sampling-MDN head.  Returns
    apply(x) -> (alpha, mu, sigma^2)."""
    def apply(x):
        hypos = wta_net(x)                                # (B, K, C)
        return smdn_module(hypos.reshape(hypos.shape[0], -1))
    return apply
