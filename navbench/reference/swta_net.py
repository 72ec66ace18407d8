"""Plain reference of the SWTA motion-prediction net and its inputs.

The reference repository's `ConvMultiHypoNet` (`pkg_motion_prediction/
net_module/net.py`, lite backbone) written as functional PyTorch over a
`state_dict` with the reference's key names:

  stem   conv 7x7 / 2 (pad 3) -> BatchNorm -> LeakyReLU(0.1)
  pool   max 3x3 / 2 (pad 1)
  stages channels (16, 32, 64, 128), blocks (3, 4, 6, 3), stride 2 from
         the second stage; a block is conv 3x3 -> BN -> LeakyReLU(0.1) ->
         conv 3x3 -> BN, plus the shortcut (1x1 conv -> BN where the shape
         changes), then LeakyReLU(0.01)
  head   average 2x2 / 2, flatten (NCHW), fc1 -> LeakyReLU(0.01), one
         linear layer to num_hypos x dim_out

BatchNorm has eps 1e-5.  In training it normalizes with the batch's own
statistics (biased variance) and moves the running statistics 10 % toward
the batch's mean and biased variance, the rule the SWTA recipe trains with
(Flax's `BatchNorm(momentum=0.9)`).  The input stack is five Gaussian
bumps (sigma 20 px, each normalized to peak 1) at the past positions, the
map channel and a constant channel holding the prediction offset.

`flops_per_image` counts the net's operations from these shapes alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STEM = 64
CHANNELS = (16, 32, 64, 128)
BLOCKS = (3, 4, 6, 3)
FC = 128
LEAKY_CONV, LEAKY_POST, BN_EPS, BN_MOMENTUM = 0.1, 0.01, 1e-5, 0.1


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def flops_per_image(height: int, width: int, in_ch: int = 7,
                    num_hypos: int = 20, dim_out: int = 2) -> int:
    """2 x the multiply-adds of the convolutions and dense layers of one
    forward on a (in_ch, height, width) image; BatchNorm, activations and
    pooling (under 1 % of them) are not counted."""
    total = 0

    def conv(h, w, cin, cout, k, s, p):
        nonlocal total
        ho, wo = _out(h, k, s, p), _out(w, k, s, p)
        total += 2 * cout * ho * wo * cin * k * k
        return ho, wo

    h, w = conv(height, width, in_ch, STEM, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = STEM
    for stage, (ch, nb) in enumerate(zip(CHANNELS, BLOCKS)):
        for b in range(nb):
            s = 2 if (stage > 0 and b == 0) else 1
            h1, w1 = conv(h, w, cin, ch, 3, s, 1)
            conv(h1, w1, ch, ch, 3, 1, 1)
            if s != 1 or cin != ch:
                conv(h, w, cin, ch, 1, s, 0)
            h, w, cin = h1, w1, ch
    h, w = h // 2, w // 2
    fc_in = cin * h * w
    total += 2 * fc_in * FC + 2 * FC * num_hypos * dim_out
    return total


def gaussian_bumps(centers: torch.Tensor, height: int, width: int,
                   sigma: float = 20.0) -> torch.Tensor:
    """(..., 2) centers (x, y) px -> (..., height, width) bumps of peak 1."""
    dt = centers.dtype
    x = torch.arange(width, dtype=dt, device=centers.device)
    y = torch.arange(height, dtype=dt, device=centers.device)
    gx = (x - centers[..., 0, None]) ** 2
    gy = (y - centers[..., 1, None]) ** 2
    z = torch.exp(-(gx[..., None, :] + gy[..., :, None]) / (2.0 * sigma ** 2))
    peak = z.amax(dim=(-2, -1), keepdim=True)
    return z / peak.clamp_min(1e-12)


def input_stack(trajs: torch.Tensor, ref_map: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """trajs (B, 5, 2) px, ref_map (H, W), offsets (B,) -> (B, 7, H, W)."""
    H, W = ref_map.shape
    bumps = gaussian_bumps(trajs, H, W)                      # (B, 5, H, W)
    B = trajs.shape[0]
    return torch.cat([bumps, ref_map.to(trajs.dtype).expand(B, 1, H, W),
                      offsets.to(trajs.dtype)[:, None, None, None].expand(
                          B, 1, H, W)], 1)


def _bn(x, sd, key, train, new_stats):
    w, b = sd[key + ".weight"], sd[key + ".bias"]
    if not train:
        return F.batch_norm(x, sd[key + ".running_mean"],
                            sd[key + ".running_var"], w, b, False, 0.0, BN_EPS)
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    y = (x - mean[None, :, None, None]) / torch.sqrt(
        var[None, :, None, None] + BN_EPS)
    if new_stats is not None:
        rm, rv = sd[key + ".running_mean"], sd[key + ".running_var"]
        new_stats[key + ".running_mean"] = (
            rm + BN_MOMENTUM * (mean.detach() - rm))
        new_stats[key + ".running_var"] = (
            rv + BN_MOMENTUM * (var.detach() - rv))
    return y * w[None, :, None, None] + b[None, :, None, None]


def _conv_bn(x, sd, key, stride, pad, train, stats, act=True):
    x = F.conv2d(x, sd[key + ".0.weight"], None, stride, pad)
    x = _bn(x, sd, key + ".1", train, stats)
    return F.leaky_relu(x, LEAKY_CONV) if act else x


def forward(sd: dict, x: torch.Tensor, train: bool = False,
            stats: dict | None = None) -> torch.Tensor:
    """Hypotheses (B, num_hypos, 2) of images x (B, 7, H, W) under the
    parameters `sd` (reference key names).  With train=True and a dict
    `stats`, the new running statistics are written into it."""
    p = "resnet34."
    x = _conv_bn(x, sd, p + "stem.conv1", 2, 3, train, stats)
    x = F.max_pool2d(x, 3, 2, padding=1)
    cin = STEM
    for stage, (ch, nb) in enumerate(zip(CHANNELS, BLOCKS)):
        for b in range(nb):
            s = 2 if (stage > 0 and b == 0) else 1
            key = f"{p}layer{stage + 1}.{b}"
            if s != 1 or cin != ch:
                idn = F.conv2d(x, sd[key + ".downsample.0.weight"], None, s)
                idn = _bn(idn, sd, key + ".downsample.1", train, stats)
            else:
                idn = x
            out = _conv_bn(x, sd, key + ".conv1", s, 1, train, stats)
            out = _conv_bn(out, sd, key + ".conv2", 1, 1, train, stats,
                           act=False)
            x = F.leaky_relu(out + idn, LEAKY_POST)
            cin = ch
    x = F.avg_pool2d(x, 2, 2)
    x = x.reshape(x.shape[0], -1)
    x = F.leaky_relu(F.linear(x, sd["fc1.weight"], sd["fc1.bias"]), LEAKY_POST)
    h = F.linear(x, sd["swarm.layer_hypos.weight"], sd["swarm.layer_hypos.bias"])
    return h.reshape(h.shape[0], -1, 2)


def load(path: str, dtype, device) -> dict:
    """The trained net's `state_dict` file, as `dtype` tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.to(device=device, dtype=dtype) if v.is_floating_point()
                else v.to(device)) for k, v in sd.items()}
