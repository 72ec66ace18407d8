"""SWTA multimodal motion-prediction network, the port of
`dyobav_tpu.models.wta_net`.

The reference's predictor (`pkg_motion_prediction/net_module/net.py`) as
NCHW `nn.Module`s whose `state_dict` keys are the reference's own
(`resnet34.stem.conv1.{0,1}`, `resnet34.layer{s}.{i}.conv{1,2}.{0,1}`,
`...downsample.{0,1}`, `fc1`, `swarm.layer_hypos`), so the reference's
checkpoints load strictly:

  ConvMultiHypoNet
    = ResNet34Lite backbone (stem conv7x7/s2 + maxpool3x3/s2, channels
      [16, 32, 64, 128], blocks [3, 4, 6, 3], LeakyReLU(0.1) in conv layers
      / LeakyReLU(0.01) after residual adds, avgpool 2x2)
    -> FC(fc_input -> 128) + LeakyReLU(0.01)
    -> linear head 128 -> dim_out * num_hypos.

Input is the 7-channel image stack (5 past-position heat maps, the map
channel, the pred-offset channel) as (B, 7, H, W); output (B, num_hypos,
dim_out).  The convolutions, BatchNorm (eval mode, eps 1e-5), pooling and
dense layers are the JAX package's XLA operations and stay `torch.nn`
layers (cuDNN / cuBLAS on the card).  Activations after a BatchNorm and the
residual add run in place; autograd takes them in train mode too.

`ConvMultiHypoNet.forward_offsets` is the predictor's inference path for
images that share all channels but the constant offset: the lite stem's
convolution runs once on the shared channels and a hand-written kernel
(`ops/stem.py`) expands it over the offsets through BatchNorm, LeakyReLU
and the max pool; the stages after the stem (`ResNet34Lite.trunk`) are
`forward`'s.

In train mode BatchNorm follows Flax's `BatchNorm(momentum=0.9)`: it
normalizes with the batch's own statistics and moves the running variance
toward the batch's *biased* variance (torch's own rule takes the unbiased
one, n / (n - 1) times larger: 1.067x over the 16 values a channel has at
a 2 x 2 last stage and a batch of 4).  Eval mode is torch's BatchNorm.
"""
from __future__ import annotations

import contextlib
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_CONV = 0.1    # slope inside conv layers (submodules.py:24)
LEAKY_POST = 0.01   # torch nn.LeakyReLU default (block output, net.py:52)


@contextlib.contextmanager
def full_f32():
    """Run convolutions and matrix products in full float32, as the JAX
    package's default `dtype` asks: cuDNN's TF32 off for the block (its
    other settings kept) and cuBLAS's TF32 off, both restored after."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            if saved:
                matmul.allow_tf32 = False
            yield
    finally:
        if saved:
            matmul.allow_tf32 = saved


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, momentum 0.1) whose train-mode update of
    the running statistics is Flax's: running = 0.9 running + 0.1 batch,
    with the batch's biased variance.  Eval mode is the parent's forward,
    and the state_dict keys are the parent's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class ConvBNLeaky(nn.Sequential):
    """conv (bias only without BN) -> BatchNorm -> LeakyReLU(0.1); keys
    `0` (conv) and `1` (BN)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, use_bn: bool = True,
                 activate: bool = True):
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                            bias=not use_bn)]
        if use_bn:
            layers.append(BatchNorm2d(out_ch))
        super().__init__(*layers)
        self.activate = activate

    def forward(self, x):
        x = super().forward(x)
        if self.activate:
            x = F.leaky_relu(x, LEAKY_CONV, inplace=True)
        return x


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 use_bn: bool = True):
        super().__init__()
        self.conv1 = ConvBNLeaky(in_ch, out_ch, 3, stride, 1, use_bn)
        self.conv2 = ConvBNLeaky(out_ch, out_ch, 3, 1, 1, use_bn,
                                 activate=False)
        # The JAX block always adds BatchNorm to its shortcut.
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            BatchNorm2d(out_ch))
            if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        out += identity
        return F.leaky_relu(out, LEAKY_POST, inplace=True)


class _Stem(nn.Module):
    def __init__(self, in_ch: int, stem_features: int, deep: bool,
                 use_bn: bool):
        super().__init__()
        if deep:
            # Deep stem (net.py:29-33): 3x3/s2 + 3x3 + 3x3, 32/32/64 ch.
            self.conv1 = ConvBNLeaky(in_ch, 32, 3, 2, 1, use_bn)
            self.conv2 = ConvBNLeaky(32, 32, 3, 1, 1, use_bn)
            self.conv3 = ConvBNLeaky(32, stem_features, 3, 1, 1, use_bn)
        else:
            self.conv1 = ConvBNLeaky(in_ch, stem_features, 7, 2, 3, use_bn)

    def forward(self, x):
        for conv in self.children():
            x = conv(x)
        return x


class ResNet34Lite(nn.Module):
    deep_stem = False

    def __init__(self, in_ch: int = 7,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_features: int = 64, use_bn: bool = True):
        super().__init__()
        self.stem = _Stem(in_ch, stem_features, self.deep_stem, use_bn)
        ch_in = stem_features
        for stage, (ch, nb) in enumerate(zip(channels, blocks)):
            stride = 1 if stage == 0 else 2
            layer = [BasicBlock(ch_in, ch, stride, use_bn)]
            layer += [BasicBlock(ch, ch, 1, use_bn) for _ in range(nb - 1)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
            ch_in = ch
        self.n_stages = len(channels)

    def forward(self, x):
        return self.trunk(self.stem_block(x))

    def stem_block(self, x):
        """The stem and its 3x3/s2 max pool, with -inf padding as flax's
        max_pool pads."""
        return F.max_pool2d(self.stem(x), 3, 2, padding=1)

    def trunk(self, x):
        """The stages after the stem block, then the 2x2/s2 average pool
        (VALID)."""
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return F.avg_pool2d(x, 2, 2)


class ResNet34(ResNet34Lite):
    """Full-width variant (net.py:85-105): deep stem, channels 64..512."""
    deep_stem = True

    def __init__(self, in_ch: int = 7,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_features: int = 64, use_bn: bool = True):
        super().__init__(in_ch, channels, blocks, stem_features, use_bn)


class _Swarm(nn.Module):
    """The reference's MultiHypothesisModule (module_wta.py:18-43): one
    linear layer to all hypotheses."""

    def __init__(self, in_features: int, dim_out: int, num_hypos: int):
        super().__init__()
        self.layer_hypos = nn.Linear(in_features, dim_out * num_hypos)

    def forward(self, x):
        return self.layer_hypos(x)


class ConvMultiHypoNet(nn.Module):
    """Backbone -> FC -> multi-hypothesis linear head.

    lite=True (default) uses ResNet34Lite + FC(128); lite=False the
    full-width ResNet34 + FC(1024), matching net.py:113-131.  `fc_input` is
    the flattened feature map: 128 x 5 x 5 = 3200 at a 293 x 330 input.
    `channels`, `blocks` and `stem_features` narrow the backbone (None: the
    reference's widths).
    """

    def __init__(self, dim_out: int = 2, num_hypos: int = 20,
                 lite: bool = True, use_bn: bool = True,
                 input_channel: int = 7, fc_input: int = 3200,
                 channels: Sequence[int] | None = None,
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_features: int = 64):
        super().__init__()
        backbone = ResNet34Lite if lite else ResNet34
        kw = {} if channels is None else {"channels": tuple(channels)}
        self.resnet34 = backbone(input_channel, blocks=tuple(blocks),
                                 stem_features=stem_features, use_bn=use_bn,
                                 **kw)
        fc_features = 128 if lite else 1024
        self.fc1 = nn.Linear(fc_input, fc_features)
        self.swarm = _Swarm(fc_features, dim_out, num_hypos)
        self.dim_out, self.num_hypos = dim_out, num_hypos

    def forward(self, x):
        return self._head(self.resnet34(x))

    def _head(self, feat):
        feat = feat.reshape(feat.shape[0], -1)       # NCHW flatten
        feat = F.leaky_relu(self.fc1(feat), LEAKY_POST)
        hypos = self.swarm(feat)
        return hypos.reshape(hypos.shape[0], self.num_hypos, self.dim_out)

    def factored_stem(self):
        """(conv, bn) of a stem that factors over the offset channel, else
        None.  It factors where the stem is one bias-free convolution
        followed by BatchNorm and LeakyReLU (the lite stem): the
        convolution is then linear in the offset channel.  A deep stem
        has a nonlinearity between its convolutions and does not."""
        blocks = list(self.resnet34.stem.children())
        if len(blocks) != 1:
            return None
        block = blocks[0]
        if len(block) != 2 or not block.activate:
            return None
        conv, bn = block
        if conv.bias is not None or not isinstance(bn, nn.BatchNorm2d):
            return None
        return conv, bn

    def forward_offsets(self, shared, offsets):
        """`forward` of the images that share all channels but the last,
        a constant offset, in full float32 (`full_f32`).

        shared (P, C - 1, H, W): each pedestrian's channels but the
        offset's; offsets (K,).  Returns (P * K, num_hypos, dim_out) in
        (pedestrian, offset) order, what `forward` gives on the (P, K, C,
        H, W) stacks of `models.heatmap.traj_to_input_stack` reshaped to
        (P * K, C, H, W), up to the order of the stem's float32 sums.

        The stem convolution is linear and has no bias, so the convolution
        of the image of offset o is conv(shared) + o * conv(ones): the
        shared channels are convolved once per pedestrian, the offset
        channel's weights over an all-ones image with the same zero
        padding (a fixed map, not constant near the border), and
        `ops.stem.stem_expand_pool` expands them over the offsets with
        BatchNorm's eval affine, LeakyReLU and the max pool.  The span
        `predict.stem` covers those three steps.  Eval mode and no grad
        only: BatchNorm with batch statistics does not factor."""
        from ..ops.stem import stem_expand_pool
        from ..utils.profiling import span

        if self.training or torch.is_grad_enabled():
            raise RuntimeError("forward_offsets runs in eval mode under "
                               "torch.no_grad() only")
        parts = self.factored_stem()
        if parts is None:
            raise ValueError("forward_offsets: this net's stem does not "
                             "factor over the offset channel")
        conv, bn = parts
        n = conv.in_channels - 1
        if shared.dim() != 4 or shared.shape[1] != n:
            raise ValueError(f"forward_offsets: shared {tuple(shared.shape)}"
                             f", expected (P, {n}, H, W)")
        offsets = torch.as_tensor(offsets, dtype=shared.dtype,
                                  device=shared.device)
        w = conv.weight
        with full_f32():
            with span("predict.stem", shared):
                s = F.conv2d(shared, w[:, :n], None, conv.stride,
                             conv.padding)
                ones = torch.ones((1, 1) + tuple(shared.shape[2:]),
                                  dtype=shared.dtype, device=shared.device)
                m = F.conv2d(ones, w[:, n:], None, conv.stride,
                             conv.padding)[0]
                scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                shift = bn.bias - bn.running_mean * scale
                x = stem_expand_pool(s, m, offsets, scale, shift)
            x = self.resnet34.trunk(x.reshape((-1,) + tuple(x.shape[2:])))
            return self._head(x)


def backbone_fc_input(height: int, width: int, channels: int = 128) -> int:
    """`fc_input` of a net on (height, width) inputs: the flattened size of
    the backbone's feature map (stem /2, max pool /2, three stride-2
    stages, 2 x 2 average pool), 128 x 5 x 5 = 3200 at 293 x 330."""
    def down(n):
        for _ in range(5):
            n = (n - 1) // 2 + 1
        return n // 2
    return channels * down(height) * down(width)


def load_checkpoint(path: str, device=None, config=None) -> ConvMultiHypoNet:
    """The trained net from a reference-schema torch `state_dict` file,
    strictly loaded (`torch.load(..., weights_only=True)`), in eval mode on
    `device` (None: the current CUDA device; raises without one).  `config`
    is a `configs.WtaNetConfiguration` (None: the default)."""
    from ..configs import WtaNetConfiguration
    from ..ops.engine import resolve_device

    device = resolve_device(device)
    cfg = config or WtaNetConfiguration()
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no SWTA checkpoint at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = ConvMultiHypoNet(dim_out=cfg.dim_out, num_hypos=cfg.num_hypos,
                           input_channel=cfg.input_channel,
                           fc_input=cfg.fc_input)
    net.load_state_dict(sd, strict=True)
    return net.to(device).eval()
