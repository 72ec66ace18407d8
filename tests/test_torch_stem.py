"""The SWTA net's stem taken apart over the horizon offsets, on the CPU:
`models.wta_net.ConvMultiHypoNet.forward_offsets` against the 7-channel
`forward`, and `ops.stem.stem_expand_pool`'s plain version against the
unfused operators.  Tiny shapes and random weights with non-trivial
BatchNorm buffers keep the file to a few seconds; the kernel itself is held
to the plain version in tests/test_torch_wta_card.py on a card."""
import pytest
import torch
import torch.nn.functional as F

from dyobav_tpu_torch.models.heatmap import (traj_to_input_stack,
                                             traj_to_shared_stack)
from dyobav_tpu_torch.models.wta_net import (ConvMultiHypoNet,
                                             backbone_fc_input)
from dyobav_tpu_torch.ops import stem

torch.set_num_threads(1)

H, W = 37, 41                       # odd, so the pools take ragged edges


def _net(lite=True):
    torch.manual_seed(0)
    net = ConvMultiHypoNet(num_hypos=4, lite=lite,
                           fc_input=backbone_fc_input(H, W, channels=16),
                           channels=(4, 8, 8, 16), blocks=(1, 1, 1, 1),
                           stem_features=8)
    for mod in net.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.5, 0.5)
            mod.running_var.uniform_(0.5, 2.0)
            mod.weight.data.uniform_(0.5, 1.5)
            mod.bias.data.uniform_(-0.3, 0.3)
    return net.eval()


def _inputs():
    """Two pedestrians (the first walks out of a corner, so the offset
    channel's zero-padded border matters) and three offsets."""
    traj = torch.tensor([[[1.0 + i, 0.5 + 0.5 * i] for i in range(5)],
                         [[20.0 + i, 18.0 - i] for i in range(5)]])
    ref = torch.rand(H, W, generator=torch.Generator().manual_seed(1)) * 255
    return traj, ref, torch.tensor([1.0, 2.0, 3.0])


def test_forward_offsets_matches_forward():
    net = _net()
    traj, ref, offsets = _inputs()
    stack = traj_to_input_stack(traj, ref, offsets)        # (2, 3, 7, H, W)
    shared = traj_to_shared_stack(traj, ref)               # (2, 6, H, W)
    assert torch.equal(shared, stack[:, 0, :6])
    launches = stem.stem_expand_pool.launches
    with torch.no_grad():
        want = net(stack.reshape(-1, 7, H, W))
        got = net.forward_offsets(shared, offsets)
    assert got.shape == want.shape == (6, 4, 2)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, rel
    assert stem.stem_expand_pool.launches == launches    # the CPU: none


def test_plain_matches_unfused_operators_on_negative_inputs():
    """All-negative activations: the pool's skipped padding must not read
    as zeros."""
    gen = torch.Generator().manual_seed(2)
    P, K, C, Ho, Wo = 2, 3, 4, 9, 11
    s = -torch.rand(P, C, Ho, Wo, generator=gen) - 1.0
    m = torch.rand(C, Ho, Wo, generator=gen)
    offsets = torch.tensor([0.25, 0.5, 1.0])
    mean = torch.rand(C, generator=gen) * 0.1
    var = torch.rand(C, generator=gen) + 0.5
    gamma = torch.rand(C, generator=gen) + 0.5
    beta = -torch.rand(C, generator=gen)
    scale = gamma / torch.sqrt(var + 1e-5)
    shift = beta - mean * scale
    got = stem.stem_expand_pool(s, m, offsets, scale, shift)
    z = (s[:, None] + offsets[:, None, None, None] * m).reshape(
        P * K, C, Ho, Wo)
    y = F.leaky_relu(F.batch_norm(z, mean, var, gamma, beta, False, 0.0,
                                  1e-5), 0.1)
    want = F.max_pool2d(y, 3, 2, padding=1).reshape(got.shape)
    assert got.shape == (P, K, C, 5, 6)
    assert bool((want < 0).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("mode", ["train", "grad"])
def test_forward_offsets_raises_in_train_mode_and_with_grad(mode):
    net = _net()
    traj, ref, offsets = _inputs()
    shared = traj_to_shared_stack(traj, ref)
    if mode == "train":
        net.train()
        with torch.no_grad(), pytest.raises(RuntimeError, match="eval"):
            net.forward_offsets(shared, offsets)
    else:
        with pytest.raises(RuntimeError, match="no_grad"):
            net.forward_offsets(shared, offsets)


def test_only_the_lite_stem_factors():
    assert _net(lite=True).factored_stem() is not None
    assert _net(lite=False).factored_stem() is None
    assert ConvMultiHypoNet(use_bn=False).factored_stem() is None


def test_wrapper_checks_shapes():
    s = torch.zeros(1, 2, 5, 5)
    one = torch.ones(2)
    with pytest.raises(ValueError, match="shapes"):
        stem.stem_expand_pool(s, torch.zeros(2, 5, 4), one, one, one)
    with pytest.raises(ValueError, match="shapes"):
        stem.stem_expand_pool(s, torch.zeros(2, 5, 5), one, torch.ones(3),
                              one)
