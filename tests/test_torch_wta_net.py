"""The port's SWTA net (`dyobav_tpu_torch.models.wta_net`) and its weight
conversion (`dyobav_tpu_torch.convert.wta_state_dict_from_flax`) against the
JAX package's Flax net, on the CPU.

A tiny net with random weights holds the architecture and the conversion
(fc1's input permutation included: a 2 x 2 feature map), for the lite
backbone and for the full-width one's deep stem and FC(1024); the trained net,
strictly loaded from `Model/wsd_1t20_full_torch.pt`, is held against the
JAX net restored from the orbax checkpoint `Model/wsd_1t20_full` on two
real input stacks.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.models import port as jport
from dyobav_tpu.models import wta_net as jw
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import wta_state_dict_from_flax
from dyobav_tpu_torch.models import wta_net as tw
from dyobav_tpu_torch.models.heatmap import traj_to_input_stack
from dyobav_tpu_torch.sim.harness import MainBase

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "Model", "wsd_1t20_full")
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")
pytestmark = pytest.mark.skipif(
    not (os.path.exists(ORBAX) and os.path.exists(PT)),
    reason="trained checkpoints absent")

TINY = dict(channels=(8, 8, 16, 16), blocks=(1, 1, 1, 1), stem_features=8)
HYPOS = 20


class TinyFlaxNet(fnn.Module):
    """`dyobav_tpu.models.wta_net.ConvMultiHypoNet.__call__` with the
    backbone's widths narrowed (the JAX class fixes them); the same
    submodules, so the same variable names."""
    lite: bool = True

    @fnn.compact
    def __call__(self, x, train: bool = False):
        backbone = jw.ResNet34Lite if self.lite else jw.ResNet34
        feat = backbone(**TINY)(x, train)
        feat = feat.reshape(feat.shape[0], -1)
        feat = fnn.leaky_relu(fnn.Dense(128 if self.lite else 1024)(feat),
                              jw.LEAKY_POST)
        hypos = fnn.Dense(2 * HYPOS)(feat)
        return hypos.reshape(hypos.shape[0], HYPOS, 2)


def _random_variables(net, shape, seed):
    """A Flax init with every leaf moved off its initial value: weights
    perturbed, BatchNorm scale / bias / mean / var random (var > 0)."""
    variables = net.init(jax.random.PRNGKey(seed), jnp.zeros(shape),
                         train=False)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        return (leaf + rng.normal(0, 0.02, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX net restored from the orbax checkpoint (once per module)."""
    from dyobav_tpu.configs import WtaNetConfiguration
    from dyobav_tpu.models.manager import NetworkManager

    mgr = NetworkManager(WtaNetConfiguration(), verbose=False)
    mgr.build_network()
    mgr.load_checkpoint(ORBAX)
    return mgr


@pytest.mark.parametrize("lite", [True, False], ids=["lite", "deep_stem"])
def test_tiny_net_matches_flax(lite):
    x = np.random.default_rng(1).normal(size=(2, 7, 128, 128)).astype(
        np.float32)                                       # NCHW
    fnet = TinyFlaxNet(lite=lite)
    variables = _random_variables(fnet, (1, 128, 128, 7), seed=0)
    out_j = np.asarray(fnet.apply(variables, x.transpose(0, 2, 3, 1),
                                  train=False))
    sd = wta_state_dict_from_flax(variables, lite=lite,
                                  blocks=TINY["blocks"])
    tnet = tw.ConvMultiHypoNet(num_hypos=HYPOS, lite=lite,
                               fc_input=16 * 2 * 2, **TINY)
    tnet.load_state_dict(sd, strict=True)
    tnet.eval()
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x)).numpy()
    assert out_t.shape == (2, HYPOS, 2)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    # The check sees fc1's permutation: without it the answers move.
    sd["fc1.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(variables["params"]["Dense_0"]["kernel"]).T))
    tnet.load_state_dict(sd, strict=True)
    with torch.no_grad():
        unpermuted = tnet(torch.from_numpy(x)).numpy()
    assert np.abs(unpermuted - out_j).max() > 1e-3


def test_trained_checkpoint_matches_orbax_net(jax_trained):
    net = tw.load_checkpoint(PT, "cpu")                # strict load
    assert not net.training
    ref_map = MainBase(seed=0).ref_map
    assert ref_map.shape == (293, 330)
    trajs = np.array([[[160.0, 50.0 + 3 * i] for i in range(5)],
                      [[235.0 - 2 * i, 100.0 + i] for i in range(5)]],
                     np.float32)
    stack = traj_to_input_stack(torch.from_numpy(trajs),
                                torch.from_numpy(ref_map),
                                torch.tensor([1.0, 12.0]))   # (2, 2, 7, H, W)
    images = torch.stack([stack[0, 0], stack[1, 1]])  # offsets 1 and 12
    with torch.no_grad():
        out_t = net(images).numpy()
    out_j = jax_trained.inference(images.numpy().transpose(0, 2, 3, 1))
    assert out_t.shape == out_j.shape == (2, 20, 2)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-3)
    # The in-repo torch checkpoint holds the orbax checkpoint's weights (its
    # BatchNorm step counters are the training's, which eval never reads).
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jax_trained.state.params,
        "batch_stats": jax_trained.state.batch_stats})
    from_orbax = wta_state_dict_from_flax(variables)
    stored = torch.load(PT, map_location="cpu", weights_only=True)
    assert set(from_orbax) == set(stored)
    for k, v in stored.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(from_orbax[k], v, rtol=0, atol=0,
                                       msg=k)


def test_state_dict_round_trip_is_exact(tmp_path):
    """A full-width random Flax init: the port's converter gives what the
    JAX package's `flax_to_torch` gives, key for key and bit for bit, and
    the net's `state_dict` survives a save and a strict load."""
    fnet = jw.ConvMultiHypoNet()
    variables = jax.tree_util.tree_map(
        np.asarray, _random_variables(fnet, (1, 128, 128, 7), seed=2))
    sd = wta_state_dict_from_flax(variables)
    ref = jport.flax_to_torch(variables)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    cfg = tcfg.WtaNetConfiguration(fc_input=128 * 2 * 2)
    net = tw.ConvMultiHypoNet(fc_input=cfg.fc_input)
    net.load_state_dict(sd, strict=True)
    path = str(tmp_path / "net.pt")
    torch.save(net.state_dict(), path)
    back = tw.load_checkpoint(path, "cpu", cfg).state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    torch.save(dict(sd, extra=torch.zeros(1)), path)
    with pytest.raises(RuntimeError, match="extra"):   # strict: no stray key
        tw.load_checkpoint(path, "cpu", cfg)
