"""The SWTA net in train mode and one optimizer step of the port's
`NetworkManager` against the JAX package's Flax net and manager, on the CPU
(64 x 64 inputs, fc_input 128, B = 4, 20 hypotheses; float32 against
float32, TF32 off).

From one Flax init carried across by `convert.state_dict_from_flax`:
a train-mode forward and backward gives the hypotheses, the loss, every
parameter's gradient and the updated BatchNorm statistics of Flax's
`apply(..., train=True, mutable=["batch_stats"])`.  The running variance
moves toward the batch's biased variance (Flax's rule; torch's own takes
the unbiased one, 16/15 larger at a 2 x 2 last stage), which the
BatchNorm test shows is what the bound sees.  Then one `_train_step`
equals JAX's `_train_step` (`manager.py:103-121`).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.configs import WtaNetConfiguration as JCfg
from dyobav_tpu.models import losses as jl
from dyobav_tpu.models.manager import NetworkManager as JManager
from dyobav_tpu_torch.configs import WtaNetConfiguration as TCfg
from dyobav_tpu_torch.convert import state_dict_from_flax
from dyobav_tpu_torch.models import losses as tl
from dyobav_tpu_torch.models import wta_net as tw
from dyobav_tpu_torch.models.manager import NetworkManager as TManager

torch.set_num_threads(1)

B, HW = 4, 64
# Tolerances: the loss within 5e-5 relative; each gradient within 2e-4
# in relative L2 (float32 sums over 21 BatchNorm layers in another order);
# BatchNorm statistics within 1e-5 + 1e-4 x |value|.
LOSS_RTOL, GRAD_RL2, BS_ATOL, BS_RTOL = 5e-5, 2e-4, 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0, map_channel=False):
    """Normal images and labels; `map_channel`: channel 5 in [0, 255], as
    the grayscale map is, with labels in pixels."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, 7, HW, HW)).astype(np.float32)
    y = r.normal(0, 3, (B, 2)).astype(np.float32)
    if map_channel:
        x[:, 5] = r.uniform(0, 255, (B, HW, HW))
        y = r.uniform(10, 50, (B, 2)).astype(np.float32)
    return x, y


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def assert_stats_close(sd_t, sd_ref):
    keys = [k for k in sd_ref if "running" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd_t[k].numpy(), sd_ref[k].numpy(),
                                   rtol=BS_RTOL, atol=BS_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_mgr():
    """One JAX manager at 64 x 64 (its init is the weights of both sides)."""
    cfg = JCfg(x_max_px=HW, y_max_px=HW, batch_size=B)
    mgr = JManager(cfg, seed=0, verbose=False)
    mgr.build_network(input_shape=(1, HW, HW, 7))
    return mgr


def _variables(mgr):
    return _np({"params": mgr.state.params,
                "batch_stats": mgr.state.batch_stats})


def test_train_mode_forward_backward_and_batch_stats_match_flax(jax_mgr):
    x, y = _inputs()
    v = _variables(jax_mgr)

    def loss_fn(params):
        out, mut = jax_mgr.net.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, _nhwc(x),
            train=True, mutable=["batch_stats"])
        return jl.wta_meta_loss(out, jnp.asarray(y), k_top=3), (out, mut)

    (loss_j, (out_j, mut_j)), g_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    net = tw.ConvMultiHypoNet(fc_input=128)
    net.load_state_dict(state_dict_from_flax(v), strict=True)
    net.train()
    out_t = net(torch.from_numpy(x))
    loss_t = tl.wta_meta_loss(out_t, torch.from_numpy(y), k_top=3)
    loss_t.backward()
    assert out_t.shape == (B, 20, 2)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    grads = state_dict_from_flax({"params": _np(g_j)})
    named = dict(net.named_parameters())
    assert set(grads) == set(named)
    worst = max(rel_l2(named[k].grad, grads[k]) for k in grads)
    assert worst <= GRAD_RL2, worst
    after = state_dict_from_flax({"params": v["params"],
                                  "batch_stats": _np(mut_j["batch_stats"])})
    assert_stats_close(net.state_dict(), after)


def test_train_mode_gradients_match_flax_float64_on_a_map_channel(jax_mgr):
    """With a map channel in [0, 255] the stem's BatchNorm sees means far
    above its spread, and Flax's one-pass variance E[x^2] - E[x]^2 in
    float32 moves the gradients by 1.8e-3 in relative L2 from its own
    float64 run on this draw (the test prints it; other draws move them
    more); the port's float32 stays within 1e-4 of that run.  So the two are held
    in float64 (`jax.enable_x64`, the Flax net at dtype float64) within
    1e-6 (Flax's one-pass variance costs ~3e-8 there too), and the port's
    float32 against Flax's float64 within 1e-4."""
    from dyobav_tpu.models.wta_net import ConvMultiHypoNet as JNet

    x, y = _inputs(2, map_channel=True)
    v = _variables(jax_mgr)

    def flax_grads(dtype):
        net = JNet(dtype=dtype)
        vv = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v)

        def loss_fn(params):
            out, _ = net.apply(
                {"params": params, "batch_stats": vv["batch_stats"]},
                jnp.asarray(x.transpose(0, 2, 3, 1).astype(dtype)),
                train=True, mutable=["batch_stats"])
            return jl.wta_meta_loss(out, jnp.asarray(y.astype(dtype)))

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(vv["params"])
        return float(loss), state_dict_from_flax({"params": _np(g)})

    loss32_j, g32_j = flax_grads(np.float32)
    with jax.enable_x64(True):
        loss64_j, g64_j = flax_grads(np.float64)

    def port_grads(dtype):
        net = tw.ConvMultiHypoNet(fc_input=128)
        net.load_state_dict(state_dict_from_flax(v), strict=True)
        net.to(dtype).train()
        loss = tl.wta_meta_loss(net(torch.from_numpy(x).to(dtype)),
                                torch.from_numpy(y).to(dtype))
        loss.backward()
        return loss.item(), {k: p.grad.double()
                             for k, p in net.named_parameters()}

    loss64_t, g64_t = port_grads(torch.float64)
    loss32_t, g32_t = port_grads(torch.float32)
    np.testing.assert_allclose(loss64_t, loss64_j, rtol=1e-12)
    np.testing.assert_allclose(loss32_t, loss64_j, rtol=LOSS_RTOL)
    assert max(rel_l2(g64_t[k], g64_j[k]) for k in g64_j) <= 1e-6
    port32 = max(rel_l2(g32_t[k], g64_j[k]) for k in g64_j)
    assert port32 <= 1e-4, port32
    print(f"gradient rel L2 to Flax float64: port float32 {port32:.3e}, "
          f"Flax float32 {max(rel_l2(g32_j[k], g64_j[k]) for k in g64_j):.3e}")


@pytest.mark.parametrize("n", [4, 16, 64], ids=["n4", "n16", "n64"])
def test_batchnorm_updates_running_stats_by_flax_rule(n):
    """One train-mode call of the port's BatchNorm2d against Flax's
    `BatchNorm(momentum=0.9)` over n values a channel (B = 4, n / 4
    spatial cells); torch's unbiased rule would miss the bound at these n."""
    r = np.random.default_rng(n)
    side = int(np.sqrt(n // 4))
    x = r.normal(1.0, 2.0, (4, 8, side, side)).astype(np.float32)
    mean0 = r.normal(0, 0.1, 8).astype(np.float32)
    var0 = r.uniform(0.5, 1.5, 8).astype(np.float32)
    scale = r.uniform(0.8, 1.2, 8).astype(np.float32)
    bias = r.normal(0, 0.1, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    y_j, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean0, "var": var0}},
                        jnp.asarray(x.transpose(0, 2, 3, 1)),
                        mutable=["batch_stats"])
    t = tw.BatchNorm2d(8)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(scale))
        t.bias.copy_(torch.from_numpy(bias))
        t.running_mean.copy_(torch.from_numpy(mean0))
        t.running_var.copy_(torch.from_numpy(var0))
    t.train()
    y_t = t(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    var_j = np.asarray(mut["batch_stats"]["var"])
    np.testing.assert_allclose(t.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=BS_RTOL, atol=BS_ATOL)
    np.testing.assert_allclose(t.running_var.numpy(), var_j, rtol=BS_RTOL,
                               atol=BS_ATOL)
    assert int(t.num_batches_tracked) == 1
    # torch's own rule (unbiased batch variance) lands outside the bound.
    ref = torch.nn.BatchNorm2d(8, momentum=0.1)
    ref.load_state_dict(t.state_dict() | {
        "running_mean": torch.from_numpy(mean0),
        "running_var": torch.from_numpy(var0)})
    ref.train()(torch.from_numpy(x))
    gap = np.abs(ref.running_var.numpy() - var_j)
    assert (gap > BS_ATOL + BS_RTOL * np.abs(var_j)).all()


def test_eval_mode_is_torch_batchnorm_bit_for_bit():
    """The predictor's eval forward is unchanged: the port's BatchNorm2d in
    eval mode is `nn.BatchNorm2d`'s forward."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(2, 8, 5, 5)).astype(np.float32))
    t = tw.BatchNorm2d(8)
    ref = torch.nn.BatchNorm2d(8, eps=1e-5)
    sd = {"weight": torch.rand(8), "bias": torch.rand(8),
          "running_mean": torch.rand(8), "running_var": torch.rand(8) + 0.5,
          "num_batches_tracked": torch.tensor(3)}
    t.load_state_dict(sd)
    ref.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(t.eval()(x), ref.eval()(x))
    assert set(t.state_dict()) == set(ref.state_dict())


def test_train_step_matches_jax(jax_mgr):
    """`_train_step` (k_top 1) against JAX's: the loss, then every
    parameter after AdamW's first step, in units of lr (Adam's first step
    moves a parameter by about lr x sign(g); a gradient at rounding level
    may flip its sign, at most 2 lr, and the gradients are held before the
    step above), and the BatchNorm statistics."""
    x, y = _inputs(1)
    v = _variables(jax_mgr)
    state, loss_j = jax_mgr._train_step(jax_mgr.state, _nhwc(x),
                                        jnp.asarray(y), 1)
    cfg = TCfg(x_max_px=HW, y_max_px=HW, batch_size=B)
    mgr = TManager(cfg, seed=0, verbose=False, device="cpu")
    mgr.build_network(input_shape=(1, 7, HW, HW))
    mgr.net.load_state_dict(state_dict_from_flax(v), strict=True)
    loss_t = mgr._train_step(x, y, 1)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    after = state_dict_from_flax({"params": _np(state.params),
                                  "batch_stats": _np(state.batch_stats)})
    sd = mgr.net.state_dict()
    lr = cfg.learning_rate
    dev = np.concatenate([np.abs(sd[k].numpy() - after[k].numpy()).ravel()
                          for k, _ in mgr.net.named_parameters()])
    assert dev.max() <= 2 * lr * 1.0001, dev.max() / lr
    assert (dev > 0.01 * lr).mean() <= 1e-3, (dev > 0.01 * lr).mean()
    before = state_dict_from_flax(v)
    moved = np.concatenate([np.abs(sd[k].numpy() - before[k].numpy()).ravel()
                            for k, _ in mgr.net.named_parameters()])
    assert np.median(moved) > 0.5 * lr          # the step did move them
    assert_stats_close(sd, after)
