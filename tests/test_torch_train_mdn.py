"""The port's MDN heads and nets (`dyobav_tpu_torch.models.mdn`) against the
JAX package's, on the CPU (64 x 64 inputs, fc_input 128, B = 4; float32
against float32): the two heads' outputs and input gradients, the
component-selection helpers, the two-stage fit, and for both nets
(`ConvMixtureDensityNet` with 20 components, `ConvMultiHypoMixtureDensityFit`
with 20 hypotheses and 5 Gaussians) the train-mode gradients and one
`NetworkManager._train_step` against JAX's (`manager.py:103-121`), from one
Flax init carried across by `convert.state_dict_from_flax`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.configs import WtaNetConfiguration as JCfg
from dyobav_tpu.models import losses as jl
from dyobav_tpu.models import mdn as jm
from dyobav_tpu.models.manager import NetworkManager as JManager
from dyobav_tpu_torch.configs import WtaNetConfiguration as TCfg
from dyobav_tpu_torch.convert import state_dict_from_flax
from dyobav_tpu_torch.models import losses as tl
from dyobav_tpu_torch.models import mdn as tm
from dyobav_tpu_torch.models.manager import NetworkManager as TManager

torch.set_num_threads(1)

B, HW = 4, 64
# Tolerances: outputs within rtol 1e-5 / atol 1e-6 (heads) and 1e-4 (nets),
# the loss within 5e-5 relative, each gradient within 5e-4 in relative L2,
# BatchNorm statistics within 1e-5 + 1e-4 x |value|, parameters after the
# step as in tests/test_torch_train_net.py (units of lr).
LOSS_RTOL, GRAD_RL2, BS_ATOL, BS_RTOL = 5e-5, 5e-4, 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _linear_from_dense(layer, dense):
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(dense["kernel"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(dense["bias"])))


def _head_check(fmod, tmod, x):
    v = fmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    _linear_from_dense(tmod.layer, v["params"]["Dense_0"])
    out_j = fmod.apply(v, jnp.asarray(x))
    w = [np.random.default_rng(i).uniform(0.5, 1.5, np.shape(o)).astype(
        np.float32) for i, o in enumerate(out_j)]
    g_j = jax.grad(lambda a: sum(jnp.sum(wi * o) for wi, o in
                                 zip(w, fmod.apply(v, a))))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tmod(xt)
    for oj, ot in zip(out_j, out_t):
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                                   rtol=1e-5, atol=1e-6)
    total = sum(torch.sum(torch.from_numpy(wi) * o) for wi, o in zip(w, out_t))
    (g_t,) = torch.autograd.grad(total, [xt])
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    return out_t


def test_classic_head_matches_flax():
    x = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    alpha, mu, sigma = _head_check(
        jm.ClassicMixtureDensityModule(dim_output=2, num_components=5),
        tm.ClassicMixtureDensityModule(16, 2, 5), x)
    assert alpha.shape == (3, 5) and mu.shape == sigma.shape == (3, 5, 2)
    assert torch.all(sigma > 0)


def test_sampling_head_matches_flax():
    hypos = np.random.default_rng(1).normal(size=(2, 12)).astype(np.float32)
    alpha, mu, var = _head_check(
        jm.SamplingMixtureDensityModule(dim_input=2, num_hypos=6, num_gaus=3),
        tm.SamplingMixtureDensityModule(2, 6, 3), hypos)
    np.testing.assert_allclose(alpha.sum(1).detach().numpy(), 1.0, rtol=1e-5)
    assert mu.shape == var.shape == (2, 3, 2)


@pytest.mark.parametrize("main", [2, 4, 6], ids=["main2", "main4", "all"])
def test_take_main_components_matches_jax(main):
    alp = np.array([[0.3, 0.5, 0.05, 0.15]], np.float32)
    mu = np.arange(8.0, dtype=np.float32).reshape(1, 4, 2)
    sigma = np.random.default_rng(2).uniform(0.5, 1, (1, 4, 2)).astype(
        np.float32)
    want = jm.take_main_components(alp, mu, sigma, main=main)
    got = tm.take_main_components(*(torch.from_numpy(a) for a in
                                    (alp, mu, sigma)), main=main)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_take_good_components_matches_jax():
    cases = [(np.array([0.5, 0.3, 0.01]), np.zeros((3, 2)), np.ones((3, 2))),
             (np.array([0.9]), np.ones((1, 2)), np.ones((1, 2)))]
    for alp, mu, sigma in cases:
        want = jm.take_good_components(alp, mu, sigma, thre=0.1)
        got = tm.take_good_components(torch.from_numpy(alp), mu, sigma,
                                      thre=0.1)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


NETS = {
    "mdn": (lambda: jm.ConvMixtureDensityNet(dim_out=2, num_components=20),
            lambda: tm.ConvMixtureDensityNet(num_components=20, fc_input=128),
            jl.mdn_nll_loss, tl.mdn_nll_loss),
    "mdnfit": (lambda: jm.ConvMultiHypoMixtureDensityFit(
        dim_out=2, num_hypos=20, num_gaus=5),
        lambda: tm.ConvMultiHypoMixtureDensityFit(num_hypos=20, num_gaus=5,
                                                  fc_input=128),
        jl.smdn_nll_loss, tl.smdn_nll_loss),
}


@pytest.mark.parametrize("kind", list(NETS))
def test_mdn_net_gradients_and_train_step_match_jax(kind):
    """Eval outputs, train-mode gradients (before the step), then one
    `_train_step`: loss, parameters in units of lr, BatchNorm statistics."""
    fnet, tnet, jloss, tloss = NETS[kind]
    r = np.random.default_rng(5)
    x = r.normal(size=(B, 7, HW, HW)).astype(np.float32)
    y = r.normal(0, 1, (B, 2)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    cfg = JCfg(x_max_px=HW, y_max_px=HW, num_hypos=20, batch_size=B)
    jmgr = JManager(cfg, net=fnet(), loss=jloss, seed=0, verbose=False)
    jmgr.build_network(input_shape=(1, HW, HW, 7))
    v = _np({"params": jmgr.state.params,
             "batch_stats": jmgr.state.batch_stats})
    sd0 = state_dict_from_flax(v, kind)

    tmgr = TManager(TCfg(x_max_px=HW, y_max_px=HW, batch_size=B),
                    net=tnet(), loss=tloss, seed=0, verbose=False,
                    device="cpu")
    tmgr.build_network(input_shape=(1, 7, HW, HW))
    tmgr.net.load_state_dict(sd0, strict=True)
    out_t = tmgr.inference(x)
    out_j = jmgr.inference(np.asarray(xj))
    assert isinstance(out_t, tuple) and len(out_t) == 3
    for ot, oj in zip(out_t, out_j):
        np.testing.assert_allclose(ot, oj, rtol=1e-4, atol=1e-4)

    def loss_fn(params):
        out, _ = jmgr.net.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xj,
            train=True, mutable=["batch_stats"])
        return jloss(out, jnp.asarray(y))

    g_j = state_dict_from_flax(
        {"params": _np(jax.jit(jax.grad(loss_fn))(v["params"]))}, kind)
    tmgr.net.train()
    tloss(tmgr.net(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    named = dict(tmgr.net.named_parameters())
    assert set(g_j) == set(named)
    worst = max(rel_l2(named[k].grad, g_j[k]) for k in g_j)
    assert worst <= GRAD_RL2, worst

    tmgr.net.load_state_dict(sd0, strict=True)      # undo the BN update
    state, loss_j = jmgr._train_step(jmgr.state, xj, jnp.asarray(y), 1)
    loss_t = tmgr._train_step(x, y, 1)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    after = state_dict_from_flax({"params": _np(state.params),
                                  "batch_stats": _np(state.batch_stats)},
                                 kind)
    sd = tmgr.net.state_dict()
    lr = cfg.learning_rate
    dev = np.concatenate([np.abs(sd[k].numpy() - after[k].numpy()).ravel()
                          for k in named])
    assert dev.max() <= 2 * lr * 1.0001, dev.max() / lr
    assert (dev > 0.01 * lr).mean() <= 1e-3, (dev > 0.01 * lr).mean()
    for k in after:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(),
                                       rtol=BS_RTOL, atol=BS_ATOL, err_msg=k)


def test_conv_mixture_density_fit_matches_jax():
    """The two-stage fit: a WTA net's hypotheses into a sampling-MDN head."""
    from dyobav_tpu.models.wta_net import ConvMultiHypoNet as JNet
    from dyobav_tpu_torch.models.wta_net import ConvMultiHypoNet as TNet

    x = np.random.default_rng(6).normal(size=(2, 7, HW, HW)).astype(
        np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    wta = JNet(dim_out=2, num_hypos=6)
    wv = wta.init(jax.random.PRNGKey(0), xj, train=False)
    smdn = jm.SamplingMixtureDensityModule(dim_input=2, num_hypos=6,
                                           num_gaus=3)
    sv = smdn.init(jax.random.PRNGKey(1), jnp.zeros((1, 12)))
    want = jm.conv_mixture_density_fit(
        lambda variables, a: wta.apply(variables, a, train=False), smdn,
        sv)(wv, xj)
    twta = TNet(num_hypos=6, fc_input=128)
    twta.load_state_dict(state_dict_from_flax(_np(wv)), strict=True)
    tsmdn = tm.SamplingMixtureDensityModule(2, 6, 3)
    _linear_from_dense(tsmdn.layer, sv["params"]["Dense_0"])
    with torch.no_grad():
        got = tm.conv_mixture_density_fit(twta.eval(), tsmdn)(
            torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
