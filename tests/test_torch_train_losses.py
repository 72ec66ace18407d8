"""The port's WTA / MDN losses (`dyobav_tpu_torch.models.losses`) and
density utilities (`dyobav_tpu_torch.utils.density`) against the JAX
package's, on the CPU: every function's value and its gradient with respect
to the hypotheses (or the mixture's parameters), float32 against float32,
within rtol 1e-5 / atol 1e-6.

The gradient is that of sum(w * f(x)) for a fixed random weight w of f's
output shape, through `jax.grad` and through autograd.  Tied minima are
included: `jnp.min` splits the gradient evenly among them, and so must the
port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.models import losses as jl
from dyobav_tpu.utils import density as jd
from dyobav_tpu_torch.models import losses as tl
from dyobav_tpu_torch.utils import density as td

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B, M, C = 4, 6, 2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _hypos(seed=0, m=M):
    return _rng(seed).normal(0, 2, (B, m, C)).astype(np.float32)


def _labels(seed=1):
    return _rng(seed).normal(0, 2, (B, C)).astype(np.float32)


def _weights(out, seed=7):
    return [_rng(seed + i).uniform(0.5, 1.5, np.shape(o)).astype(np.float32)
            for i, o in enumerate(out)]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check(fj, ft, args, grad_args=(0,)):
    """f's value and the gradient of sum(w * f) with respect to the
    arguments `grad_args`, JAX against the port."""
    out_j = _as_tuple(fj(*[jnp.asarray(a) for a in args]))
    ws = _weights([np.asarray(o) for o in out_j])

    def scalar_j(*diff):
        full = [jnp.asarray(a) for a in args]
        for i, d in zip(grad_args, diff):
            full[i] = d
        return sum(jnp.sum(jnp.asarray(w) * o)
                   for w, o in zip(ws, _as_tuple(fj(*full))))

    grads_j = jax.grad(scalar_j, argnums=tuple(range(len(grad_args))))(
        *[jnp.asarray(args[i]) for i in grad_args])
    targs = [torch.tensor(a, requires_grad=i in grad_args)
             for i, a in enumerate(args)]
    out_t = _as_tuple(ft(*targs))
    assert len(out_t) == len(out_j)
    for oj, ot in zip(out_j, out_t):
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                                   rtol=RTOL, atol=ATOL)
    total = sum(torch.sum(torch.from_numpy(w) * o) for w, o in zip(ws, out_t))
    grads_t = torch.autograd.grad(total, [targs[i] for i in grad_args])
    for gj, gt in zip(grads_j, grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                   rtol=RTOL, atol=ATOL)
    return out_t, grads_t


# ------------------------------------------------------------- base losses
def _gts(m=M):
    return np.repeat(_labels()[:, None, :], m, axis=1)


@pytest.mark.parametrize("name", ["loss_mse", "loss_mae"])
def test_base_losses_match_jax(name):
    check(getattr(jl, name), getattr(tl, name), [_hypos(), _gts()])


def test_loss_msle_matches_jax():
    data = np.abs(_hypos()) + 0.1
    labels = np.abs(_gts()) + 0.1
    check(jl.loss_msle, tl.loss_msle, [data, labels])


def test_cal_gau_prob_and_loss_nll_match_jax():
    mu = _hypos(2) / 2
    sigma = _rng(3).uniform(0.5, 2.0, (B, M, C)).astype(np.float32)
    x = _labels() / 2
    check(jl.cal_gau_prob, tl.cal_gau_prob, [mu, sigma, x], grad_args=(0, 1))
    data = np.concatenate([mu, sigma], axis=2)            # (B, M, 4)
    check(jl.loss_nll, tl.loss_nll, [data, _gts() / 2])


# -------------------------------------------------------------- meta losses
META_CASES = [
    ("vanilla", dict(k_top=1, relax=0.0)),
    ("relaxed", dict(k_top=1, relax=0.1)),
    ("topk3", dict(k_top=3, relax=0.0)),
    ("topk_above_M", dict(k_top=M + 4, relax=0.0)),
]


@pytest.mark.parametrize("kw", [c[1] for c in META_CASES],
                         ids=[c[0] for c in META_CASES])
def test_meta_loss_matches_jax(kw):
    check(lambda h, y: jl.meta_loss(h, y, jl.loss_mse, **kw),
          lambda h, y: tl.meta_loss(h, y, tl.loss_mse, **kw),
          [_hypos(), _labels()])


def _tied_hypos():
    """Every sample's two best hypotheses are equal (a tie at the min)."""
    h = _hypos(4)
    y = _labels()
    h[:, 0] = y + 0.05
    h[:, 3] = h[:, 0]
    return h, y


@pytest.mark.parametrize("kw", [dict(k_top=1, relax=0.0),
                                dict(k_top=1, relax=0.2)],
                         ids=["vanilla", "relaxed"])
def test_meta_loss_tied_minima_split_the_gradient(kw):
    h, y = _tied_hypos()
    _, (g,) = check(lambda a, b: jl.meta_loss(a, b, jl.loss_mse, **kw),
                    lambda a, b: tl.meta_loss(a, b, tl.loss_mse, **kw),
                    [h, y])
    if kw["relax"] == 0.0:
        # Half of the winner's gradient to each of the tied pair.
        np.testing.assert_allclose(g[:, 0].numpy(), g[:, 3].numpy())
        assert torch.all(g[:, 0].abs().sum(1) > 0)
        assert torch.all(g[:, [1, 2, 4, 5]] == 0)


@pytest.mark.parametrize("k_top", [0, 1, 3], ids=["k0", "k1", "k3"])
@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_ameta_loss_matches_jax(k_top, tied):
    h, y = _tied_hypos() if tied else (_hypos(5), _labels())
    check(lambda a, b: jl.ameta_loss(a, b, jl.loss_mse, k_top=k_top),
          lambda a, b: tl.ameta_loss(a, b, tl.loss_mse, k_top=k_top),
          [h, y])


def test_unknown_meta_loss_mode_raises():
    h, y = torch.from_numpy(_hypos()), torch.from_numpy(_labels())
    with pytest.raises(ValueError, match="Unknown meta-loss mode"):
        tl.meta_loss(h, y, k_top=3, relax=0.1)
    with pytest.raises(ValueError):
        tl.meta_loss(h, y, k_top=1, relax=1.0)


# ------------------------------------------------------------ MDN utilities
def _mixture(seed=6, g=5):
    r = _rng(seed)
    alp = r.uniform(0.1, 1.0, (B, g)).astype(np.float32)
    mu = r.normal(0, 1, (B, g, C)).astype(np.float32)
    sigma = r.uniform(0.5, 1.5, (B, g, C)).astype(np.float32)
    return alp, mu, sigma, (_labels() / 3).astype(np.float32)


@pytest.mark.parametrize("name", ["cal_multi_gau_prob", "loss_nll_mdn",
                                  "loss_mahalanobis"])
def test_mixture_losses_match_jax(name):
    check(getattr(jl, name), getattr(tl, name), list(_mixture()),
          grad_args=(0, 1, 2))


def test_loss_central_oracle_matches_jax_with_a_tie():
    _, mu, _, x = _mixture()
    mu[:, 2] = mu[:, 1]                       # tied components
    check(jl.loss_central_oracle, tl.loss_central_oracle, [mu, x])


def test_manager_adapters_match_jax():
    h, y = _hypos(), _labels()
    for k in (1, 4):
        check(lambda a, b: jl.wta_meta_loss(a, b, k_top=k),
              lambda a, b: tl.wta_meta_loss(a, b, k_top=k), [h, y])
    alp, mu, sigma, x = _mixture()
    var = sigma ** 2
    for fj, ft, third in ((jl.mdn_nll_loss, tl.mdn_nll_loss, sigma),
                          (jl.smdn_nll_loss, tl.smdn_nll_loss, var)):
        check(lambda a, m, s, lab: fj((a, m, s), lab),
              lambda a, m, s, lab: ft((a, m, s), lab),
              [alp, mu, third, x], grad_args=(0, 1, 2))


@pytest.mark.parametrize("epochs,hypos", [(0, 20), (1, 20), (2, 20),
                                          (5, 20), (20, 20), (7, 6)])
def test_default_k_top_schedule_matches_jax(epochs, hypos):
    assert (tl.default_k_top_schedule(epochs, hypos)
            == jl.default_k_top_schedule(epochs, hypos))


# ------------------------------------------------------------------ density
def test_gaussian_kernel_and_parzen_match_jax():
    x = _rng(8).normal(0, 0.2, (3, 4, 2)).astype(np.float32)
    mu = np.array([0.05, -0.1], np.float32)
    data = _rng(9).normal(0, 0.3, (12, 2)).astype(np.float32)
    check(lambda a: jd.gaussian_kernel(a, sigma=0.3),
          lambda a: td.gaussian_kernel(a, sigma=0.3), [x])
    check(lambda a, m: jd.gaussian_kernel(a, m), td.gaussian_kernel,
          [x, mu], grad_args=(0, 1))
    check(lambda a, d: jd.parzen_density(a, d, bandwidth=0.7, sigma=0.2),
          lambda a, d: td.parzen_density(a, d, bandwidth=0.7, sigma=0.2),
          [x, data], grad_args=(0, 1))
    one = td.parzen_density(torch.zeros(2), torch.from_numpy(data))
    assert one.shape == ()


def test_mixture_density_matches_jax():
    alp, mu, sigma, x = _mixture(g=3)
    check(jd.gau_prob, td.gau_prob, [mu, sigma, x], grad_args=(0, 1))
    check(jd.multi_gau_prob, td.multi_gau_prob, [alp, mu, sigma, x],
          grad_args=(0, 1, 2))


def test_multi_gau_grid_matches_jax():
    xx, yy = np.meshgrid(np.linspace(-3, 3, 21, dtype=np.float32),
                         np.linspace(-2, 2, 17, dtype=np.float32))
    alp = np.array([[0.7, 0.3]], np.float32)
    mu = np.array([[[0.0, 0.0], [1.5, -0.5]]], np.float32)
    sigma = np.full((1, 2, 2), 0.6, np.float32)
    want = np.asarray(jd.multi_gau_grid(alp, mu, sigma, jnp.asarray(xx),
                                        jnp.asarray(yy)))
    got = td.multi_gau_grid(*(torch.from_numpy(a) for a in (alp, mu, sigma,
                                                            xx, yy)))
    assert got.shape == xx.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (want == 0).sum() > 0 and ((got.numpy() == 0) == (want == 0)).all()
