"""The port's left-looking batched SPD solve (`dyobav_tpu_torch.ops.spd_lanes`).

On the CPU `batched_spd_solve(force_kernel=True)` runs its plain PyTorch
version, which must compute what the TPU kernel
`docs/negative_results/pallas_linalg_lanes.py::_spd_solve_kernel` computes:
held here against numpy and against that kernel run through the Pallas
interpreter (the file is loaded by path: it is not part of a package),
indefinite systems -- where the `sqrt(max(acc, 1e-20))` clamp decides the
answer -- included.  The default route is held against the JAX function's
default.  The CUDA kernel itself is held against the plain version by the
`cuda`-marked test, which runs on a card.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from dyobav_tpu_torch.ops import spd_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lanes():
    spec = importlib.util.spec_from_file_location(
        "pallas_linalg_lanes", os.path.join(
            REPO, "docs", "negative_results", "pallas_linalg_lanes.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _systems(B, n, seed=0, n_indef=0):
    """B systems M M^T + 3 I, the first `n_indef` replaced by random
    symmetric indefinite ones, and (when n_indef > 0) two diagonal ones
    with a negative or zero pivot after them."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A = (M @ M.transpose(0, 2, 1) + 3 * np.eye(n)).astype(np.float32)
    if n_indef:
        S = rng.normal(size=(n_indef, n, n))
        A[:n_indef] = (S + S.transpose(0, 2, 1)).astype(np.float32)
        A[n_indef:n_indef + 2] = np.eye(n, dtype=np.float32)
        A[n_indef, 1, 1] = -1.0
        A[n_indef + 1, 3, 3] = 0.0
    b = rng.normal(size=(B, n)).astype(np.float32)
    return A, b


def _solve(A, b, **kw):
    return spd_lanes.batched_spd_solve(torch.from_numpy(A),
                                       torch.from_numpy(b), **kw).numpy()


def test_plain_matches_numpy_solve():
    A, b = _systems(40, 12)
    x_ref = np.stack([np.linalg.solve(A[i].astype(np.float64), b[i])
                      for i in range(40)])
    before = spd_lanes.batched_spd_solve.launches
    x = _solve(A, b, force_kernel=True)
    assert spd_lanes.batched_spd_solve.launches == before   # no launch here
    # f32 Cholesky of well-conditioned systems: 1e-5 of the solution's scale.
    rel = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("B,n", [(130, 12), (128, 40)])
def test_plain_matches_pallas_kernel_interpret(jax_lanes, B, n):
    """Same answers as the TPU kernel (B=130 also goes through its padding
    to a multiple of 128), including on indefinite systems: the same
    pattern of non-finite results, and equal values where both are finite
    (a clamped pivot gives a finite, huge answer in both)."""
    import jax.numpy as jnp

    n_indef = 8
    A, b = _systems(B, n, seed=1, n_indef=n_indef)
    xj = np.asarray(jax_lanes.batched_spd_solve(
        jnp.asarray(A), jnp.asarray(b), force_pallas=True))
    xt = _solve(A, b, force_kernel=True)
    assert xt.shape == xj.shape == (B, n)
    fin_j, fin_t = np.isfinite(xj), np.isfinite(xt)
    np.testing.assert_array_equal(fin_t, fin_j)
    assert fin_j[n_indef + 2:].all()
    # Definite systems: the same statements in the same order; XLA may
    # contract a multiply-subtract into an FMA where PyTorch does not, so
    # 1e-5 of the solution's scale, not bit equality.
    spd = slice(n_indef + 2, None)
    rel = np.abs(xt[spd] - xj[spd]).max() / np.abs(xj[spd]).max()
    assert rel < 1e-5, rel
    # Indefinite systems: the clamp (ljj = 1e-10, a negative stored
    # diagonal) amplifies rounding differences, so compare loosely, where
    # both are finite: same sign and magnitude within a factor of 2 on the
    # largest entries of each system.
    for i in range(n_indef + 2):
        both = fin_j[i] & fin_t[i]
        if not both.any():
            continue
        k = np.argmax(np.abs(xj[i]) * both)
        assert np.sign(xt[i, k]) == np.sign(xj[i, k]), i
        assert 0.5 < abs(xt[i, k]) / abs(xj[i, k]) < 2.0, i
    # The diagonal systems are exact in both: the clamped pivot divides by
    # (A_jj * 1e10), LU would give -b_1 and a division by zero instead.
    for i in (n_indef, n_indef + 1):
        np.testing.assert_allclose(xt[i], xj[i], rtol=1e-6, atol=0)
    x_neg = xt[n_indef]
    assert abs(x_neg[1] - b[n_indef, 1] / (-1.0 * 1e10) / (-1.0 * 1e10)) \
        <= 1e-6 * abs(x_neg[1])


def test_default_route_matches_jax_default(jax_lanes):
    import jax.numpy as jnp

    A, b = _systems(64, 40, seed=2)
    xj = np.asarray(jax_lanes.batched_spd_solve(jnp.asarray(A),
                                                jnp.asarray(b)))
    xt = _solve(A, b)
    # Two library Cholesky solves in f32: 1e-5 of the solution's scale.
    rel = np.abs(xt - xj).max() / np.abs(xj).max()
    assert rel < 1e-5, rel
    # The default route and the kernel's arithmetic agree on SPD systems.
    rel = np.abs(_solve(A, b, force_kernel=True) - xt).max() / np.abs(xt).max()
    assert rel < 1e-5, rel
    # A system that is not positive definite comes out NaN, as JAX's does.
    A[0] = -A[0]
    assert np.isnan(_solve(A, b)[0]).all()
    assert np.isnan(np.asarray(jax_lanes.batched_spd_solve(
        jnp.asarray(A), jnp.asarray(b)))[0]).all()


def test_wrapper_rejects_bad_input():
    A, b = _systems(4, 6)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for kw in ({}, {"force_kernel": True}):
        with pytest.raises(ValueError, match="do not match"):
            spd_lanes.batched_spd_solve(At, bt[:, :5], **kw)
        with pytest.raises(ValueError, match="do not match"):
            spd_lanes.batched_spd_solve(At[None], bt[None], **kw)
        with pytest.raises(TypeError, match="float64"):
            spd_lanes.batched_spd_solve(At, bt.double(), **kw)
    # A device that is neither the CPU nor CUDA has no kernel and no
    # fallback to another route.
    with pytest.raises(ValueError, match="no kernel"):
        spd_lanes.batched_spd_solve(At.to("meta"), bt.to("meta"),
                                    force_kernel=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 13, 200])
@pytest.mark.parametrize("n", [12, 40, 64, 100])
def test_cuda_kernel_matches_plain(cuda_device, n, B):
    """Batch 1, a batch that is not a multiple of the kernel's 8 systems a
    block, and a larger ragged one with indefinite systems first.  The
    kernel issues the plain version's operations one for one (no FMA
    contraction, IEEE sqrt and division), so it must equal it bit for bit,
    and be non-finite exactly where it is."""
    n_indef = min(6, B - 2) if B > 2 else 0
    A, b = _systems(B, n, seed=3, n_indef=n_indef)
    Ad, bd = (torch.from_numpy(A).to(cuda_device),
              torch.from_numpy(b).to(cuda_device))
    before = spd_lanes.batched_spd_solve.launches
    x = spd_lanes.batched_spd_solve(Ad, bd, force_kernel=True)
    torch.cuda.synchronize()
    assert spd_lanes.batched_spd_solve.launches == before + 1
    ref = spd_lanes.batched_spd_solve_plain(Ad, bd)
    assert x.shape == ref.shape == bd.shape
    assert torch.equal(torch.isfinite(x), torch.isfinite(ref))
    definite = n_indef + 2 if n_indef else 0
    assert torch.equal(x[definite:], ref[definite:])
    torch.testing.assert_close(x, ref, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="n <="):
        m = spd_lanes.MAX_N + 1
        spd_lanes.batched_spd_solve(
            torch.eye(m, device=cuda_device)[None],
            torch.ones(1, m, device=cuda_device), force_kernel=True)
