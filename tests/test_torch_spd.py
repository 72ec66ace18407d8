"""The port's batched SPD solve (`dyobav_tpu_torch.ops.spd`).

On the CPU `spd_solve` runs its plain PyTorch version, which must compute
what the TPU kernel `dyobav_tpu/ops/pallas_spd.py::_spd_kernel` computes:
held here against numpy and against that kernel run through the Pallas
interpreter, indefinite systems (where the rsqrt(max(A_jj, 1e-30)) pivot
clamp decides the answer) included.  The CUDA kernel itself is held
against the plain version by the `cuda`-marked test, which runs on a card
(this file imports JAX only inside the test that needs it, so that test
also runs where JAX is not installed).
"""
import numpy as np
import pytest
import torch

from dyobav_tpu_torch.ops import spd


def _spd(B, n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A = (M @ M.transpose(0, 2, 1) + 3 * np.eye(n)).astype(np.float32)
    g = rng.normal(size=(B, n)).astype(np.float32)
    return A, g


def _mixed(n, seed=0):
    """16 SPD systems, 8 random symmetric indefinite ones, and 4 diagonal
    ones with a negative or zero pivot."""
    A, _ = _spd(16, n, seed)
    rng = np.random.default_rng(seed + 1)
    S = rng.normal(size=(8, n, n))
    Ai = (S + S.transpose(0, 2, 1)).astype(np.float32)
    Ad = np.tile(np.eye(n, dtype=np.float32), (4, 1, 1))
    Ad[:, 1, 1] = -1.0
    Ad[1, 3, 3] = 0.0
    A = np.concatenate([A, Ai, Ad])
    g = rng.normal(size=(A.shape[0], n)).astype(np.float32)
    return A, g


def test_plain_matches_numpy_solve():
    A, g = _spd(40, 12)
    x_ref = np.stack([np.linalg.solve(A[i], g[i]) for i in range(40)])
    before = spd.spd_solve.launches
    x = spd.spd_solve(torch.from_numpy(A), torch.from_numpy(g)).numpy()
    assert spd.spd_solve.launches == before    # CPU calls launch nothing
    rel = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert rel < 1e-5, rel


def test_plain_nested_leading_dims():
    A, g = _spd(40, 12, seed=1)
    x_ref = np.stack([np.linalg.solve(A[i], g[i]) for i in range(40)])
    x = spd.spd_solve(torch.from_numpy(A.reshape(8, 5, 12, 12)),
                      torch.from_numpy(g.reshape(8, 5, 12)))
    assert x.shape == (8, 5, 12)
    rel = np.abs(x.numpy().reshape(40, 12) - x_ref).max() / np.abs(x_ref).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("n", [12, 40])
def test_plain_matches_pallas_kernel_interpret(n):
    """Same answers as the TPU kernel, including which systems come out
    non-finite: a zero pivot or a random indefinite system gives NaN, a
    negative diagonal pivot is clamped to 1e-30 (batched LU would instead
    return the exact solution there)."""
    import jax.numpy as jnp

    from dyobav_tpu.ops import pallas_spd

    A, g = _mixed(n)
    old = pallas_spd._INTERPRET
    pallas_spd._INTERPRET = True
    try:
        xj = np.asarray(pallas_spd.spd_solve(jnp.asarray(A), jnp.asarray(g)))
    finally:
        pallas_spd._INTERPRET = old
    xt = spd.spd_solve(torch.from_numpy(A), torch.from_numpy(g)).numpy()
    fin_j, fin_t = np.isfinite(xj).all(-1), np.isfinite(xt).all(-1)
    np.testing.assert_array_equal(fin_t, fin_j)
    assert fin_j[:16].all() and not fin_j[16:24].any() and not fin_j[25]
    # SPD systems: the same algorithm in the same order; rsqrt rounding
    # alone separates the two (rel 1e-5 of the solution's scale).
    rel = np.abs(xt[:16] - xj[:16]).max() / np.abs(xj[:16]).max()
    assert rel < 1e-5, rel
    # Clamped pivots: the clamp's tiny component, not LU's exact -g_1.
    for i in (24, 26, 27):
        np.testing.assert_allclose(xt[i], xj[i], rtol=1e-6, atol=0)
        assert abs(xt[i, 1]) < 1e-20
        x_lu = np.linalg.solve(A[i].astype(np.float64), g[i])
        assert abs(x_lu[1] + g[i, 1]) < 1e-6


def test_wrapper_rejects_bad_input():
    A, g = _spd(4, 6)
    At, gt = torch.from_numpy(A), torch.from_numpy(g)
    with pytest.raises(ValueError, match="do not match"):
        spd.spd_solve(At, gt[:, :5])
    with pytest.raises(ValueError, match="do not match"):
        spd.spd_solve(At[:, :5], gt)
    # A device that is neither the CPU nor CUDA has no kernel and no
    # fallback.
    with pytest.raises(ValueError, match="no kernel"):
        spd.spd_solve(At.to("meta"), gt.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(1,), (13,), (2, 3, 7), (64, 28)])
@pytest.mark.parametrize("n", [12, 40, 64, 100])
def test_cuda_kernel_matches_plain(cuda_device, n, lead):
    """Batch 1, a batch that is not a multiple of the kernel's 8 systems a
    block, nested leading dims, and a full one; the systems cycle through
    `_mixed` from index 15, so all but batch 1 hold indefinite ones.  The
    kernel issues the plain version's operations one for one, so it must
    equal it bit for bit, and be non-finite exactly where it is."""
    A, g = _mixed(n, seed=3)
    B = int(np.prod(lead))
    idx = (np.arange(B) + 15) % len(A)
    Ad = torch.from_numpy(A[idx].reshape(*lead, n, n)).to(cuda_device)
    gd = torch.from_numpy(g[idx].reshape(*lead, n)).to(cuda_device)
    before = spd.spd_solve.launches
    x = spd.spd_solve(Ad, gd)
    torch.cuda.synchronize()
    assert spd.spd_solve.launches == before + 1
    ref = spd.spd_solve_plain(Ad, gd)
    assert x.shape == ref.shape == gd.shape
    assert torch.equal(torch.isfinite(x), torch.isfinite(ref))
    definite = torch.from_numpy(idx < 16).to(cuda_device)
    assert torch.equal(x.reshape(B, n)[definite], ref.reshape(B, n)[definite])
    torch.testing.assert_close(x, ref, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="n <="):
        spd.spd_solve(torch.eye(spd.MAX_N + 1, device=cuda_device)[None],
                      torch.ones(1, spd.MAX_N + 1, device=cuda_device))
