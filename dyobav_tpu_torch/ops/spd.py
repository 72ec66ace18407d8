"""Batched SPD solve: the port of `dyobav_tpu/ops/pallas_spd.py`.

`spd_solve(A, g)` solves A d = g for every system in the leading dims.
On a CUDA tensor it launches the hand-written kernel
`dyobav_tpu_torch/csrc/spd_cholesky.cu` (built and loaded by
`kernels.build`) or raises; on a CPU tensor it runs `spd_solve_plain`, the
same algorithm in plain PyTorch ops.  Both compute what the TPU kernel
computes: a right-looking Cholesky with the pivot `rsqrt(max(A_jj, 1e-30))`,
then forward and back substitution.  (Off the TPU the JAX package solves
with batched LU instead; the two differ on indefinite LM rungs, where the
clamp gives a finite step and LU another one.)

The kernel is called outside any `torch.func` transform: the solver
batches all lanes and LM rungs into one call, which takes the place of the
JAX package's `custom_vmap` rule.  `spd_solve.launches` counts the kernel
launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

# The kernel keeps each of a block's 8 systems (one a warp) as a packed
# lower triangle in shared memory: 8 * 4 * n (n + 1) / 2 bytes, 161.6 KB
# at n = 100 of Hopper's 232,448 per block; a lane owns at most 4 rows.
MAX_N = 100


def spd_solve_plain(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same algorithm, same clamp,
    same order of operations, batched over the leading dims."""
    n = A.shape[-1]
    L = A.clone()
    floor = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    for j in range(n):
        inv = torch.rsqrt(torch.maximum(L[..., j, j], floor))
        col = L[..., j:, j] * inv[..., None]
        L[..., j:, j] = col
        if j + 1 < n:
            # The rank-1 update of the whole trailing block gives the lower
            # triangle the kernel's values; the upper triangle is never read.
            L[..., j + 1:, j + 1:] -= col[..., 1:, None] * col[..., None, 1:]
    y = g.clone()
    for j in range(n):
        yj = y[..., j] / L[..., j, j]
        y[..., j] = yj
        if j + 1 < n:
            y[..., j + 1:] -= L[..., j + 1:, j] * yj[..., None]
    for j in range(n - 1, -1, -1):
        xj = y[..., j] / L[..., j, j]
        y[..., j] = xj
        if j > 0:
            y[..., :j] -= L[..., j, :j] * xj[..., None]
    return y


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..kernels import build

    lib = build.load("spd_cholesky")
    fn = lib.spd_cholesky_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spd_solve(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve A d = g; A (..., n, n), g (..., n) with the same leading dims."""
    if A.shape[:-2] != g.shape[:-1] or A.shape[-1] != A.shape[-2] \
            or A.shape[-1] != g.shape[-1]:
        raise ValueError(f"spd_solve: shapes {tuple(A.shape)} and "
                         f"{tuple(g.shape)} do not match")
    if A.device != g.device:
        raise ValueError(f"spd_solve: A on {A.device}, g on {g.device}")
    if A.device.type == "cpu":
        return spd_solve_plain(A, g)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve: no kernel for device {A.device}")
    if A.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"spd_solve: the kernel takes float32, got "
                        f"{A.dtype} and {g.dtype}")
    n = A.shape[-1]
    if not 0 < n <= MAX_N:
        raise ValueError(f"spd_solve: the kernel takes 0 < n <= {MAX_N}, "
                         f"got n={n}")
    lead = A.shape[:-2]
    A2 = A.reshape(-1, n, n).contiguous()
    g2 = g.reshape(-1, n).contiguous()
    batch = A2.shape[0]
    if batch >= 2 ** 31:
        raise ValueError(f"spd_solve: batch {batch} exceeds the grid limit")
    d = torch.empty_like(g2)
    fn = _kernel()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A2.data_ptr(), g2.data_ptr(), d.data_ptr(), n, batch, stream)
    if rc != 0:
        raise RuntimeError(f"spd_cholesky_solve launch failed: CUDA error {rc}")
    spd_solve.launches += 1
    return d.reshape(*lead, n)


spd_solve.launches = 0
