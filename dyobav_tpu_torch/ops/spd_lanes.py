"""Batched SPD solve, left-looking: the port of
`docs/negative_results/pallas_linalg_lanes.py`.

`batched_spd_solve(A, b)` solves A x = b for A (B, n, n), b (B, n).  By
default it takes the library route (a Cholesky factor and solve), as the
JAX function's default is `jax.scipy.linalg.solve(assume_a="pos")`.  With
`force_kernel=True` a CUDA tensor launches the hand-written kernel
`dyobav_tpu_torch/csrc/spd_lanes.cu` or raises, and a CPU tensor runs
`batched_spd_solve_plain`, the same column loop in plain PyTorch ops.
Both compute what the TPU kernel `_spd_solve_kernel` computes: a
left-looking Cholesky with `sqrt(max(acc, 1e-20))`, `inv = 1 / ljj`,
`col * inv`, and divisions by the stored diagonal in both substitutions.
That clamp is not `ops/spd.py`'s (`rsqrt(max(A_jj, 1e-30))`): the two
differ on indefinite systems.

`batched_spd_solve.launches` counts the kernel launches (nothing else
counts).
"""
from __future__ import annotations

import ctypes
import functools

import torch

# The kernel keeps 32 systems' lower triangles and right-hand sides in one
# block's shared memory: 132 * (n (n + 1) / 2 + n) bytes, within Hopper's
# 232,448 per block up to n = 57.
MAX_N = 57


def batched_spd_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the TPU kernel's statements in
    its order, on (B, n, n) and (B, n)."""
    n = A.shape[-1]
    floor = torch.tensor(1e-20, dtype=A.dtype, device=A.device)
    cols = []                       # cols[j]: (B, n) column j of L
    for j in range(n):
        col = A[:, :, j]
        for k in range(j):
            col = col - cols[k] * cols[k][:, j, None]
        # col[:, j] went through the diagonal's own chain of subtractions.
        ljj = torch.sqrt(torch.maximum(col[:, j], floor))
        cols.append(col * (1.0 / ljj)[:, None])
    y = []
    for i in range(n):
        acc = b[:, i]
        for k in range(i):
            acc = acc - cols[k][:, i] * y[k]
        y.append(acc / cols[i][:, i])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - cols[i][:, k] * x[k]
        x[i] = acc / cols[i][:, i]
    return torch.stack(x, dim=1)


def _library_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky factor and solve; NaN where A is not positive definite (as
    the JAX default's `cho_factor` gives)."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[:, None], x,
                       torch.full_like(x, float("nan")))


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..kernels import build

    lib = build.load("spd_lanes")
    fn = lib.spd_lanes_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_spd_solve(A: torch.Tensor, b: torch.Tensor,
                      force_kernel: bool | None = None) -> torch.Tensor:
    """Solve A x = b; A (B, n, n) SPD, b (B, n), same dtype and device."""
    if A.ndim != 3 or b.ndim != 2 or A.shape[1] != A.shape[2] \
            or A.shape[:2] != b.shape:
        raise ValueError(f"batched_spd_solve: shapes {tuple(A.shape)} and "
                         f"{tuple(b.shape)} do not match (B, n, n), (B, n)")
    if A.device != b.device:
        raise ValueError(f"batched_spd_solve: A on {A.device}, b on "
                         f"{b.device}")
    if A.dtype != b.dtype:
        raise TypeError(f"batched_spd_solve: A is {A.dtype}, b is {b.dtype}")
    if not force_kernel:
        return _library_solve(A, b)
    if A.device.type == "cpu":
        return batched_spd_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"batched_spd_solve: no kernel for device "
                         f"{A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"batched_spd_solve: the kernel takes float32, got "
                        f"{A.dtype}")
    batch, n = b.shape
    if not 0 < n <= MAX_N:
        raise ValueError(f"batched_spd_solve: the kernel takes 0 < n <= "
                         f"{MAX_N}, got n={n}")
    if batch == 0:
        return torch.empty_like(b)
    fn = _kernel()
    with torch.cuda.device(A.device):
        A2, b2 = A.contiguous(), b.contiguous()
        x = torch.empty_like(b2)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A2.data_ptr(), b2.data_ptr(), x.data_ptr(), n, batch, stream)
    if rc != 0:
        raise RuntimeError(f"spd_lanes_solve launch failed: CUDA error {rc}")
    batched_spd_solve.launches += 1
    return x


batched_spd_solve.launches = 0
