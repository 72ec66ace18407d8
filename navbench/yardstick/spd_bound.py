"""Least time of the port's batched SPD solve (`csrc/spd_cholesky.cu`).

Frozen copy of `chip_smoke.spd_bound_bytes` / `spd_bound_ms`: the bytes a
batch of n x n float32 solves must move (the 32-byte sectors holding the
lower triangles of the row-major A, g read and d written once) at the
memory rate, against the factorization's and substitutions' operations at
the float32 rate, whichever is larger.
"""
from __future__ import annotations

import numpy as np


def spd_bound_bytes(batch: int, n: int) -> int:
    rows = np.arange(batch * n, dtype=np.int64)    # row (b, i) is b * n + i
    start = rows * n * 4                           # its first byte in A
    end = start + (rows % n + 1) * 4               # one past its diagonal
    first, last = start // 32, (end - 1) // 32
    # Rows are disjoint and in address order, so a sector is shared, if at
    # all, by a row's last sector and the next row's first.
    sectors = int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())
    return 32 * sectors + 2 * 4 * batch * n


def spd_flops(batch: int, n: int) -> int:
    """Operations of `batch` Cholesky factorizations and both triangular
    substitutions of n x n systems."""
    update_pairs = sum((m * (m + 1)) // 2 for m in range(n))
    return batch * (2 * update_pairs            # trailing updates
                    + n * (n + 1) // 2 + n      # column scaling + rsqrt
                    + 2 * n * (n - 1) + 2 * n)  # substitutions


def spd_bound_s(batch: int, n: int, peaks: dict) -> float:
    return max(spd_bound_bytes(batch, n) / peaks["hbm_bytes_per_s"],
               spd_flops(batch, n) / peaks["fp32_flops_per_s"])
