"""The SWTA net's stem expanded over the horizon offsets: offset, BatchNorm
(eval), LeakyReLU(0.1) and the 3x3/s2 max pool in one pass.

`stem_expand_pool(s, m, offsets, scale, shift)` takes the stem
convolution of each pedestrian's shared channels `s` (P, C, Ho, Wo) and the
offset channel's convolution of an all-ones image `m` (C, Ho, Wo); for each
offset o it forms the stem convolution of that offset's image
z = s + o * m (the convolution is linear and has no bias), applies
BatchNorm's eval affine y = z * scale + shift, LeakyReLU(0.1), and the max
over each 3 x 3 window of stride 2 with padding 1, where out-of-range
positions are skipped (the -inf padding of `models.wta_net.ResNet34Lite`).
It returns (P, K, C, Hp, Wp), Hp = (Ho - 1) // 2 + 1, Wp likewise.

On a CUDA tensor it launches the hand-written kernel
`dyobav_tpu_torch/csrc/stem_expand_pool.cu` (built and loaded by
`kernels.build`) or raises; on a CPU tensor it runs
`stem_expand_pool_plain`, the same arithmetic in plain PyTorch ops in the
same order, which the kernel equals bit for bit.  The kernel replaces no
TPU kernel (the JAX package leaves the stem to XLA); it exists because the
stem's BatchNorm, activation and pool run once for every (pedestrian,
offset) image, and as separate operators they would read and write the
whole stem output several times.  `stem_expand_pool.launches` counts the
kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

LEAKY = 0.1          # the stem's slope (models.wta_net.LEAKY_CONV)
# A block keeps 17 input rows of s and of m in dynamic shared memory (23 KB
# at Wo = 165, 139 KB at Wo = 1024) and has a thread for each of 31 output
# columns a warp (544 at Wo = 1024).
MAX_WO = 1024


def pooled_size(n: int) -> int:
    """Output length of the 3x3/s2 pool with padding 1 over n."""
    return (n - 1) // 2 + 1


def stem_expand_pool_plain(s, m, offsets, scale, shift):
    """Plain PyTorch version of the kernel: the same elementwise order
    (o * m, then + s; * scale, then + shift; y or y * 0.1), then
    `F.max_pool2d(3, 2, padding=1)`."""
    P, C, Ho, Wo = s.shape
    K = offsets.shape[0]
    # In place after the first sum: the same roundings in a third of the
    # memory (P x K x C x Ho x Wo floats once).
    y = s[:, None] + offsets[None, :, None, None, None] * m
    y.mul_(scale[:, None, None]).add_(shift[:, None, None])
    F.leaky_relu_(y, LEAKY)                  # y > 0 ? y : y * 0.1
    out = F.max_pool2d(y.reshape(P * K, C, Ho, Wo), 3, 2, padding=1)
    return out.reshape(P, K, C, pooled_size(Ho), pooled_size(Wo))


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..kernels import build

    lib = build.load("stem_expand_pool")
    fn = lib.stem_expand_pool
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stem_expand_pool(s, m, offsets, scale, shift):
    """s (P, C, Ho, Wo), m (C, Ho, Wo), offsets (K,), scale and shift (C,)
    -> (P, K, C, Hp, Wp), all float32 on one device."""
    args = (s, m, offsets, scale, shift)
    if s.dim() != 4 or tuple(m.shape) != tuple(s.shape[1:]) \
            or offsets.dim() != 1 or tuple(scale.shape) != (s.shape[1],) \
            or tuple(shift.shape) != (s.shape[1],):
        raise ValueError("stem_expand_pool: shapes "
                         f"{[tuple(a.shape) for a in args]} do not match")
    if any(a.device != s.device for a in args):
        raise ValueError("stem_expand_pool: tensors on "
                         f"{[str(a.device) for a in args]}")
    if s.device.type == "cpu":
        return stem_expand_pool_plain(*args)
    if s.device.type != "cuda":
        raise ValueError(f"stem_expand_pool: no kernel for device {s.device}")
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError("stem_expand_pool: the kernel takes float32, got "
                        f"{[a.dtype for a in args]}")
    P, C, Ho, Wo = s.shape
    K = offsets.shape[0]
    if not (0 < Wo <= MAX_WO and P < 2 ** 16 and C < 2 ** 16):
        raise ValueError(f"stem_expand_pool: the kernel takes Wo <= {MAX_WO} "
                         f"and P, C < 65536, got {tuple(s.shape)}")
    out = torch.empty((P, K, C, pooled_size(Ho), pooled_size(Wo)),
                      dtype=torch.float32, device=s.device)
    if out.numel() == 0:
        return out
    s, m, offsets, scale, shift = (a.contiguous() for a in args)
    fn = _kernel()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = fn(s.data_ptr(), m.data_ptr(), offsets.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                P, K, C, Ho, Wo, stream)
    if rc != 0:
        raise RuntimeError(f"stem_expand_pool launch failed: CUDA error {rc}")
    stem_expand_pool.launches += 1
    return out


stem_expand_pool.launches = 0
