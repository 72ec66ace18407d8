"""Gaussian heat-map rasterization of the predictor's inputs, the port of
`dyobav_tpu.models.heatmap`.

Each 7-channel input holds five normalized Gaussian bumps at the past
positions (sigma = 20 px), the grayscale map channel and a constant
pred-offset channel (the reference builds it in numpy:
`utils_np.np_gaudist_map`, `pre_load.traj_to_input`).  The inputs of all
horizon offsets differ only in the offset channel, so the bumps and the map
are rasterized once and broadcast over the offsets.  Layout is NCHW; where
the JAX functions take one trajectory, these also take leading batch dims
(the port writes `vmap` out).
"""
from __future__ import annotations

import torch


def gaussian_map(center_xy: torch.Tensor, height: int, width: int,
                 sigma: float = 20.0) -> torch.Tensor:
    """Normalized Gaussian bump images (..., H, W), peak 1 at each
    `center_xy` (..., 2) = (x, y)."""
    c = torch.as_tensor(center_xy, dtype=torch.float32)
    x = torch.arange(width, dtype=torch.float32, device=c.device)
    y = torch.arange(height, dtype=torch.float32, device=c.device)
    gx = (x - c[..., 0, None]) ** 2                         # (..., W)
    gy = (y - c[..., 1, None]) ** 2                         # (..., H)
    # A product with 1 / (2 sigma^2), not a division: XLA makes that change
    # inside the JAX package's jitted stack functions, and where the exponent
    # nears -16 (a point ~110 px off the map) one ulp of it moves the
    # normalized bump by 1e-6.
    z = torch.exp(-(gx[..., None, :] + gy[..., :, None])
                  * (1.0 / (2.0 * sigma ** 2)))
    peak = torch.amax(z, dim=(-2, -1), keepdim=True)
    return z / torch.clamp(peak, min=1e-12)


def traj_to_input_stack(traj: torch.Tensor, ref_map: torch.Tensor,
                        offsets: torch.Tensor, sigma: float = 20.0,
                        obsv_len: int = 5) -> torch.Tensor:
    """Input stacks for all horizon offsets at once.

    Args:
        traj: (..., obsv_len, 2) past positions in pixel coordinates,
            already padded (`pad_traj`).
        ref_map: (H, W) grayscale map channel.
        offsets: (K,) prediction offsets (1..N_hor).
    Returns:
        (..., K, obsv_len + 2, H, W): the bumps, the map, the offset.
    """
    traj = torch.as_tensor(traj, dtype=torch.float32)
    if traj.shape[-2] != obsv_len:
        raise ValueError(f"traj has {traj.shape[-2]} positions, expected "
                         f"{obsv_len}")
    ref_map = torch.as_tensor(ref_map, dtype=torch.float32,
                              device=traj.device)
    offsets = torch.as_tensor(offsets, dtype=torch.float32,
                              device=traj.device)
    H, W = ref_map.shape
    lead, K = traj.shape[:-2], offsets.shape[0]
    heat = gaussian_map(traj, H, W, sigma)                  # (..., L, H, W)
    out = torch.empty(lead + (K, obsv_len + 2, H, W), dtype=torch.float32,
                      device=traj.device)
    out[..., :obsv_len, :, :] = heat[..., None, :, :, :]
    out[..., obsv_len, :, :] = ref_map
    out[..., obsv_len + 1, :, :] = offsets[:, None, None]
    return out


def traj_to_input_batch(trajs: torch.Tensor, ref_map: torch.Tensor,
                        offsets: torch.Tensor, sigma: float = 20.0,
                        obsv_len: int = 5) -> torch.Tensor:
    """Training-batch rasterization: B independent (traj, offset) samples
    sharing one map.  trajs (B, obsv_len, 2), offsets (B,) ->
    (B, obsv_len + 2, H, W)."""
    trajs = torch.as_tensor(trajs, dtype=torch.float32)
    offsets = torch.as_tensor(offsets, dtype=torch.float32,
                              device=trajs.device)
    stack = traj_to_input_stack(trajs, ref_map, offsets[:1], sigma,
                                obsv_len)[:, 0]
    stack[:, obsv_len + 1] = offsets[:, None, None]
    return stack


def pad_traj(traj, obsv_len: int = 5):
    """Pad with the last point, then keep the most recent `obsv_len`
    positions (pre_load.traj_to_input:120-122)."""
    traj = list(traj)
    if len(traj) < obsv_len:
        traj = traj + [traj[-1]] * (obsv_len - len(traj))
    return traj[-obsv_len:]
