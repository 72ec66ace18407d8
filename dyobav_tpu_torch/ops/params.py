"""Structured view of the flat NMPC parameter vector.

The flat layout is byte-compatible with the reference solver's parameter
vector and with `dyobav_tpu.ops.params`:

    z = [u_m1(2) | s_0(3) | s_N(3) | q(10) | r_s(60) | r_v(20) |
         c_0(ns*Nother) | c(ns*N_hor*Nother) | o_s(Nstcobs*nstcobs) |
         o_d(Ndynobs*ndynobs*(N_hor+1)) | q_stc(N_hor) | q_dyn(N_hor)]

`unpack` accepts any leading batch dims; every field then carries them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import MpcConfiguration


class MpcParams(NamedTuple):
    u_prev: torch.Tensor       # (nu,)            action at kt=-1
    s0: torch.Tensor           # (ns,)            current state
    sN: torch.Tensor           # (ns,)            goal state
    q: torch.Tensor            # (nq,)            penalty weights
    ref_states: torch.Tensor   # (N_hor, ns)      local reference states
    ref_speed: torch.Tensor    # (N_hor,)         reference speeds
    others0: torch.Tensor      # (Nother, ns)     other robots at kt=0
    others_pred: torch.Tensor  # (Nother, N_hor, ns)  predicted other robots
    stc_obs: torch.Tensor      # (Nstcobs, nstcobs)   half-space params (b|a0|a1)
    dyn_obs: torch.Tensor      # (Ndynobs, N_hor+1, ndynobs)  (x,y,rx,ry,ang,alpha)
    q_stc: torch.Tensor        # (N_hor,)         static obstacle weights
    q_dyn: torch.Tensor        # (N_hor,)         dynamic obstacle weights


def _field_shapes(cfg: MpcConfiguration):
    N = cfg.N_hor
    return [
        (cfg.nu,), (cfg.ns,), (cfg.ns,), (cfg.nq,), (N, cfg.ns), (N,),
        (cfg.Nother, cfg.ns), (cfg.Nother, N, cfg.ns),
        (cfg.Nstcobs, cfg.nstcobs),
        (cfg.Ndynobs, N + 1, cfg.ndynobs),
        (N,), (N,),
    ]


def unpack(z: torch.Tensor, cfg: MpcConfiguration) -> MpcParams:
    """Flat parameter vector (..., n_params) → structured MpcParams."""
    shapes = _field_shapes(cfg)
    sizes = [int(np.prod(s)) for s in shapes]
    if z.shape[-1] != sum(sizes):
        raise ValueError(
            f"Parameter vector has {z.shape[-1]} elements; this MPC config "
            f"needs {sum(sizes)} (see MpcConfiguration.n_params)")
    lead = z.shape[:-1]
    segs = torch.split(z, sizes, dim=-1)
    return MpcParams(*[s.reshape(*lead, *shape)
                       for s, shape in zip(segs, shapes)])


def pack(p: MpcParams) -> torch.Tensor:
    """Structured MpcParams → flat parameter vector (reference layout).
    Leading batch dims are taken from `p.u_prev`."""
    lead = p.u_prev.shape[:-1]
    return torch.cat([f.reshape(*lead, -1) for f in p], dim=-1)


def empty_params(cfg: MpcConfiguration, dtype=torch.float32,
                 device=None) -> MpcParams:
    """All-zero parameters: zero-radius ellipses and zero half-spaces are
    inactive in the cost (the reference's zero-fill defaults)."""
    return MpcParams(*[torch.zeros(s, dtype=dtype, device=device)
                       for s in _field_shapes(cfg)])


def tuning_vector(cfg: MpcConfiguration) -> np.ndarray:
    """The 10-element penalty vector q in reference order:
    [qpos, qvel, qtheta, lin_vel_penalty, ang_vel_penalty,
     qpN, qthetaN, qrpd, lin_acc_penalty, ang_acc_penalty]."""
    return np.array([
        cfg.qpos, cfg.qvel, cfg.qtheta, cfg.lin_vel_penalty,
        cfg.ang_vel_penalty, cfg.qpN, cfg.qthetaN, cfg.qrpd,
        cfg.lin_acc_penalty, cfg.ang_acc_penalty,
    ])
