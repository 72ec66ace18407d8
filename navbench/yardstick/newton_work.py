"""The linear algebra an escalated solve must do, from its configuration.

Each Newton iteration of the port's ALM solver (and of the JAX package it
follows) solves, for every lane, one n x n SPD system per rung of its
four-rung Levenberg-Marquardt ladder and per substep; each stage ends with
one more iteration's systems for its stationarity probe.  A stage of
profile (inner, outer, later, substeps) runs inner + max(later, 4) (outer
- 1) iterations.  The warm stage runs over all B lanes; each escalation
stage over its K = max(B // divisor, min(B, 16), 1) slots, counted as run
(a batch of B = 2048 always leaves some lane to escalate).  The count
follows the configuration, not the program, so it stays what a solve must
do whichever kernel does it.
"""
from __future__ import annotations

from .spd_bound import spd_flops

RUNGS = 4


def _calls(inner, outer, later, substeps) -> int:
    iters = inner + max(later, 4) * (outer - 1)
    return iters * max(int(substeps), 1) + 1


def spd_systems(B: int, scfg) -> dict:
    """SPD calls and systems of one escalated solve of B lanes."""
    warm = _calls(scfg.max_inner_iters, scfg.max_outer_iters,
                  scfg.inner_iters_later, scfg.newton_substeps)
    ladder = [tuple(p) for p in scfg.escalation_ladder]
    divisors = list(scfg.escalation_slots)
    divisors += [divisors[-1]] * (len(ladder) - len(divisors))
    slots = [max(B // d, min(B, 16), 1) for d in divisors[:len(ladder)]]
    esc_calls = [_calls(*p[:4]) for p in ladder]
    return {"slots": slots[0],
            "systems": RUNGS * (B * warm + sum(
                k * c for k, c in zip(slots, esc_calls)))}


def escalated_solve_flops(B: int, scfg, mpc: dict) -> int:
    n = mpc["nu"] * mpc["N_hor"]
    return spd_systems(B, scfg)["systems"] * spd_flops(1, n)
