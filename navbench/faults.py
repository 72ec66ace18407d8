"""Faults planted under a cell's timed path, to show that `correct` catches
them (`calibrate.py --faults`, `tests/test_navbench_faults.py`).  Never
used by a benchmark run.

  unchanged  the step returns its state unchanged: the solve returns its
             warm guess as converged (with its true cost and states), the
             predictor the previous call's answer, training skips AdamW
  half       half of the batch is left out: the solve and the predictor
             answer the second half with the first half's answers,
             training takes the loss over the first half of each batch
  altered    one answer is altered where it is produced: one lane's
             action (+0.05), one cluster mean (+0.1 m), a step's loss
             (x 1.01)
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


def _solve_wrapper(bundle, fault, mpc, robot):
    from dyobav_tpu_torch.ops.engine import MpcSolve

    from .reference import nmpc as reference

    inner = bundle.solve_batch_escalated

    def unchanged(Z, U0):
        Zt = torch.as_tensor(Z, device=bundle.device, dtype=torch.float32)
        U = torch.as_tensor(U0, device=bundle.device, dtype=torch.float32)
        P = reference.unpack(Zt, mpc)
        lo, hi, _, _ = reference.bounds(mpc, robot, U.dtype, U.device)
        U = torch.minimum(torch.maximum(U, lo), hi)
        with torch.no_grad():
            f, _, _, X, _ = reference.evaluate(U, P, mpc, robot)
        ok = torch.ones(U.shape[0], dtype=torch.bool, device=U.device)
        zero = torch.zeros_like(f)
        return MpcSolve(u=U, cost=f, pred_states=X, exit_ok=ok,
                        infeasibility=zero, residual=zero)

    def half(Z, U0):
        h = Z.shape[0] // 2
        sol = inner(Z[:h], U0[:h])
        return type(sol)(*[torch.cat([t, t[:Z.shape[0] - h]]) for t in sol])

    def altered(Z, U0):
        sol = inner(Z, U0)
        u = sol.u.clone()
        u[0, 2] += 0.05
        return sol._replace(u=u)

    return bundle._replace(solve_batch_escalated={
        "unchanged": unchanged, "half": half, "altered": altered}[fault])


def _predict_wrapper(predict, fault):
    last = {}

    def unchanged(hist):
        out = predict(hist) if "out" not in last else last["out"]
        last["out"] = out
        return out

    def half(hist):
        h = hist.shape[0] // 2
        out = predict(hist[:h])
        return tuple(torch.cat([t, t[:hist.shape[0] - h]]) for t in out)

    def altered(hist):
        mu, std, alpha = predict(hist)
        mu = mu.clone()
        mu[0, 0, 0, 0] += 0.1
        return mu, std, alpha

    return {"unchanged": unchanged, "half": half, "altered": altered}[fault]


def plant(cell, fault: str) -> None:
    """Break the timed path of a built solve or predictor cell."""
    if hasattr(cell, "bundle"):
        cell.bundle = _solve_wrapper(cell.bundle, fault, cell.cfg["mpc"],
                                     cell.cfg["robot"])
    else:
        cell.predict = _predict_wrapper(cell.predict, fault)


@contextlib.contextmanager
def training(fault: str):
    """Break `NetworkManager`'s optimizer step while a training cell is
    built (its checked steps run in set-up) and run."""
    from dyobav_tpu_torch.models import manager
    from dyobav_tpu_torch.models.wta_net import full_f32

    saved = manager.NetworkManager._step

    def step(self, images, labels, k_top, relax):
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        if fault == "half":
            h = images.shape[0] // 2
            images, labels = images[:h], labels[:h]
        with full_f32():
            loss = self.loss_fn(self.net(images), labels, k_top=k_top,
                                relax=relax)
            loss.backward()
        if fault != "unchanged":
            self.optimizer.step()
        if fault == "altered":
            loss = loss * 1.01
        return loss.detach()

    manager.NetworkManager._step = step
    try:
        yield
    finally:
        manager.NetworkManager._step = saved
