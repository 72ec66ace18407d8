"""The plain references agree with the port at a tiny size on the CPU."""
from __future__ import annotations

import os

import numpy as np
import torch

from navbench_cells import spec as cell_spec
from navbench import harness
from navbench.reference import nmpc, swta_net
from navbench.yardstick.png import gray_map


def test_nmpc_objective_matches_port(cpu):
    """The reference's objective, f1, f2 and states are the port's
    `ops/costs.evaluate` in float64 on perturbed actions."""
    from dyobav_tpu_torch.configs import (CircularRobotSpecification,
                                          MpcConfiguration)
    from dyobav_tpu_torch.ops import costs
    from dyobav_tpu_torch.ops.params import unpack

    from navbench.generators.receding import RecedingProblems

    s = cell_spec("nmpc.solve.b2048")
    mpc, robot = s["config"]["mpc"], s["config"]["robot"]
    gen = RecedingProblems(mpc, 6, 11)
    Z = torch.as_tensor(gen.make_Z(gen.states, gen.u_prev, 1), dtype=torch.float64)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(gen.U0 + rng.normal(0, 0.3, gen.U0.shape),
                        dtype=torch.float64)
    f, f1, f2, X, _ = nmpc.evaluate(u, nmpc.unpack(Z, mpc), mpc, robot)
    cfg, rob = MpcConfiguration(), CircularRobotSpecification()
    P = unpack(Z, cfg)
    for b in range(6):
        br = costs.evaluate(u[b], type(P)(*[x[b] for x in P]), cfg, rob)
        assert torch.allclose(br.objective, f[b], rtol=1e-12, atol=1e-9)
        assert torch.allclose(br.f1, f1[b], rtol=1e-12, atol=1e-12)
        assert torch.allclose(br.f2, f2[b], rtol=1e-12, atol=1e-12)
        assert torch.allclose(br.states, X[b], rtol=1e-12, atol=1e-12)


def test_descent_gap_separates(cpu):
    """A solved lane reads near 0; its warm guess, one step stale, does
    not."""
    drv = harness.load_module("drivers", "nmpc_solve")
    s = cell_spec("nmpc.solve.b2048")
    cell = drv.Cell(s["config"], dict(s["traffic"], batch=4), 5, cpu)
    cell.window(0.0)
    Z, u, cost, pred, ok = cell.solved[0]
    mpc, robot = s["config"]["mpc"], s["config"]["robot"]
    P = nmpc.unpack(torch.as_tensor(Z, dtype=torch.float64), mpc)
    tol = s["config"]["solver"]["constraint_tol"]
    good = nmpc.descent_gap(u.double(), P, mpc, robot, tol)
    stale = nmpc.descent_gap(torch.as_tensor(cell.guess).double(), P, mpc,
                             robot, tol)
    assert good.max() < 1e-4 and stale.max() > 1e-2


def test_net_flops_and_forward_match_port(cpu):
    from chip_smoke import conv_net_flops
    from dyobav_tpu_torch.models.heatmap import traj_to_input_stack
    from dyobav_tpu_torch.models.wta_net import load_checkpoint

    s = harness.cell("swta.predict.s64")["config"]
    path = os.path.join(harness.ROOT, s["checkpoint"])
    net = load_checkpoint(path, "cpu")
    assert swta_net.flops_per_image(293, 330) == conv_net_flops(
        net, (7, 293, 330)) == 2069596288
    net = net.double()
    gray = gray_map(os.path.join(harness.ROOT, s["map"]["label_png"]))
    traj = torch.tensor([[(160.0, 50.0 + 3 * i) for i in range(5)],
                         [(40.0 + 2 * i, 200.0) for i in range(5)]],
                        dtype=torch.float64)
    offsets = torch.tensor([3.0, 17.0], dtype=torch.float64)
    x = swta_net.input_stack(traj, torch.as_tensor(gray), offsets)
    port = torch.stack([traj_to_input_stack(
        traj[i].float(), torch.as_tensor(gray, dtype=torch.float32),
        offsets[i:i + 1].float())[0] for i in range(2)]).double()
    assert (x - port).abs().max() < 1e-6
    sd = swta_net.load(path, torch.float64, "cpu")
    with torch.no_grad():
        assert (swta_net.forward(sd, x) - net(x)).abs().max() < 1e-9
    net.train()
    stats = {}
    out = swta_net.forward(sd, x, train=True, stats=stats)
    assert (out - net(x)).abs().max() < 1e-9
    nsd = net.state_dict()
    assert all(torch.allclose(stats[k], nsd[k], rtol=1e-10, atol=1e-10)
               for k in stats)


def test_predictor_reference_matches_port(cpu):
    """The reference's (mu, std, alpha) are the port's predictor's on every
    set that is not ambiguous."""
    drv = harness.load_module("drivers", "swta_predict")
    s = harness.cell("swta.predict.s64")
    cell = drv.Cell(s["config"], dict(s["traffic"], lanes=2), 9, cpu)
    cell._call(keep=True)
    cell.release()
    r = cell.judge()
    assert r["alpha_mismatch"] == 0
    assert r["mu_gap_m"] < 1e-3 and r["std_gap_m"] < 1e-3
    assert r["ambiguous_share"] < 0.05


def test_training_reference_follows_port(cpu):
    """Three steps at batch 4: the port (float32) and the reference
    (float64) from the same weights and rows."""
    drv = harness.load_module("drivers", "swta_train")
    s = cell_spec("swta.train.b20")
    t = dict(s["traffic"], videos=1, pedestrians=2, frames=12, batch=4)
    cell = drv.Cell(s["config"], t, 5, cpu)
    cell.release()
    r = cell.judge()
    assert r["loss1_gap"] < 1e-5 and r["leaves_compared"] > 100
    assert r["grad1_norm_gap"] < 0.02 and r["change_norm_gap"] < 0.2
