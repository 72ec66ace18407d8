"""The port's evaluation entry (`python -m dyobav_tpu_torch.sim`) on the
CPU: its JSON summary carries the JAX package's keys, the DWA tracker and
the Kalman predictor run, a demo renders the live plot headless, and
without `--device` it needs a CUDA device.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from dyobav_tpu_torch.interfaces.dwa_interface import DwaInterface
from dyobav_tpu_torch.interfaces.mpc_interface import MpcInterface
from dyobav_tpu_torch.predictors.cvmp import CvmpInterface
from dyobav_tpu_torch.predictors.kfmp import KfmpInterface
from dyobav_tpu_torch.sim import entry
from dyobav_tpu_torch.sim.harness import MainBase

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "data", "warehouse_sim_original",
                                    "mymap.pgm")),
    reason="warehouse data not imported")


def _jax_summary_keys():
    """The keys the JAX package's `MainBase.results_summary` can return,
    read from its source (the port must not import it)."""
    path = os.path.join(REPO, "dyobav_tpu", "sim", "harness.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "results_summary")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name) and node.value.id == "out"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_eval_prints_the_jax_summary_keys(capsys):
    rc = entry.main(["eval", "--device", "cpu", "--steps", "2", "--runs",
                     "1", "--json", "--scenario", "1", "--seed", "1",
                     "--predictor", "cvmp"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = _jax_summary_keys()
    assert {"solve_time_mean_s", "solve_time_max_s", "converged_rate",
            "success_rate", "outcomes", "smoothness_mean",
            "deviation_max"} <= keys
    # A 2-step episode times out (a failure): no trajectory metrics.
    assert set(summary) == {"solve_time_mean_s", "solve_time_max_s",
                            "converged_rate", "success_rate", "outcomes"}
    assert set(summary) <= keys
    assert summary["success_rate"] == 0.0
    (outcome,) = summary["outcomes"]
    assert outcome["outcome"] == "timeout" and outcome["steps"] == 2
    assert 0.0 <= summary["converged_rate"] <= 1.0
    assert summary["solve_time_max_s"] >= summary["solve_time_mean_s"] > 0


@pytest.mark.parametrize("argv, match", [
    (["eval", "--tracker", "dwa"], None),
    (["eval", "--predictor", "kfmp"], None),
    (["demo", "--plot"], "item 8b"),
    (["demo", "--save-plot", "frame.png"], "item 8b"),
])
def test_unported_options_raise(argv, match, tmp_path, monkeypatch):
    """The options of ROADMAP item 9 (the DWA tracker, the Kalman
    predictor) and of item 8b (the live plot) run and return 0 since they
    were ported.  A demo step renders its frame on the plot headless
    (`Agg`); `--save-plot` writes it as a PNG, and `--plot` ends by
    showing the figure, which `Agg` does without a window.  `match` names
    the ROADMAP item of the plot cases."""
    monkeypatch.chdir(tmp_path)
    argv = argv + ["--device", "cpu", "--steps", "1", "--runs", "1"]
    if match is None:
        assert entry.main(argv) == 0
        return
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg")
    plt.close("all")
    assert entry.main(argv) == 0
    fig = plt.gcf()
    assert len(fig.axes) == 4                     # v, omega, cost, map
    assert fig.axes[3].get_title() == "Time: 0.00s / 0"
    if "--save-plot" in argv:
        with open(tmp_path / "frame.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    plt.close("all")


def test_harness_unported_branches_raise():
    """The branches of item 9 build the DWA interface and the Kalman
    predictor on the harness's device; an unknown tracker still raises."""
    base = MainBase(max_run_time_step=1, device="cpu")
    robot, _ = base._prepare_agents()
    for predictor, tracker, kinds in (
            ("cvmp", "dwa", (DwaInterface, CvmpInterface)),
            ("kfmp", "mpc", (MpcInterface, KfmpInterface))):
        intf, pred = base._prepare_interfaces(robot, predictor, tracker)
        assert isinstance(intf, kinds[0]) and isinstance(pred, kinds[1])
        assert intf.traj_tracker.device == torch.device("cpu")
    with pytest.raises(ValueError, match="Tracker type"):
        base._prepare_interfaces(robot, None, "pid")


def test_entry_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["eval", "--steps", "1", "--runs", "1"])


def test_module_entry_parses():
    out = subprocess.run([sys.executable, "-m", "dyobav_tpu_torch.sim",
                          "--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--scenario", "--runs", "--steps", "--seed", "--json",
                 "--ckpt", "--verbose", "--device"):
        assert flag in out.stdout
    assert "--platform" not in out.stdout
