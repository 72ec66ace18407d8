"""The port's sweep script (`python -m dyobav_tpu_torch.sim.sweep`) on the
CPU at a tiny size: it prints the JAX script's JSON keys, refuses what is
not ported, and does not run on the CPU unless asked to.
"""
import ast
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from dyobav_tpu_torch import configs as tconfigs
from dyobav_tpu_torch.sim import sweep as tsweep

# One intra-op thread: the solver's operators are tiny at these sizes, and
# the suite's parallel workers would otherwise oversubscribe the cores.
torch.set_num_threads(1)

JAX_SWEEP = (pathlib.Path(__file__).resolve().parent.parent
             / "dyobav_tpu" / "sim" / "sweep.py")


def jax_sweep_keys():
    """The keys of the JAX script's single-host `out = {...}` literal (its
    last one; the multi-host branch's comes first), read from the source
    without running a JAX sweep."""
    dicts = [node.value for node in ast.walk(ast.parse(JAX_SWEEP.read_text()))
             if isinstance(node, ast.Assign)
             and isinstance(node.value, ast.Dict)
             and [getattr(t, "id", None) for t in node.targets] == ["out"]]
    last = max(dicts, key=lambda d: d.lineno)
    return [k.value for k in last.keys]


def test_sweep_main_prints_the_jax_keys(capsys, monkeypatch):
    # The script builds its SolverConfiguration itself; give it a small cold
    # and escalation budget here, where only what it prints is under test.
    monkeypatch.setattr(tconfigs, "SolverConfiguration", functools.partial(
        tconfigs.SolverConfiguration, cold_profile=(2, 1, 1, 1, 10.0),
        escalation_ladder=((2, 1, 1, 1, 10.0),)))
    rc = tsweep.main(["--device", "cpu", "--n", "2", "--steps", "2",
                      "--inner-iters", "2", "--outer-iters", "1",
                      "--no-multistart"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The keys dyobav_tpu/sim/sweep.py prints for one robot on one host.
    keys = jax_sweep_keys()
    assert len(keys) == 18 and "escalation_overflow_steps_mean" in keys
    assert list(out) == keys
    assert out["n_scenarios"] == 2 and out["devices"] == 1
    assert out["robots"] == 1 and out["steps_used_mean"] == 2.0
    assert np.isfinite(out["deviation_mean"])
    for argv, item in ((["--robots", "2"], "item 10"),
                       (["--devices", "4"], "item 13"),
                       (["--distributed"], "item 13")):
        with pytest.raises(SystemExit) as exc:
            tsweep.main(["--device", "cpu"] + argv)
        assert exc.value.code == 2
        assert item in capsys.readouterr().err


def test_sweep_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.main([])
