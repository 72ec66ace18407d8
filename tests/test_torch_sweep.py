"""The port's sweep script (`python -m dyobav_tpu_torch.sim.sweep`) on the
CPU at a tiny size: it prints the JAX script's JSON keys, for one robot
and for the fleet, gives the unsharded run's statistics over 2 CPU shards
(`--devices 2`) and over 2 Gloo processes (`--distributed`), refuses the
device choices it would otherwise ignore, and does not run on the CPU
unless asked to.  The sweeps run once each (`sweep_json`), and the
`--distributed` check reuses the 2-shard ones.
"""
import ast
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO
from unittest import mock

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


def jax_sweep_keys(multi_host=False):
    """The keys of the JAX script's single-host `out = {...}` literal (its
    last one) or of its multi-host one (its first), read from the source
    without running a JAX sweep."""
    dicts = [node.value for node in ast.walk(ast.parse(JAX_SWEEP.read_text()))
             if isinstance(node, ast.Assign)
             and isinstance(node.value, ast.Dict)
             and [getattr(t, "id", None) for t in node.targets] == ["out"]]
    pick = min if multi_host else max
    return [k.value for k in pick(dicts, key=lambda d: d.lineno).keys]


# The keys that must not depend on how the batch is split (the wall times
# and the rate taken from them do).
TIMING = ("wall_s_first", "wall_s_steady", "control_steps_per_s")


def same_quality(sharded, single):
    """Every key but the device count and the timings equal."""
    assert sharded["devices"] == 2 and single["devices"] == 1
    assert set(sharded) == set(single)
    for key in set(single) - {"devices", *TIMING}:
        assert sharded[key] == single[key], key


# The script builds its SolverConfiguration itself; these runs give it a
# small cold and escalation budget, since only what it prints is under test.
SMALL = functools.partial(
    tconfigs.SolverConfiguration, cold_profile=(2, 1, 1, 1, 10.0),
    escalation_ladder=((2, 1, 1, 1, 10.0),))
ARGV = ("--device", "cpu", "--steps", "2", "--inner-iters", "2",
        "--outer-iters", "1", "--no-multistart")


@functools.lru_cache(maxsize=None)
def sweep_json(*argv):
    """The JSON object `main(ARGV + argv)` prints, at the small budget."""
    out = StringIO()
    with mock.patch.object(tconfigs, "SolverConfiguration", SMALL), \
            redirect_stdout(out):
        assert tsweep.main([*ARGV, *argv]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sweep_main_prints_the_jax_keys():
    # 3 scenarios on one device, then padded to 4 in 2 CPU shards: the
    # statistics over the first 3 lanes are the unsharded run's.
    out = sweep_json("--n", "3", "--devices", "1")
    # The keys dyobav_tpu/sim/sweep.py prints for one robot on one host.
    keys = jax_sweep_keys()
    assert len(keys) == 18 and "escalation_overflow_steps_mean" in keys
    assert list(out) == keys
    assert out["n_scenarios"] == 3 and out["devices"] == 1
    assert out["robots"] == 1 and out["steps_used_mean"] == 2.0
    assert np.isfinite(out["deviation_mean"])
    sharded = sweep_json("--n", "3", "--devices", "2")
    assert list(sharded) == keys and sharded["n_scenarios"] == 3
    same_quality(sharded, out)
    # Asked-for sizes the script refuses, and device choices it would
    # otherwise ignore.
    for bad in (["--devices", "-1"], ["--distributed", "--devices", "2"],
                ["--device", "cuda:0", "--devices", "2"],
                ["--device", "cuda:0", "--distributed"]):
        with pytest.raises(SystemExit) as exc:
            tsweep.main(["--device", "cpu"] + bad)
        assert exc.value.code == 2, bad


def test_sweep_fleet_prints_the_jax_keys():
    """`--robots 2` runs the fleet: the JAX script's keys and its fleet key,
    the per-robot statistics reduced per scenario, robots counted in the
    rate; over 2 CPU shards (3 scenarios padded to 4), the same
    statistics."""
    out = sweep_json("--robots", "2", "--n", "3")
    assert list(out) == jax_sweep_keys() + ["min_inter_robot_mean"]
    assert out["n_scenarios"] == 3 and out["robots"] == 2
    assert out["steps_used_mean"] == 2.0
    assert np.isfinite(out["min_inter_robot_mean"])
    assert np.isfinite(out["min_static_clearance_mean"])
    assert 0.0 <= out["collision_rate"] <= 1.0
    # 3 scenarios x 2 steps x 2 robots over the full run's wall time.
    assert out["control_steps_per_s"] == pytest.approx(
        3 * 2 * 2 / out["wall_s_steady"], rel=0.01, abs=0.06)
    same_quality(sweep_json("--robots", "2", "--n", "3", "--devices", "2"),
                 out)


def test_sweep_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.main([])
    # Shards default to CUDA devices too, and a named card is one.
    for argv in (["--devices", "2"], ["--devices", "0"],
                 ["--device", "cuda:1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tsweep.main(argv)


# A rank of `--distributed`: the small budget of `SMALL`, the process
# group joined from torchrun's environment, then the script's main on the
# command line it is given, for one robot and for 2.
CHILD = """
import functools, sys
import torch
torch.set_num_threads(1)
from dyobav_tpu_torch import configs
configs.SolverConfiguration = functools.partial(
    configs.SolverConfiguration, cold_profile=(2, 1, 1, 1, 10.0),
    escalation_ladder=((2, 1, 1, 1, 10.0),))
from dyobav_tpu_torch.parallel import mesh
from dyobav_tpu_torch.sim import sweep
assert mesh.init_distributed("cpu")
for robots in ("1", "2"):
    assert sweep.main(sys.argv[1:] + ["--robots", robots]) == 0
    sys.stdout.flush()
torch.distributed.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_sweep_matches_two_shards():
    """Two Gloo processes on the CPU (`--distributed`, torchrun's
    environment, a port the system chose): rank 0 prints the JAX script's
    multi-host keys with the statistics of one process's `--devices 2`
    run, counts equal and means within 1e-5 (the processes sum in float64,
    the one process averages float32 arrays), as
    scripts/multiproc_sweep_check.py asks of the JAX sweep; for one robot
    and for a fleet of 2, whose clearances are per robot (3 scenarios
    padded to 4, so rank 1 holds one valid row and one pad)."""
    # `--scenarios`, the alias of `--n` that passes through torchrun.
    argv = [*ARGV, "--scenarios", "3", "--distributed"]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(JAX_SWEEP.parents[2]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0].strip() == ""            # rank 1 prints nothing
    lines = outs[0][0].strip().splitlines()
    assert len(lines) == 2
    for robots, line in zip((1, 2), lines):
        multi = json.loads(line)
        shards = sweep_json(*(("--robots", "2") if robots == 2 else ()),
                            "--n", "3", "--devices", "2")
        assert list(multi) == jax_sweep_keys(multi_host=True)
        assert multi["hosts"] == 2 and multi["devices"] == 2
        assert multi["robots"] == robots
        for key in ("n_scenarios", "robots", "success_rate",
                    "collision_rate", "timeout_rate",
                    "solver_fail_steps_mean", "steps_used_mean",
                    "deviation_max"):
            assert multi[key] == shards[key], (robots, key)
        for key in ("min_clearance_mean", "min_static_clearance_mean",
                    "deviation_mean"):
            assert multi[key] == pytest.approx(shards[key], rel=1e-5), \
                (robots, key)
        np.testing.assert_allclose(multi["smoothness_mean"],
                                   shards["smoothness_mean"], rtol=1e-5)
