"""The port's device lists and batch sharding (`dyobav_tpu_torch.parallel
.mesh`) against the JAX package's `parallel.mesh` on the CPU: padding,
the rows each device gets (held against the addressable shards of JAX's
`shard_batch` on the 8 virtual CPU devices of tests/conftest.py), and a
closed-loop sim sharded over 2 CPU shards against the port's unsharded run
and against JAX's sim under `shard_map` over 2 virtual devices, as
tests/test_batch_sim.py::test_batched_sim_sharded_matches_unsharded holds
JAX's 8-way run.

That sim runs at B = 8 for 2 steps, not 8, and at the sweep tests' small
budget (inner 2, outer 1, cold and escalation profiles (2, 1, 1, 1)), not
at tests/test_batch_sim.py's FAST one: on one CPU thread the eager port
pays per call, not per lane, so 2 shards cost about 2 runs, and FAST's 8
steps took 86 s for the unsharded run alone.  At B = 8 every distressed
lane has a cold slot, sharded or not (K = max(B // 2, min(B, 8), 1) = B),
so the runs must agree number for number.
"""
import functools
import os

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.parallel import mesh as jmesh
from dyobav_tpu.sim import batch as jb
from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.parallel import mesh as tmesh
from dyobav_tpu_torch.sim import batch as tb
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
# The JAX side solves with Cholesky, as the port does (see
# tests/test_torch_batch_sim.py); the port reads the same fields.
JSMALL = jcfg.SolverConfiguration(
    max_inner_iters=2, max_outer_iters=1, inner_iters_later=3,
    cold_profile=(2, 1, 1, 1, 10.0), escalation_ladder=((2, 1, 1, 1, 10.0),),
    linear_solver="cholesky")
SMALL = config_from_dict(tcfg.SolverConfiguration,
                         dataclasses.asdict(JSMALL))
B, STEPS = 8, 2
needs_map = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")


@pytest.mark.parametrize("n, multiple", [(5, 4), (8, 4), (3, 1), (1, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.random.default_rng(n).normal(size=(n, 3, 2))
    (pj, nj), (pt, nt) = (jmesh.pad_to_multiple(x, multiple),
                          tmesh.pad_to_multiple(x, multiple))
    assert nt == nj == n and pt.shape[0] % multiple == 0
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_shard_batch_rows_match_jax_addressable_shards(n_dev):
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(n_dev)
    tree = {"a": rng.normal(size=(16, 3)).astype(np.float32),
            "b": np.arange(16 * 2).reshape(16, 2)}
    jsh = jmesh.shard_batch(jmesh.make_mesh(n_dev), tree)
    mesh = tmesh.make_mesh(devices=["cpu"] * n_dev)
    tsh = tmesh.shard_batch(mesh, tree)
    assert len(tsh) == n_dev
    for key in tree:
        shards = sorted(jsh[key].addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == n_dev
        for i, s in enumerate(shards):
            np.testing.assert_array_equal(tsh[i][key].numpy(),
                                          np.asarray(s.data))
    # One process: make_global_batch gives shard_batch's rows; replicate
    # one copy a device.
    glob = tmesh.make_global_batch(mesh, tree)
    for i in range(n_dev):
        for key in tree:
            assert torch.equal(glob[i][key], tsh[i][key])
    rep = tmesh.replicate(mesh, tree)
    assert len(rep) == n_dev and torch.equal(
        rep[-1]["b"], torch.as_tensor(tree["b"]))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_batch(tmesh.make_mesh(devices=["cpu"] * 3), tree)


def test_shard_map_batch_concatenates_trees():
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    x = torch.arange(8.0)

    def fn(v, s):
        return tb.BatchResult(*([v * 2] * 12)), {"s": s + v.shape[0]}

    res, extra = tmesh.shard_map_batch(fn, mesh)(
        tmesh.shard_batch(mesh, x), tmesh.shard_batch(mesh, np.arange(8)))
    assert isinstance(res, tb.BatchResult)
    assert torch.equal(res.success, x * 2)
    assert torch.equal(extra["s"], torch.arange(8) + 2)
    with pytest.raises(ValueError, match="shards"):
        tmesh.shard_map_batch(fn, mesh)(tmesh.shard_batch(mesh[:2], x),
                                        tmesh.shard_batch(mesh[:2], x))


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(2)
    assert tmesh.make_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="available"):
        tmesh.make_mesh(5, devices=["cpu"] * 4)


def test_init_distributed_without_env_falls_back(monkeypatch, capsys):
    for key in tmesh.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert tmesh.init_distributed("cpu") is False
    assert "init_distributed: single-host fallback" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


@functools.lru_cache(maxsize=None)
def port_runs():
    """The port's sim on B scenarios, unsharded and over 2 CPU shards, each
    lane's pedestrian stagger drawn from its seed in the global batch."""
    base = th.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0)
    rs = ts.random_scenarios(base, B, seed=7)
    run = tb.build_batch_sim(base.config_mpc, base.config_robot, SMALL,
                             n_steps=STEPS, device="cpu")
    mesh = tmesh.make_mesh(devices=["cpu"] * 2)
    sharded = tmesh.shard_map_batch(run, mesh)(
        tmesh.shard_batch(mesh, rs), tmesh.shard_batch(mesh, np.arange(B)))
    return run(rs, np.arange(B)), sharded


def assert_same_result(got, want):
    """Integers and flags equal, floats within 1e-4 where finite."""
    for name in tb.BatchResult._fields:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        mask = np.isfinite(a)
        assert np.array_equal(mask, np.isfinite(b)), name
        np.testing.assert_allclose(b[mask], a[mask], rtol=0, atol=1e-4,
                                   err_msg=name)


@needs_map
def test_sharded_sim_matches_unsharded():
    single, sharded = port_runs()
    # The seeds are the global batch's: lane b's stagger differs from lane
    # b+1's whichever shard holds them.
    assert single.min_clearance.std() > 0
    assert_same_result(sharded, single)
    assert int(single.escalation_overflow_steps.sum()) == 0


@needs_map
def test_sharded_sim_matches_jax_shard_map():
    """The port's 2-shard run against JAX's sim under `shard_map` over 2 of
    the virtual CPU devices, each device running its own rows with slots
    sized from them.  JAX gets the stagger the port drew from the global
    seeds as its `stagger_stream` (the packages' random streams differ),
    so a shard that drew from its local seeds would part from it.

    `dyobav_tpu.parallel.mesh.shard_map_batch` itself cannot trace this sim
    under the JAX installed here: `jax.shard_map`'s varying-axes check
    rejects a `lax.scan` carry in the Newton solver's Hessian
    (dyobav_tpu/ops/newton.py:171), so the test builds the same
    `jit(shard_map(fn, P("data") -> P("data")))` with that check off."""
    from jax.sharding import PartitionSpec as P

    _, sharded = port_runs()
    jbase = jh.MainBase(max_run_time_step=STEPS, evaluation=True, seed=0)
    stream = torch.stack([
        tb.draw_stagger((STEPS, 1), 0.5, torch.Generator().manual_seed(s))
        for s in range(B)]).numpy()

    def lanes(sc, seeds, stag):
        return jb.build_batch_sim(
            jbase.config_mpc, jbase.config_robot, JSMALL, n_steps=STEPS,
            stagger_stream=stag)(sc, seeds)

    run = jax.jit(jax.shard_map(
        lanes, mesh=jmesh.make_mesh(2), in_specs=P(jmesh.DATA_AXIS),
        out_specs=P(jmesh.DATA_AXIS), check_vma=False))
    rs = js.random_scenarios(jbase, B, seed=7)
    res = run(jb.Scenario(*[jnp.asarray(np.asarray(x)) for x in rs]),
              jnp.arange(B), jnp.asarray(stream))
    assert_same_result(sharded, res)
