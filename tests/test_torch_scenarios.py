"""The port's map loading and scenario constructors
(`dyobav_tpu_torch.sim.harness`, `.sim.scenarios`, `.maps`) against the JAX
package's: the same map files and the same seeds must give the same
obstacles, the same graph in the same order, and the same Scenario tensors,
exactly (all of this is host-side numpy in both packages).
"""
import os
import random

import numpy as np
import pytest
import torch

from dyobav_tpu.sim import harness as jh
from dyobav_tpu.sim import scenarios as js
from dyobav_tpu_torch.convert import scenario_from_numpy
from dyobav_tpu_torch.sim import harness as th
from dyobav_tpu_torch.sim import scenarios as ts
from dyobav_tpu_torch.sim.batch import Scenario, scenario_to_device
from dyobav_tpu_torch.trackers.mpc_tracker import TrajectoryTracker

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mymap.pgm")),
    reason="warehouse data not imported")


@pytest.fixture(scope="module")
def bases():
    return (jh.MainBase(evaluation=True, seed=0),
            th.MainBase(evaluation=True, seed=0))


def _assert_scenarios_equal(a, b):
    assert a._fields == b._fields == Scenario._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(y, x, err_msg=f)


def test_map_equals_jax_map(bases):
    jbase, tbase = bases
    obstacles = tbase.geo_map.processed_obstacle_list
    assert len(obstacles) == 55
    assert obstacles == jbase.geo_map.processed_obstacle_list
    assert tbase.geo_map.obstacle_list == jbase.geo_map.obstacle_list
    assert (tbase.geo_map.processed_boundary_coords
            == jbase.geo_map.processed_boundary_coords)
    np.testing.assert_array_equal(tbase.occ_map(), jbase.occ_map())
    assert tbase.map_extent == jbase.map_extent
    assert tbase.ct2real([10.0, 20.0, 0.3]) == jbase.ct2real([10.0, 20.0, 0.3])
    assert tbase.ref_map is None
    for preset in range(3):
        for x, y in zip(th.scenario(preset), jh.scenario(preset)):
            np.testing.assert_array_equal(np.asarray(x, dtype=object),
                                          np.asarray(y, dtype=object))


def test_graph_equals_networkx_graph_in_order(bases):
    jg, tg = bases[0].net_graph, bases[1].net_graph
    assert list(tg.nodes) == list(jg.nodes)
    for n in jg.nodes:
        assert list(tg.adj[n]) == list(jg.adj[n]), n
        assert tg.get_node_coord(n) == jg.get_node_coord(n)
    assert [tuple(e) for e in tg.edges] == [tuple(e) for e in jg.edges]
    assert tg.return_given_nodelist([9, 32, 16]) == \
        jg.return_given_nodelist([9, 32, 16])
    assert tg.return_random_nodelist(5, 4, random.Random(1)) == \
        jg.return_random_nodelist(5, 4, random.Random(1))
    # An edge to a node that was never added creates it, as networkx does.
    tg2, jg2 = (type(g)({1: (0, 0), 2: (1, 0)}, [(2, 7), (1, 2), (7, 1)])
                for g in (tg, jg))
    assert list(tg2.nodes) == list(jg2.nodes) == [1, 2, 7]
    assert [list(tg2.adj[n]) for n in tg2.nodes] == \
        [list(jg2.adj[n]) for n in jg2.nodes]


@pytest.mark.parametrize("preset", [0, 1, 2])
def test_preset_scenario_equals_jax(bases, preset):
    jbase, tbase = bases
    _assert_scenarios_equal(js.build_scenario(jbase, scenario_index=preset),
                            ts.build_scenario(tbase, scenario_index=preset))


def test_random_scenarios_equal_jax(bases):
    jbase, tbase = bases
    a = js.random_scenarios(jbase, 4, seed=3)
    b = ts.random_scenarios(tbase, 4, seed=3)
    _assert_scenarios_equal(a, b)
    assert b.robot_start.shape == (4, 3) and np.all(b.ref_len > 3)
    two = ts.random_scenarios(tbase, 3, n_humans=2, seed=5)
    _assert_scenarios_equal(js.random_scenarios(jbase, 3, n_humans=2, seed=5),
                            two)
    assert two.human_paths.shape[:2] == (3, 2)


def test_scenario_moves_to_tensors(bases):
    jbase, tbase = bases
    sc_np = ts.random_scenarios(tbase, 2, seed=1)
    sc = scenario_to_device(sc_np, "cpu")
    conv = scenario_from_numpy(js.random_scenarios(jbase, 2, seed=1))
    direct = ts.random_scenarios(tbase, 2, seed=1, device="cpu")
    for f in Scenario._fields:
        t = getattr(sc, f)
        assert isinstance(t, torch.Tensor)
        assert t.dtype == (torch.int64 if f in ("ref_len", "human_path_len")
                           else torch.float32), f
        np.testing.assert_array_equal(t.numpy(), getattr(sc_np, f))
        assert torch.equal(getattr(conv, f), t), f
        assert torch.equal(getattr(direct, f), t), f


def test_unported_parts_raise(bases):
    tbase = bases[1]
    for call in (tbase.run, tbase.run_once, tbase._prepare_agents):
        with pytest.raises(NotImplementedError, match="item 8"):
            call("mpc")
    with pytest.raises(NotImplementedError, match="item 8"):
        TrajectoryTracker(tbase.config_mpc, tbase.config_robot)
    with pytest.raises(NotImplementedError, match="item 10"):
        ts.random_fleet_scenarios(tbase, 2)
    with pytest.raises(ValueError, match="Invalid scenario"):
        th.scenario(3)
