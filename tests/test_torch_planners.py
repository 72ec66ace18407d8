"""The port's planners (`dyobav_tpu_torch.planners`: networkx- and
pandas-free) against the JAX package's, on the same inputs: the seven
cases of tests/test_planners.py, each held against the JAX planner, and
k-shortest paths on graphs whose paths tie.

networkx's Dijkstra breaks ties between equal-length paths by its heap's
push order and the graph's adjacency order, and Yen's algorithm removes
and re-adds edges, which moves them to the end of that order; the port
follows both, so even on a unit-weight lattice, where almost every path
ties, it returns networkx's paths in networkx's order.
"""
import math
import os
import random

import numpy as np
import pandas as pd
import pytest

from dyobav_tpu.maps import geometric as jgeo
from dyobav_tpu.maps import graph as jgraph
from dyobav_tpu.planners import dijkstra as jdij
from dyobav_tpu.planners import global_plan as jgp
from dyobav_tpu.planners import paths as jpaths
from dyobav_tpu.planners import visibility as jvis
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch.maps import geometric as tgeo
from dyobav_tpu_torch.maps import graph as tgraph
from dyobav_tpu_torch.planners import dijkstra as tdij
from dyobav_tpu_torch.planners import global_plan as tgp
from dyobav_tpu_torch.planners import paths as tpaths
from dyobav_tpu_torch.planners import visibility as tvis
from dyobav_tpu_torch.sim import harness as th

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ({1: (0, 0), 2: (1, 0), 3: (2, 0), 4: (0, 1), 5: (2, 1)},
        [(1, 2), (2, 3), (1, 4), (3, 5), (4, 5)])


def graphs(nodes, edges):
    """The same weighted graph in both packages (tests/test_planners.py's
    `grid_graph` for GRID)."""
    out = []
    for mod in (jgraph, tgraph):
        g = mod.NetGraph(nodes, edges)
        g.set_distance_weight()
        out.append(g)
    return out


def lattice(n):
    """An n x n unit lattice: paths between far corners tie by the
    hundreds."""
    nodes = {i * n + j: (j, i) for i in range(n) for j in range(n)}
    edges = [(k, k + 1) for k in nodes if k % n < n - 1] + [
        (k, k + n) for k in nodes if k + n < n * n]
    return nodes, edges


def random_graph(n, seed):
    """A connected random geometric graph: a spanning path and the pairs
    closer than 0.35, distances as weights (no two paths tie)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 2))
    nodes = {i: tuple(p) for i, p in enumerate(pos)}
    edges = [(i, i + 1) for i in range(n - 1)] + [
        (i, j) for i in range(n) for j in range(i + 2, n)
        if np.hypot(*(pos[i] - pos[j])) < 0.35]
    random.Random(seed).shuffle(edges)
    return nodes, edges


def test_dijkstra_shortest():
    jg, tg = graphs(*GRID)
    out = [mod.DijkstraPathPlanner(g).k_shortest_paths(1, 5, k=1,
                                                      get_coords=False)
           for mod, g in ((jdij, jg), (tdij, tg))]
    assert out[1] == out[0]
    assert out[1][0][0] == pytest.approx(3.0)


def test_dijkstra_k_shortest():
    jg, tg = graphs(*GRID)
    (lj, pj), (lt, pt) = [
        mod.DijkstraPathPlanner(g).k_shortest_paths(1, 5, k=2,
                                                    get_coords=False)
        for mod, g in ((jdij, jg), (tdij, tg))]
    # Both paths have length 3: the tie resolves as networkx resolves it.
    assert pt == pj and lt == lj
    assert len(pt) == 2 and pt[0] != pt[1]
    assert lt[1] == pytest.approx(3.0)


@pytest.mark.parametrize("graph, pairs, k", [
    (lattice(5), [(0, 24), (4, 20), (2, 22), (6, 18)], 6),
    (random_graph(30, 0), [(0, 29), (3, 17), (11, 25)], 5),
    (random_graph(30, 1), [(0, 29), (5, 20)], 5),
], ids=["lattice_ties", "random0", "random1"])
def test_k_shortest_paths_match_networkx(graph, pairs, k):
    jg, tg = graphs(*graph)
    for s, t in pairs:
        (lj, pj), (lt, pt) = [
            mod.DijkstraPathPlanner(g).k_shortest_paths(s, t, k=k)
            for mod, g in ((jdij, jg), (tdij, tg))]
        assert pt == pj, (s, t)
        assert lt == lj, (s, t)
    # Yen's edits work on a copy: the planner's graph keeps its order.
    assert list(tg.edges) == list(jg.edges)
    assert [list(tg.adj[n]) for n in tg.nodes] == [list(jg.adj[n])
                                                   for n in jg.nodes]


def test_dijkstra_coords():
    jg, tg = graphs(*GRID)
    (_, pj), (_, pt) = [
        mod.DijkstraPathPlanner(g).k_shortest_paths(1, 3, k=1,
                                                    get_coords=True)
        for mod, g in ((jdij, jg), (tdij, tg))]
    assert pt == pj
    assert pt[0][0] == (0, 0, 1) and pt[0][-1] == (2, 0, 3)


def test_unreachable_target_has_one_candidate_less():
    """A target cut off after the first path: both stop at the paths that
    exist."""
    nodes = {1: (0, 0), 2: (1, 0), 3: (2, 0)}
    jg, tg = graphs(nodes, [(1, 2), (2, 3)])
    out = [mod.DijkstraPathPlanner(g).k_shortest_paths(1, 3, k=3,
                                                      get_coords=False)
           for mod, g in ((jdij, jg), (tdij, tg))]
    assert out[1] == out[0] == ([2.0, ], [[1, 2, 3]])
    with pytest.raises(tdij.NoPath):
        tdij.single_source_dijkstra(tgraph.NetGraph(nodes, [(1, 2)]), 1, 3)


def test_visibility_planner_detours():
    outs = []
    for geo, vis in ((jgeo, jvis), (tgeo, tvis)):
        m = geo.GeometricMap([(0, 0), (10, 0), (10, 10), (0, 10)],
                             [[(4, 3), (6, 3), (6, 7), (4, 7)]],
                             inflate_margin=0.2)
        path = vis.LocalPathPlanner(m).get_ref_path((1.0, 5.0), (9.0, 5.0))
        outs.append(np.array([p() for p in path]))
    pj, pt = outs
    assert pt.shape == pj.shape and len(pt) > 2
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
    assert tuple(pt[0]) == (1.0, 5.0) and tuple(pt[-1]) == (9.0, 5.0)
    for x, y in pt[1:-1]:
        assert not (3.8 < x < 6.2 and 2.8 < y < 7.2), (x, y)


@pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "data", "warehouse_sim_original",
                                    "mymap.pgm")),
    reason="warehouse data not imported")
def test_visibility_detour_on_the_warehouse_map():
    """The warehouse map's 12 obstacles nearest its tallest shelf (the
    visibility graph of all 55 takes ~40 s a query on either side), a
    query straight through that shelf, and a 3-waypoint route."""
    bases = (jh.MainBase(max_run_time_step=1, scenario_index=0),
             th.MainBase(max_run_time_step=1, scenario_index=0,
                         device="cpu"))
    infl = [np.array(o) for o in bases[0].geo_map.processed_obstacle_list]
    tall = int(np.argmax([np.ptp(o[:, 1]) for o in infl]))
    cent = np.array([o.mean(0) for o in infl])
    near = np.argsort(np.linalg.norm(cent - cent[tall], axis=1))[:12]
    half = np.ptp(infl[tall][:, 0]) / 2
    y = float(cent[tall, 1])
    start = (float(cent[tall, 0] - half - 1.0), y)
    end = (float(cent[tall, 0] + half + 1.0), y)
    outs = []
    for base, geo, vis in zip(bases, (jgeo, tgeo), (jvis, tvis)):
        g = base.geo_map
        m = geo.GeometricMap([tuple(x) for x in g.boundary_coords],
                             [[tuple(v) for v in g.obstacle_list[j]]
                              for j in near], inflate_margin=0.7)
        planner = vis.LocalPathPlanner(m)
        direct = planner.get_ref_path(start, end)
        route = planner.get_ref_path_waypoints(
            [start, end, (end[0], y - 3.0)])
        outs.append([np.array([p() for p in direct]),
                     np.array([p() for p in route])])
    for pj, pt in zip(*outs):
        assert pt.shape == pj.shape
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
    assert len(outs[1][0]) > 2          # around the shelf, not through it


def test_global_planner_detailed_schedule():
    jp, tp = jgp.GlobalPathPlanner(), tgp.GlobalPathPlanner()
    cols = {"robot_id": [7, 7, 7, 8], "node_id": [1, 2, 3, 4],
            "ETA": [0.0, 1.0, 2.0, 0.5]}
    jp.load_schedule_from_dataframe(pd.DataFrame(cols))
    tp.load_schedule_from_rows([dict(zip(cols, r))
                                for r in zip(*cols.values())])
    assert tp.robot_ids == jp.robot_ids == [7, 8]
    for rid in (7, 8):
        assert tp.get_robot_schedule(rid) == jp.get_robot_schedule(rid)
    assert tp.get_robot_schedule(7) == ([1, 2, 3], [0.0, 1.0, 2.0])
    # set_path replaces one robot's rows.
    jp.set_path(8, [5, 6], [1.0, 2.0])
    tp.set_path(8, [5, 6], [1.0, 2.0])
    assert tp.robot_ids == jp.robot_ids
    assert tp.get_robot_schedule(8) == jp.get_robot_schedule(8) == (
        [5, 6], [1.0, 2.0])


def test_global_planner_rough_schedule(tmp_path):
    jg, tg = graphs(*GRID)
    jp, tp = jgp.GlobalPathPlanner(), tgp.GlobalPathPlanner()
    jp.load_graph(jg)
    tp.load_graph(tg)
    csv = tmp_path / "schedule.csv"
    csv.write_text("robot_id,start_node,end_node,EDT\n9,1,5,6.0\n"
                   "3,2,5,4.5\n")
    jp.load_schedule(str(csv))
    tp.load_schedule(str(csv))
    assert tp.robot_ids == jp.robot_ids == [9, 3]
    for rid, offset in ((9, 1.0), (3, 0.0)):
        nj, tj = jp.get_robot_schedule(rid, time_offset=offset)
        nt, tt = tp.get_robot_schedule(rid, time_offset=offset)
        assert nt == nj and tt == tj
    nodes, times = tp.get_robot_schedule(9, time_offset=1.0)
    assert nodes[0] == 1 and nodes[-1] == 5
    assert times[0] == pytest.approx(1.0) and times[-1] == pytest.approx(7.0)
    assert tgp.GlobalPathPlanner.get_shortest_path(tg, 2, 4) == \
        jgp.GlobalPathPlanner.get_shortest_path(jg, 2, 4)


def test_path_containers():
    out = []
    for mod in (jpaths, tpaths):
        pl = mod.PathNodeList.from_tuples([(0, 0), (1, 2)])
        n = mod.PathNode(3, 4, node_id=5)
        before = pl.get_node_coords(5)
        pl.append(n)
        traj = mod.TrajectoryNodeList.from_tuples([(0, 1, 0.5), (2, 3, 1.0)])
        out.append((pl.numpy(), pl[1](), before, pl.get_node_coords(5),
                    pl.rescale(2.0)[2](), pl.to_tuples(), traj.numpy(),
                    repr(n), n[1], n == mod.PathNode(3, 4)))
    for a, b in zip(out[1], out[0]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert out[1][3] == (3.0, 4.0) and out[1][2] is None
    assert math.isclose(out[1][4][0], 6.0)
