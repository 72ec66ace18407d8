"""Each traffic generator is deterministic per seed, and the frozen copies
give what the program's originals give."""
from __future__ import annotations

import os

import numpy as np
import pytest

from navbench_cells import spec as cell_spec
from navbench import harness
from navbench.generators import pedestrians, receding, walks
from navbench.yardstick.png import gray_map


@pytest.mark.parametrize("seed", [0, 3000000001])
def test_receding_deterministic(seed):
    s = cell_spec("nmpc.solve.b2048")
    geo = {k: v for k, v in s["traffic"].items() if k not in (
        "driver", "generator", "batch", "steps_in", "loop")}
    mpc = s["config"]["mpc"]
    a = receding.RecedingProblems(mpc, 16, seed, **geo)
    b = receding.RecedingProblems(mpc, 16, seed, **geo)
    c = receding.RecedingProblems(mpc, 16, seed + 1, **geo)
    za, zb = a.make_Z(a.states, a.u_prev, 2), b.make_Z(b.states, b.u_prev, 2)
    assert za.shape == (16, receding.n_params(mpc)) and za.dtype == np.float32
    assert np.array_equal(za, zb)
    assert not np.array_equal(za, c.make_Z(c.states, c.u_prev, 2))
    u = np.tile(np.float32([1.0, 0.1]), (16, 20))
    n1, n2 = a.advance(a.states, u), b.advance(b.states, u)
    assert all(np.array_equal(x, y) for x, y in zip(n1, n2))


def test_receding_is_bench_generator():
    """The frozen generator packs what chip_smoke.make_problems (bench.py's
    generator through the port's `pack`) packs."""
    from chip_smoke import make_problems
    from dyobav_tpu_torch.configs import MpcConfiguration

    s = cell_spec("nmpc.solve.b2048")
    geo = {k: v for k, v in s["traffic"].items() if k not in (
        "driver", "generator", "batch", "steps_in", "loop")}
    gen = receding.RecedingProblems(s["config"]["mpc"], 8, 0, **geo)
    make_Z, states, u_prev, U0 = make_problems(MpcConfiguration(), 8, 0)
    for k in (0, 3):
        assert np.array_equal(gen.make_Z(gen.states, gen.u_prev, k),
                              make_Z(states, u_prev, k))
    assert np.array_equal(gen.U0, U0)


def test_pedestrians_deterministic():
    s = cell_spec("swta.predict.s64")
    m = s["config"]["map"]
    gray = gray_map(os.path.join(harness.ROOT, m["label_png"]))
    t = dict(s["traffic"], lanes=6)
    a = pedestrians.PedestrianHistories(t, m, gray, 3000000001)
    b = pedestrians.PedestrianHistories(t, m, gray, 3000000001)
    c = pedestrians.PedestrianHistories(t, m, gray, 7)
    h = a.call(4)
    assert h.shape == (6, 5, 1, 2)
    assert np.array_equal(h, b.call(4))
    assert not np.array_equal(h, a.call(5))
    assert not np.array_equal(h, c.call(4))
    # On the map: x in [-15, 18], y in [-15, 14.3] m.
    assert (h[..., 0] >= -15).all() and (h[..., 0] <= 18).all()
    assert (h[..., 1] >= -15).all() and (h[..., 1] <= 14.3).all()


def test_walks_deterministic_and_indexed_as_the_program(tmp_path):
    from dyobav_tpu_torch.models.data import WsdDataset

    s = cell_spec("swta.train.b20")
    t = dict(s["traffic"], videos=2, pedestrians=2, frames=12)
    label = os.path.join(harness.ROOT, s["config"]["map"]["label_png"])
    a, b, c = (walks.write(str(tmp_path / n), label, t, seed)
               for n, seed in (("a", 5), ("b", 5), ("c", 6)))
    ia, ib, ic = (walks.index(r, 5, 20) for r in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(ia, ib))
    assert not np.array_equal(ia[0], ic[0])
    ds = WsdDataset(a, obsv_len=5, pred_offset_max=20)
    assert len(ds) == len(ia[0])
    assert np.array_equal(np.stack([x.traj for x in ds.samples]), ia[0])
    assert np.array_equal(np.array([x.offset for x in ds.samples],
                                   np.float32), ia[1])
    assert np.array_equal(np.stack([x.label for x in ds.samples]), ia[2])
