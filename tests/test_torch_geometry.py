"""The port's point primitives of `utils.geometry` (torch, on their inputs'
device) against the JAX package's `jnp` versions on the same seeded numpy
inputs, within 1e-6, and the two map plot methods against the JAX
package's under matplotlib's Agg backend: the same lines, patches, texts
and collections drawn.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dyobav_tpu.maps import geometric as jgeo
from dyobav_tpu.maps import graph as jgraph
from dyobav_tpu.utils import geometry as jg
from dyobav_tpu_torch.maps import geometric as tgeo
from dyobav_tpu_torch.maps import graph as tgraph
from dyobav_tpu_torch.utils import geometry as tg

M = 16


def inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 2, s).astype(np.float32)  # noqa: E731
    return dict(point=f(2), points=f(M, 2), seg_a=f(M, 2), seg_b=f(M, 2),
                cx=f(M), cy=f(M), rx=np.abs(f(M)), ry=np.abs(f(M)),
                ang=f(M), b=f(M, 4), a0=f(M, 4), a1=f(M, 4),
                l1=f(2, 2), l2=f(2, 2))


CASES = {
    "dist_to_points_sq": ("point", "points"),
    "dist_to_linesegs": ("point", "seg_a", "seg_b"),
    "inside_ellipses": ("point", "cx", "cy", "rx", "ry", "ang"),
    "inside_cvx_polygon": ("point", "b", "a0", "a1"),
    "outside_cvx_polygon": ("point", "b", "a0", "a1"),
    "angle_between_vectors": ("l1", "l2"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_point_primitives_match_jax(name):
    for seed in range(4):
        x = inputs(seed)
        args = [x[k] for k in CASES[name]]
        if name == "dist_to_linesegs" and seed == 3:
            args[2] = args[1].copy()          # degenerate segments
        if name == "inside_cvx_polygon" and seed == 2:
            args[1] = np.abs(args[1]) + 10.0  # strictly inside every edge
        want = np.asarray(getattr(jg, name)(*map(jnp.asarray, args)))
        got = getattr(tg, name)(*map(torch.as_tensor, args))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} seed {seed}")


def test_primitives_keep_the_inputs_device_and_dtype():
    x = inputs(0)
    d = tg.dist_to_linesegs(*(torch.as_tensor(x[k], dtype=torch.float64)
                              for k in ("point", "seg_a", "seg_b")))
    assert d.dtype == torch.float64 and d.shape == (M,)
    assert tg.inside_cvx_polygon(torch.zeros(2), torch.zeros(4),
                                 torch.ones(4), torch.ones(4)) == 0.0


def drawn(ax):
    return dict(lines=len(ax.lines), patches=len(ax.patches),
                texts=[t.get_text() for t in ax.texts],
                collections=len(ax.collections),
                xy=[np.asarray(l.get_xydata()) for l in ax.lines],
                paths=[np.asarray(p.get_xy()) for p in ax.patches],
                segs=[np.asarray(s) for c in ax.collections
                      for s in c.get_segments()],
                colors=[np.asarray(c.get_edgecolor()) for c in
                        ax.collections],
                lims=(ax.get_xlim(), ax.get_ylim()))


def same_drawing(a, b):
    for key in ("lines", "patches", "texts", "collections"):
        assert a[key] == b[key], key
    for key in ("xy", "paths", "segs", "colors"):
        assert len(a[key]) == len(b[key]), key
        for u, v in zip(a[key], b[key]):
            np.testing.assert_allclose(u, v, rtol=0, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(a["lims"], b["lims"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("inflated", [True, False])
def test_geometric_map_plot_matches_jax(inflated):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    out = []
    for mod in (jgeo, tgeo):
        m = mod.GeometricMap([(0, 0), (10, 0), (10, 8), (0, 8)],
                             [[(2, 2), (4, 2), (4, 5), (2, 5)],
                              [(6, 1), (8, 1), (7, 3)]],
                             inflate_margin=0.3)
        fig, ax = plt.subplots()
        m.plot(ax, inflated=inflated)
        out.append(drawn(ax))
        plt.close(fig)
    same_drawing(out[1], out[0])
    assert out[1]["lines"] == (2 if inflated else 1)
    assert out[1]["patches"] == (4 if inflated else 2)


def test_netgraph_plot_matches_jax():
    mpl = pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    nodes = {1: (0, 0), 2: (1, 0), 3: (2, 0.5), 4: (0, 1), 5: (2, 1)}
    edges = [(1, 2), (2, 3), (1, 4), (3, 5), (4, 5)]
    for kw in ({}, {"node_text": False, "node_style": "o",
                    "edge_color": "b"}):
        out = []
        for mod in (jgraph, tgraph):
            fig, ax = plt.subplots()
            mod.NetGraph(nodes, edges).plot_netgraph(ax, **kw)
            out.append(drawn(ax))
            plt.close(fig)
        same_drawing(out[1], out[0])
        assert out[1]["lines"] == 5 and out[1]["collections"] == 1
        assert len(out[1]["texts"]) == (0 if kw else 5)
