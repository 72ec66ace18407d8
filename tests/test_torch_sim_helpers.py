"""The batched simulation's per-step helpers (`dyobav_tpu_torch.sim.batch`)
against `jax.vmap` of their JAX counterparts (`dyobav_tpu.sim.batch`).

Inputs are made with numpy from a seed and go through both.  Floats agree
to 1e-6 absolute (the same f32 formulas; `hypot` and `norm` may round in
the last bit), integers and bools exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dyobav_tpu.sim import batch as jb
from dyobav_tpu_torch.sim import batch as tb

ATOL = 1e-6


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i" else x)


def _close(t, j, atol=ATOL):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if j.dtype.kind in "ib":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)


def _ref_trajs(rng, B, R):
    """Padded reference trajectories: a random walk of `ref_len` points,
    then the last point repeated, as the scenario constructor pads them."""
    ref_len = rng.integers(3, R + 1, B).astype(np.int32)
    ref_len[0], ref_len[1] = R, 3
    traj = np.cumsum(rng.normal(0.0, 0.25, (B, R, 3)), axis=1).astype(
        np.float32)
    for b in range(B):
        traj[b, ref_len[b]:] = traj[b, ref_len[b] - 1]
    return traj, ref_len


def test_ref_window_select_matches_jax():
    rng = np.random.default_rng(0)
    B, R, N = 12, 40, 20
    traj, ref_len = _ref_trajs(rng, B, R)
    # Indices at the start, mid-way, at the clamped end of the slice
    # (ref_idx - 1 + 6 > R) and past the true length.
    ref_idx = rng.integers(0, R, B).astype(np.int32)
    ref_idx[:6] = [0, 1, R - 1, R - 3, R - 6, 38]
    state = (traj[np.arange(B), np.minimum(ref_idx, R - 1)]
             + rng.normal(0, 0.2, (B, 3))).astype(np.float32)
    for steps in (1, 2):
        wj, ij = jax.vmap(lambda t, l, i, s: jb.ref_window_select(
            t, l, i, s, N, steps))(jnp.asarray(traj), jnp.asarray(ref_len),
                                   jnp.asarray(ref_idx), jnp.asarray(state))
        wt, it = tb.ref_window_select(_t(traj), _t(ref_len), _t(ref_idx),
                                      _t(state), N, steps)
        _close(it, ij)
        _close(wt, wj)


def test_human_waypoint_step_matches_jax():
    rng = np.random.default_rng(1)
    B, H, W = 6, 3, 4
    vmax, mag, ts = 1.5, 0.5, 0.2
    paths = rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32)
    path_len = rng.integers(1, W + 1, (B, H)).astype(np.int32)
    wp = rng.integers(0, W, (B, H)).astype(np.int32)
    humans = rng.uniform(-5, 5, (B, H, 2)).astype(np.float32)
    # Lane 0: pedestrian 0 is within reach of its LAST waypoint (pops it
    # and stops), pedestrian 1 within reach of a middle one (pops, targets
    # the next), pedestrian 2 already finished.
    path_len[0] = [3, 4, 2]
    wp[0] = [2, 1, 2]
    humans[0, 0] = paths[0, 0, 2] + 0.05
    humans[0, 1] = paths[0, 1, 1] - 0.1
    stagger = (rng.choice([-1.0, 1.0], (B, H)) * rng.integers(0, 11, (B, H))
               / 10.0 * mag).astype(np.float32)
    hj, wj, _ = jax.vmap(lambda h, w, p, l, s: jb.human_waypoint_step(
        h, w, p, l, None, vmax, mag, ts, stagger=s))(
        jnp.asarray(humans), jnp.asarray(wp), jnp.asarray(paths),
        jnp.asarray(path_len), jnp.asarray(stagger))
    ht, wt = tb.human_waypoint_step(_t(humans), _t(wp), _t(paths),
                                    _t(path_len), None, vmax, mag, ts,
                                    stagger=_t(stagger))
    _close(wt, wj)
    _close(ht, hj)
    assert wt[0].tolist() == [3, 2, 2]
    np.testing.assert_array_equal(ht[0, 0].numpy(), humans[0, 0])  # stopped
    # Without a stream the port draws from its generator: the reference's
    # distribution (sign x tenths x magnitude), reproducible from the seed.
    draws = [tb.draw_stagger((4000,), mag, torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    tenths = (draws[0].abs() / mag * 10).round()
    assert set(tenths.long().tolist()) == set(range(11))
    assert 0.4 < float((draws[0] > 0).float().mean()
                       / (draws[0] != 0).float().mean()) < 0.6
    moved, _ = tb.human_waypoint_step(
        _t(humans), _t(wp), _t(paths), _t(path_len),
        torch.Generator().manual_seed(7), vmax, mag, ts)
    assert moved.shape == humans.shape and bool(torch.isfinite(moved).all())


def test_cv_predict_horizon_matches_jax():
    rng = np.random.default_rng(2)
    B, H, N = 6, 3, 20
    hist = np.cumsum(rng.normal(0, 0.2, (B, 5, H, 2)), axis=1).astype(
        np.float32)
    outs_j = jax.vmap(lambda h: jb.cv_predict_horizon(h, N))(jnp.asarray(hist))
    for t, j in zip(tb.cv_predict_horizon(_t(hist), N), outs_j):
        _close(t, j)
    n_valid = np.array([0, 1, 2, 3, 4, 9], np.int32)
    outs_j = jax.vmap(lambda h, n: jb.cv_predict_horizon(h, N, n_valid=n))(
        jnp.asarray(hist), jnp.asarray(n_valid))
    outs_t = tb.cv_predict_horizon(_t(hist), N, n_valid=_t(n_valid))
    assert outs_t[0].shape == (B, N, H, 2) and outs_t[2].shape == (B, N, H)
    for t, j in zip(outs_t, outs_j):
        _close(t, j, atol=2e-6)      # mu reaches |x| ~ 20: one f32 ulp


def _polygons(rng, B, M, n_real):
    """(B, M, 4, 2) rectangles, slots past n_real FAR-padded, and their
    (B, M, 12) halfspace rows (zero in the padded slots)."""
    polys = np.full((B, M, 4, 2), jb.FAR_COORD, np.float32)
    c = rng.uniform(-8, 8, (B, n_real, 1, 2))
    half = rng.uniform(0.3, 1.5, (B, n_real, 1, 2))
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    polys[:, :n_real] = (c + half * corners).astype(np.float32)
    stc = np.zeros((B, M, 12), np.float32)
    stc[:, :n_real] = rng.normal(size=(B, n_real, 12)).astype(np.float32)
    return polys, stc


def test_polygon_helpers_match_jax():
    rng = np.random.default_rng(3)
    B, M, n_real = 8, 16, 7
    polys, stc = _polygons(rng, B, M, n_real)
    pt = rng.uniform(-8, 8, (B, 2)).astype(np.float32)
    pt[0] = polys[0, 2].mean(axis=0)                    # strictly inside
    pt[1] = 0.5 * (polys[1, 3, 0] + polys[1, 3, 1])     # on an edge
    pt[2] = polys[2, 0, 0]                              # on a vertex
    # Lane 3: two real obstacles at the same distance (a symmetric pair).
    polys[3, 1] = polys[3, 0] * np.array([-1.0, 1.0], np.float32)
    polys[3, 1] = polys[3, 1, ::-1]
    pt[3] = [0.0, polys[3, 0, :, 1].mean()]
    state = np.concatenate([pt, rng.uniform(-3, 3, (B, 1))], 1).astype(
        np.float32)

    dj = jax.vmap(jb.polygon_edge_distances)(jnp.asarray(polys),
                                             jnp.asarray(pt))
    dt = tb.polygon_edge_distances(_t(polys), _t(pt))
    # Distances to the FAR slots are ~1.4e6, where one f32 ulp is 0.125.
    _close(dt[:, :n_real], dj[:, :n_real])
    np.testing.assert_allclose(dt[:, n_real:], np.asarray(dj)[:, n_real:],
                               rtol=1e-6)
    assert float(dt[3, 0]) == float(dt[3, 1])           # the tie is real

    ij = jax.vmap(jb.point_in_any_quad)(jnp.asarray(pt), jnp.asarray(polys))
    it = tb.point_in_any_quad(_t(pt), _t(polys))
    _close(it, ij)
    assert bool(it[0]) and not bool(it[1]) and not bool(it[2])

    n_top = 10                       # more than n_real: FAR slots all tie
    sj = jax.vmap(lambda p, s, x: jb.closest_obstacle_halfspaces(
        p, s, x, n_top))(jnp.asarray(polys), jnp.asarray(stc),
                         jnp.asarray(state))
    st = tb.closest_obstacle_halfspaces(_t(polys), _t(stc), _t(state), n_top)
    assert st.shape == (B, n_top, 12)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(st[3, 0].numpy(), stc[3, 0])  # lower index
    assert not st[:, n_real:].any()                     # padded rows inert


def test_assemble_dyn_obstacles_matches_jax():
    rng = np.random.default_rng(4)
    B, H, N, slots, cols = 5, 2, 20, 15, 6
    humans = rng.uniform(-5, 5, (B, H, 2)).astype(np.float32)
    for K in (H, 6):                 # cvmp: one slot per human; a predictor
        mu = rng.normal(size=(B, N, K, 2)).astype(np.float32)
        std = rng.uniform(0.1, 1, (B, N, K, 2)).astype(np.float32)
        alpha = rng.uniform(0, 1, (B, N, K)).astype(np.float32)
        dj = jax.vmap(lambda h, m, s, a: jb.assemble_dyn_obstacles(
            h, (m, s, a), slots, cols, N, jnp.float32))(
            jnp.asarray(humans), jnp.asarray(mu), jnp.asarray(std),
            jnp.asarray(alpha))
        dt = tb.assemble_dyn_obstacles(_t(humans), (_t(mu), _t(std),
                                                    _t(alpha)),
                                       slots, cols, N, torch.float32)
        assert dt.shape == (B, slots, N + 1, cols)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
