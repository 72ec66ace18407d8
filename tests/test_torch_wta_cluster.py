"""The port's cluster-Gaussian fit (`dyobav_tpu_torch.ops.cluster`) against
the JAX package's `cluster_gaussian_fit_horizon` and against the port's
host mirrors `fit_dbscan_np` + `fit_cluster2gaussian` (themselves held to
the JAX package's mirrors), on identical hypotheses.

alpha and the membership must be exact, mu within 1e-5 m, and sigma is
compared as sigma^2 within 1e-5 m^2: sqrt(E[x^2] - mu^2) magnifies f32
rounding where a cluster is nearly a point.  The port takes the variance in
two passes, as np.std does; the JAX package's one pass, E[x^2] - mu^2 in
float32, is itself up to ~5e-5 m^2 from the float64 mirror at map
coordinates (|x| ~ 15 m), so there sigma^2 is held to the mirror, the
test shows the JAX package's own departure, and the port's distance from
JAX is bounded by it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.ops import cluster as jc
from dyobav_tpu_torch.ops import cluster as tc

torch.set_num_threads(1)

EPS, ENLARGE, C = 1.0, 2.0, 8


def _clouds(rng, lo, hi, sets=20):
    """Predictor-like hypothesis sets: a few modes of 0.3 m spread between
    lo and hi (x, y), and some strays."""
    centers = rng.uniform(lo, hi, (sets, 3, 2))
    pick = rng.integers(0, 3, (sets, 20))
    pts = (centers[np.arange(sets)[:, None], pick]
           + rng.normal(0, 0.3, (sets, 20, 2)))
    pts[:, ::7] = rng.uniform(lo, hi, (sets, 3, 2))
    return pts


def _cases():
    """(name, (T, n, 2) float32 hypotheses, whether the JAX package's one-
    pass variance is within 1e-5 m^2 of float64 on them)."""
    rng = np.random.default_rng(0)
    cases = [("clouds_near_origin", _clouds(rng, -3.0, 3.0), True),
             # The warehouse map's world extent.
             ("clouds_map_scale", _clouds(rng, [-15.0, -15.0], [18.0, 14.3]),
              False)]
    # Chains whose links are exactly eps (1.0 and 0.75 steps are exact in
    # f32), so adjacency rests on d^2 <= eps^2 with equality.
    chain = np.zeros((2, 20, 2))
    chain[0, :, 0] = np.arange(20) * 1.0                  # one component
    chain[1, :10, 1] = np.arange(10) * 1.0                # two chains
    chain[1, 10:, 0] = 3.0 + np.arange(10) * 0.75
    cases.append(("chains_at_eps", chain, True))
    # Links just over eps: all singletons, no cluster.
    cases.append(("singletons", np.stack(
        [np.arange(20) * 1.0001 - 10.0, np.zeros(20)], -1)[None], True))
    # 10 pairs far apart: more components than slots; ranks >= 8 dropped.
    pairs = np.zeros((1, 20, 2))
    pairs[0, :, 0] = np.repeat(np.arange(10) * 1.5 - 7.0, 2)
    pairs[0, 1::2, 1] = 0.5
    cases.append(("more_than_max_clusters", pairs[:, rng.permutation(20)],
                  True))
    return [(name, p.astype(np.float32), ok) for name, p, ok in cases]


CASES = _cases()


def _mirror(pts):
    """The port's host mirror per step: (member (C, n) bool, mu (C, 2),
    var (C, 2), alpha (C,)) from `fit_dbscan_np` + `fit_cluster2gaussian`,
    which must give what the JAX package's mirrors give, bit for bit."""
    clusters = tc.fit_dbscan_np(pts, EPS, 2)[:C]
    mus, stds = tc.fit_cluster2gaussian(clusters, enlarge=1.0)
    clusters_j = jc.fit_dbscan_np(pts, EPS, 2)[:C]
    mus_j, stds_j = jc.fit_cluster2gaussian(clusters_j, enlarge=1.0)
    assert len(clusters) == len(clusters_j)
    for a, b in zip(clusters + mus + stds, clusters_j + mus_j + stds_j):
        np.testing.assert_array_equal(a, b)
    n = pts.shape[0]
    member = np.zeros((C, n), bool)
    mu, var, alpha = np.zeros((C, 2)), np.zeros((C, 2)), np.zeros(C)
    for c, cl in enumerate(clusters):
        # Map the cluster's points back to their indices (points distinct).
        member[c] = (pts[:, None, :] == cl[None].astype(np.float32)).all(
            -1).any(-1)
        mu[c], var[c], alpha[c] = mus[c], stds[c] ** 2, 1.0
    return member, mu, var, alpha


@pytest.mark.parametrize("name,pts,jax_var_exact", CASES,
                         ids=[c[0] for c in CASES])
def test_cgf_matches_jax_and_host_mirror(name, pts, jax_var_exact):
    mu_t, std_t, alpha_t = (x.numpy() for x in tc.cluster_gaussian_fit(
        torch.from_numpy(pts), eps=EPS, enlarge=ENLARGE, max_clusters=C))
    member_t = tc.cluster_membership(torch.from_numpy(pts), EPS, C).numpy()
    mu_j, std_j, alpha_j = (np.asarray(x) for x in
                            jc.cluster_gaussian_fit_horizon(
                                jnp.asarray(pts), eps=EPS, enlarge=ENLARGE,
                                max_clusters=C))
    assert mu_t.shape == (pts.shape[0], C, 2) and alpha_t.shape[-1] == C
    np.testing.assert_array_equal(alpha_t, alpha_j)
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=1e-5)
    var_t, var_j = (std_t / ENLARGE) ** 2, (std_j / ENLARGE) ** 2
    mirror = [_mirror(p) for p in pts]
    var_m = np.stack([m[2] for m in mirror])
    for t, (member, mu, _, alpha) in enumerate(mirror):
        np.testing.assert_array_equal(member_t[t], member, err_msg=f"{t}")
        np.testing.assert_array_equal(alpha_t[t], alpha)
        np.testing.assert_allclose(mu_t[t], mu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(var_t, var_m, rtol=0, atol=1e-5)
    if jax_var_exact:
        np.testing.assert_allclose(var_t, var_j, rtol=0, atol=1e-5)
    else:
        # The JAX package's own float32 cancellation, not the port's.
        jax_gap = np.abs(var_j - var_m).max()
        assert jax_gap > 1e-5
        assert np.abs(var_t - var_m).max() < 1e-6
        # So the port is no farther from JAX than JAX is from float64.
        assert np.abs(var_t - var_j).max() <= jax_gap + 1e-6
    expect_active = {"chains_at_eps": [1, 2], "singletons": [0],
                     "more_than_max_clusters": [C]}.get(name)
    if expect_active is not None:
        assert alpha_t.sum(-1).tolist() == expect_active


def test_cgf_batches_over_leading_dims():
    """Lanes x humans x offsets in one call equal the per-set calls."""
    pts = CASES[0][1].reshape(2, 2, 5, 20, 2)
    mu, std, alpha = tc.cluster_gaussian_fit(torch.from_numpy(pts))
    assert mu.shape == (2, 2, 5, C, 2) and alpha.shape == (2, 2, 5, C)
    flat = tc.cluster_gaussian_fit(torch.from_numpy(pts.reshape(20, 20, 2)))
    for a, b in zip((mu, std, alpha), flat):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b.numpy(),
                                   rtol=0, atol=1e-6)
