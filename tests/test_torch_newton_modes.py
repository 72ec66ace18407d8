"""The off-default modes of the port's ALM-Newton solver
(`dyobav_tpu_torch.ops.newton`) and the small cost and cluster helpers
beside them, against the JAX package on the CPU: `schulz_spd_solve`, the
"structured" and "jacfwd" merit Hessians, the staged solve
(`fused=False`) with its `scaled_residual`, `costs.constraint_residuals`
and `cluster.cluster_gaussian_fit_horizon`.

The staged solve is held in float64 (JAX under `jax.enable_x64`), where the
two frameworks take the same LM decisions and agree to 1e-8, and in float32
by outcome.  The JAX side solves with `linear_solver="cholesky"`, the TPU
kernel's semantics, as every port test does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_escalation import _problem_batch
from test_torch_costs import _both, _busy_problem, _merit_jax

from dyobav_tpu import configs as jcfg
from dyobav_tpu.ops import cluster as jcluster
from dyobav_tpu.ops import costs as jcosts
from dyobav_tpu.ops import newton as jnewton
from dyobav_tpu.ops.engine import build_mpc_solver as jax_build
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict
from dyobav_tpu_torch.ops import cluster as tcluster
from dyobav_tpu_torch.ops import costs as tcosts
from dyobav_tpu_torch.ops import engine as tengine
from dyobav_tpu_torch.ops import newton as tnewton
from dyobav_tpu_torch.ops import spd
from dyobav_tpu_torch.ops.params import MpcParams

torch.set_num_threads(1)

JCFG, JROBOT = jcfg.MpcConfiguration(), jcfg.CircularRobotSpecification()
CFG, ROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
N = CFG.N_hor
# A short budget on which some lanes converge: 4 + 2 x 4 iterations, two
# chord substeps, the shipped warm penalty of 1250.
SHORT = dict(max_inner_iters=4, max_outer_iters=3, inner_iters_later=4,
             newton_substeps=2, initial_penalty=1250.0, cold_profile=None)
# The budget of the float32 comparisons (also tests/test_torch_engine.py's
# mode cases): 10 + 4 x 5 iterations with the penalty ramped from 10, on
# which 7 of the 8 problems converge.  At SHORT the lanes that do not
# converge are mid-iteration at curvatures of 1e6, where float32 JAX and
# the port part (as do JAX's own LU and Cholesky solves).
FLOAT32_BUDGET = dict(max_inner_iters=10, max_outer_iters=5,
                      inner_iters_later=5, newton_substeps=1,
                      initial_penalty=10.0, cold_profile=None)


def _closure(fn, name):
    """The function called `name` that `fn` closes over, at any depth (the
    solvers' inner functions are closures of their builders)."""
    stack, seen = [fn], set()
    while stack:
        f = stack.pop()
        if id(f) in seen or not hasattr(f, "__code__"):
            continue
        seen.add(id(f))
        for var, cell in zip(f.__code__.co_freevars, f.__closure__ or ()):
            value = cell.cell_contents
            if var == name:
                return value
            stack.append(value)
    raise LookupError(name)


def _spd_batch(rng, lead, n=40, cond=10.0):
    """Well-conditioned SPD systems (eigenvalues in [s, cond * s])."""
    q, _ = np.linalg.qr(rng.normal(size=lead + (n, n)))
    eig = rng.uniform(1.0, cond, lead + (n,)) * rng.uniform(
        0.5, 50.0, lead + (1,))
    A = np.einsum("...ij,...j,...kj->...ik", q, eig, q)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    return A.astype(np.float32), rng.normal(size=lead + (n,)).astype(
        np.float32)


@pytest.mark.parametrize("iters", [14, 20])
def test_schulz_spd_solve_matches_jax(iters):
    A, g = _spd_batch(np.random.default_rng(iters), (4, 4))
    j = np.asarray(jnewton.schulz_spd_solve(jnp.asarray(A), jnp.asarray(g),
                                            iters))
    t = tnewton.schulz_spd_solve(torch.from_numpy(A), torch.from_numpy(g),
                                 iters).numpy()
    rel = np.abs(t - j).max() / np.abs(j).max()
    print(f"schulz iters={iters}: port vs JAX max rel {rel:.2e}")
    assert rel <= 1e-5
    exact = np.linalg.solve(A.astype(np.float64),
                            g.astype(np.float64)[..., None])[..., 0]
    assert np.abs(t - exact).max() <= 1e-4 * np.abs(exact).max()


def _port_solver(scfg, split=True, dtype=torch.float32):
    """The port's per-lane-batched solver for `scfg` and its pieces."""
    lo, hi = tcosts.action_bounds(CFG, ROBOT, dtype)
    clo, chi = tcosts.acceleration_bounds(CFG, ROBOT, dtype)

    def obj(u, p):
        br = tcosts.evaluate(u, p, CFG, ROBOT)
        return br.objective, br.f1, br.f2

    return tnewton.make_alm_newton_solver(
        obj, lo, hi, clo, chi, scfg,
        split=(lambda p: tcosts.split_objective(p, CFG, ROBOT)) if split
        else None)


def _lanes(pts):
    return MpcParams(*[torch.stack(f) for f in zip(*pts)])


def _busy_inputs(seed):
    rng = np.random.default_rng(100 + seed)
    z, u = _busy_problem(seed)
    u = u + rng.normal(0, 0.05, u.shape).astype(np.float32)
    y = rng.normal(0, 1.0, 2 * N).astype(np.float32)
    return z, u, y


def test_structured_and_jacfwd_hessians_match_jax_and_block():
    scfg = tcfg.SolverConfiguration
    hess = {mode: _closure(_port_solver(scfg(hessian_mode=mode)),
                           "merit_hess")
            for mode in ("block", "structured", "jacfwd")}
    hess["no_split"] = _closure(_port_solver(scfg(), split=False),
                                "merit_hess")
    lo, hi = jcosts.acceleration_bounds(JCFG, JROBOT)

    @jax.jit
    def jax_hessians(u, y, c, pj):
        split = jcosts.split_objective(pj, JCFG, JROBOT)
        proj = lambda x: jnp.clip(x, lo, hi)
        return (jnewton.make_structured_hessian(split, proj)(u, y, c),
                jax.jacfwd(jax.grad(_merit_jax(pj, lo, hi)))(u, y, c))

    for seed in range(2):
        z, u, y = _busy_inputs(seed)
        pj, pt = _both(z)
        P = _lanes([pt])
        for c in (10.0, 1250.0):
            Hs_j, Hj_j = (np.asarray(h) for h in jax_hessians(
                jnp.asarray(u), jnp.asarray(y), jnp.float32(c), pj))
            args = (torch.from_numpy(u)[None], torch.from_numpy(y)[None],
                    torch.tensor([c]), P)
            H = {k: f(*args)[0].numpy() for k, f in hess.items()}
            np.testing.assert_array_equal(H["no_split"], H["jacfwd"])
            scale = max(np.abs(Hj_j).max(), 1.0)
            for name, port, ref in (
                    ("structured vs JAX structured", H["structured"], Hs_j),
                    ("jacfwd vs JAX jacfwd", H["jacfwd"], Hj_j),
                    ("structured vs block", H["structured"], H["block"]),
                    ("jacfwd vs block", H["jacfwd"], H["block"])):
                # tests/test_hessian.py's bar: f32 accumulation-order noise
                # on curvatures that reach 1e6 once c escalates.
                np.testing.assert_allclose(port, ref, rtol=5e-4,
                                           atol=5e-5 * scale,
                                           err_msg=f"{name} seed={seed} c={c}")


def test_scaled_residual_matches_jax():
    tres = _closure(_port_solver(tcfg.SolverConfiguration(fused=False)),
                    "scaled_residual")
    lo_u, hi_u = jcosts.action_bounds(JCFG, JROBOT)
    lo, hi = jcosts.acceleration_bounds(JCFG, JROBOT)

    @jax.jit
    def jres(u, y, c, pj):
        def obj(v):
            br = jcosts.evaluate(v, pj, JCFG, JROBOT)
            return br.objective, br.f1, br.f2
        solve = jnewton.make_alm_newton_solver(
            obj, lo_u, hi_u, lo, hi,
            jcfg.SolverConfiguration(fused=False, linear_solver="cholesky"),
            split=jcosts.split_objective(pj, JCFG, JROBOT))
        return _closure(solve, "scaled_residual")(u, y, c)

    zs, us, ys, pts = [], [], [], []
    for seed in range(3):
        z, u, y = _busy_inputs(seed)
        zs.append(z), us.append(u), ys.append(y)
        pts.append(_both(z)[1])
    cs = np.array([10.0, 1250.0, 50.0], np.float32)
    t = tres(torch.from_numpy(np.stack(us)), torch.from_numpy(np.stack(ys)),
             torch.from_numpy(cs), _lanes(pts)).numpy()
    j = np.array([float(jres(jnp.asarray(u), jnp.asarray(y), jnp.float32(c),
                             _both(z)[0]))
                  for z, u, y, c in zip(zs, us, ys, cs)])
    print(f"scaled residual: JAX {j}, port {t}")
    assert (j > 1e-3).all()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_constraint_residuals_match_jax():
    fn = jax.jit(lambda u, p: jcosts.constraint_residuals(u, p, JCFG,
                                                          JROBOT))
    for seed in range(4):
        z, u, _ = _busy_inputs(seed)
        pj, pt = _both(z)
        j = fn(jnp.asarray(u), pj)
        t = tcosts.constraint_residuals(torch.from_numpy(u), pt, CFG, ROBOT)
        for name, a, b in zip(("f1", "stc", "dyn"), j, t):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, name
            scale = max(float(np.abs(a).max()), 1.0)
            assert np.abs(a - b).max() <= 1e-5 * scale, (seed, name)
        # Every kind of residual is active somewhere.
        assert (np.asarray(j[1]) > 0).any() and (np.asarray(j[2]) > 0).any()


def test_cluster_gaussian_fit_horizon_matches_jax():
    rng = np.random.default_rng(3)
    centers = rng.uniform(-3.0, 3.0, (N, 3, 2))
    pts = (centers[np.arange(N)[:, None], rng.integers(0, 3, (N, 20))]
           + rng.normal(0, 0.3, (N, 20, 2))).astype(np.float32)
    j = jcluster.cluster_gaussian_fit_horizon(jnp.asarray(pts),
                                              max_clusters=8)
    t = tcluster.cluster_gaussian_fit_horizon(torch.from_numpy(pts),
                                              max_clusters=8)
    (mu_j, std_j, al_j), (mu_t, std_t, al_t) = ([np.asarray(x) for x in j],
                                                [x.numpy() for x in t])
    assert mu_t.shape == std_t.shape == (N, 8, 2) and al_t.shape == (N, 8)
    np.testing.assert_array_equal(al_t, al_j)
    assert al_j.sum(axis=1).min() >= 1 and al_j.sum(axis=1).max() >= 3
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=1e-5)
    # tests/test_torch_wta_cluster.py's bar: sigma^2 within 1e-5 m^2 (the
    # JAX one-pass variance is that far from float64 near the origin).
    np.testing.assert_allclose((std_t / 2.0) ** 2, (std_j / 2.0) ** 2,
                               rtol=0, atol=1e-5)


def _np(sol):
    return {f: np.asarray(getattr(sol, f)) for f in sol._fields}


@pytest.fixture(scope="module")
def problems():
    Z, U0 = _problem_batch(32)
    return np.array(Z)[::4], np.array(U0)[::4]


def test_staged_solve_float64_lockstep_matches_jax(problems):
    Z, U0 = problems
    scfg = jcfg.SolverConfiguration(fused=False, linear_solver="cholesky",
                                    **SHORT)
    with jax.enable_x64(True):
        jsol = _np(jax_build(
            jcfg.MpcConfiguration(), JROBOT,
            dataclasses.replace(scfg, dtype=jnp.float64)).solve_batch(
            jnp.asarray(Z, jnp.float64), jnp.asarray(U0, jnp.float64)))
    tscfg = dataclasses.replace(
        config_from_dict(tcfg.SolverConfiguration, dataclasses.asdict(scfg)),
        dtype=torch.float64)
    tsol = _np(tengine.build_mpc_solver(CFG, ROBOT, tscfg, device="cpu")
               .solve_batch(Z, U0))
    du = np.abs(tsol["u"] - jsol["u"]).max()
    print(f"staged float64: exit_ok JAX {jsol['exit_ok']}, port "
          f"{tsol['exit_ok']}; max |du| {du:.2e}")
    assert 0 < jsol["exit_ok"].sum() < len(Z) or jsol["exit_ok"].all()
    np.testing.assert_array_equal(tsol["exit_ok"], jsol["exit_ok"])
    assert du <= 1e-8
    np.testing.assert_allclose(tsol["cost"], jsol["cost"], rtol=1e-8)
    np.testing.assert_allclose(tsol["residual"], jsol["residual"],
                               rtol=1e-6, atol=1e-9)


def test_staged_solve_float32_by_outcome_and_no_masking_leak(problems):
    """float32 staged solves land where JAX's do on at least 3/4 of the
    lanes; and a lane that meets the constraint tolerance in its first
    stage keeps its iterate while the others go on (per-lane masks)."""
    Z, U0 = problems
    scfg = jcfg.SolverConfiguration(fused=False, linear_solver="cholesky",
                                    **FLOAT32_BUDGET)
    jsol = _np(jax_build(jcfg.MpcConfiguration(), JROBOT, scfg).solve_batch(
        jnp.asarray(Z), jnp.asarray(U0)))
    port = tengine.build_mpc_solver(
        CFG, ROBOT, config_from_dict(tcfg.SolverConfiguration,
                                     dataclasses.asdict(scfg)), device="cpu")
    spd.spd_solve.launches = 0
    tsol = _np(port.solve_batch(Z, U0))
    assert spd.spd_solve.launches == 0      # a CPU tensor takes the plain path
    du = np.abs(tsol["u"] - jsol["u"]).max(axis=1)
    agree = (du <= 1e-3) & (tsol["exit_ok"] == jsol["exit_ok"])
    print(f"staged float32: lanes agreeing {agree.tolist()}, du {du}")
    assert agree.mean() >= 0.75
    assert 0 < jsol["exit_ok"].sum() < len(Z)
    # A lane solved alone gives what it gives inside the batch, whether it
    # converges or not: no lane is frozen by another's progress.
    for lane in (int(np.argmin(jsol["exit_ok"])), int(np.argmax(
            jsol["exit_ok"]))):
        one = _np(port.solve_batch(Z[lane:lane + 1], U0[lane:lane + 1]))
        np.testing.assert_allclose(one["u"][0], tsol["u"][lane], rtol=0,
                                   atol=1e-5, err_msg=f"lane {lane}")
