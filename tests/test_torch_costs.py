"""The port's objective, rollout and block Hessian against the JAX package.

Problems are made by numpy from a seed so that every cost term is active:
static polygons, current and predicted fleet robots, current and predicted
ellipses all sit on the rolled-out path.  The same flat parameter vector and
decision vector go through `dyobav_tpu.ops.costs` and
`dyobav_tpu_torch.ops.costs`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import grad

from dyobav_tpu import configs as jcfg
from dyobav_tpu.motion.models import unicycle_step_np
from dyobav_tpu.ops import costs as jcosts
from dyobav_tpu.ops import params as jparams
from dyobav_tpu.ops.newton import make_structured_hessian as jhessian
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.motion import models as tmodels
from dyobav_tpu_torch.ops import costs as tcosts
from dyobav_tpu_torch.ops import params as tparams
from dyobav_tpu_torch.ops.newton import make_structured_hessian as thessian

# One intra-op thread: the solver's operators are tiny at these sizes, and
# the suite's parallel workers would otherwise oversubscribe the cores.
torch.set_num_threads(1)

JCFG, JROBOT = jcfg.MpcConfiguration(), jcfg.CircularRobotSpecification()
CFG, ROBOT = tcfg.MpcConfiguration(), tcfg.CircularRobotSpecification()
N, NS, NU = CFG.N_hor, CFG.ns, CFG.nu


def _busy_problem(seed: int):
    """(z, u): a problem whose every cost and constraint term is active
    along the rollout of u."""
    rng = np.random.default_rng(seed)
    u = np.stack([rng.uniform(0.5, 1.4, N), rng.uniform(-0.4, 0.4, N)], 1)
    s0 = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                   rng.uniform(-0.3, 0.3)])
    states = [s0]
    for k in range(N):
        states.append(unicycle_step_np(states[-1], u[k], CFG.ts))
    X = np.array(states[1:])                                   # (N, 3)
    ref = X + rng.normal(0, 0.3, X.shape)
    # Static squares (b | a0 | a1, 4 edges) around a few path points.
    stc = np.zeros((CFG.Nstcobs, CFG.nstcobs))
    for i, k in enumerate(rng.choice(N, 4, replace=False)):
        cx, cy = X[k, :2] + rng.normal(0, 0.1, 2)
        h = rng.uniform(0.2, 0.5)
        stc[i] = [cx + h, -(cx - h), cy + h, -(cy - h),
                  1, -1, 0, 0, 0, 0, 1, -1]
    others0 = np.zeros((CFG.Nother, NS))
    others0[:4, :2] = X[rng.choice(N, 4), :2] + rng.normal(0, 0.2, (4, 2))
    others_pred = np.zeros((CFG.Nother, N, NS))
    others_pred[:3, :, :2] = X[None, :, :2] + rng.normal(0, 0.3, (3, N, 2))
    dyn = np.zeros((CFG.Ndynobs, N + 1, CFG.ndynobs))
    for i in range(4):
        k = rng.integers(N)
        dyn[i, :, :2] = X[k, :2] + rng.normal(0, 0.3, 2)
        dyn[i, 1:, :2] += rng.normal(0, 0.1, (N, 2)) + (X[:, :2] - X[k, :2]) \
            * (i % 2)
        dyn[i, :, 2:4] = rng.uniform(0.2, 0.6, 2)
        dyn[i, :, 4] = rng.uniform(-np.pi, np.pi)
        dyn[i, :, 5] = 1.0
    fields = dict(
        u_prev=u[0] + rng.normal(0, 0.2, 2), s0=s0, sN=ref[-1],
        q=jparams.tuning_vector(JCFG) + rng.uniform(0, 5, CFG.nq),
        ref_states=ref, ref_speed=rng.uniform(0.8, 1.4, N),
        others0=others0, others_pred=others_pred, stc_obs=stc, dyn_obs=dyn,
        q_stc=rng.uniform(5, 15, N), q_dyn=rng.uniform(5, 15, N))
    p = jparams.MpcParams(**{k: jnp.asarray(v, jnp.float32)
                             for k, v in fields.items()})
    return (np.asarray(jparams.pack(p)), u.reshape(-1).astype(np.float32))


def _both(z):
    return (jparams.unpack(jnp.asarray(z), JCFG),
            tparams.unpack(torch.from_numpy(z.copy()), CFG))


def test_rollout_states_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        s0 = rng.normal(0, 2, NS).astype(np.float32)
        u = np.stack([rng.uniform(-0.5, 1.5, N),
                      rng.uniform(-0.5, 0.5, N)], 1).astype(np.float32)
        a = np.asarray(jcosts.rollout_states(jnp.asarray(s0), jnp.asarray(u),
                                             CFG.ts))
        b = tcosts.rollout_states(torch.from_numpy(s0), torch.from_numpy(u),
                                  CFG.ts).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        # The numpy twin agrees with the torch step in float64.
        s = torch.from_numpy(s0).double()
        np.testing.assert_allclose(
            tmodels.unicycle_step(s, torch.from_numpy(u[0]).double(),
                                  CFG.ts).numpy(),
            tmodels.unicycle_step_np(s0.astype(np.float64),
                                     u[0].astype(np.float64), CFG.ts),
            rtol=1e-12, atol=1e-12)


_jax_evaluate = jax.jit(lambda u, p: jcosts.evaluate(u, p, JCFG, JROBOT))


def test_evaluate_matches_jax_with_every_term_active():
    for seed in range(4):
        z, u = _busy_problem(seed)
        pj, pt = _both(z)
        a = _jax_evaluate(jnp.asarray(u), pj)
        b = tcosts.evaluate(torch.from_numpy(u), pt, CFG, ROBOT)
        # Every term is active: polygons, fleet and ellipses all violate.
        assert float(jnp.min(a.f2)) > 0 or float(jnp.max(a.f2)) > 0
        xy = a.states[:, :2]
        assert float(jnp.sum(jcosts._polygon_residuals(
            xy, pj.stc_obs, CFG.nstcobs // 3))) > 0, seed
        for name in ("objective", "f1", "f2", "states"):
            x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            scale = max(float(np.abs(x).max()), 1e-12)
            # f32 rounding of sums taken in another order: rel 1e-5.
            assert np.abs(x - y).max() <= 1e-5 * scale, (seed, name)


def _merit_jax(pj, c_lo, c_hi):
    def merit(u, y, c):
        br = jcosts.evaluate(u, pj, JCFG, JROBOT)
        sh = br.f1 + y / c
        alm = sh - jnp.clip(sh, c_lo, c_hi)
        return br.objective + 0.5 * c * (jnp.sum(alm * alm)
                                         + jnp.sum(br.f2 * br.f2))
    return merit


# The JAX sides, compiled once with the params as an argument (eager JAX
# re-traces every transform on each call).
@jax.jit
def _jax_merit_grad(u, y, c, pj):
    lo, hi = jcosts.acceleration_bounds(JCFG, JROBOT)
    return jax.grad(_merit_jax(pj, lo, hi))(u, y, c)


@jax.jit
def _jax_blocks(X, u, y, c, pj):
    return jcosts.split_objective(pj, JCFG, JROBOT)[4](X, u, y, c)


@jax.jit
def _jax_hessian(u, y, c, pj):
    lo, hi = jcosts.acceleration_bounds(JCFG, JROBOT)
    return jhessian(jcosts.split_objective(pj, JCFG, JROBOT),
                    lambda x: jnp.clip(x, lo, hi), "block")(u, y, c)


def _merit_torch(pt, c_lo, c_hi):
    def merit(u, y, c):
        br = tcosts.evaluate(u, pt, CFG, ROBOT)
        sh = br.f1 + y / c
        alm = sh - tcosts._clip(sh, c_lo, c_hi)
        return br.objective + 0.5 * c * (torch.sum(alm * alm)
                                         + torch.sum(br.f2 * br.f2))
    return merit


def test_merit_gradient_tie_breaks_match_jax():
    """On the straight warm start every state sits on the reference line,
    so the min-over-segments term and the hinges sit at ties; JAX splits a
    tied gradient evenly and so must the port."""
    from test_escalation import _problem_batch

    Z, U0 = _problem_batch(4)
    tlo, thi = tcosts.acceleration_bounds(CFG, ROBOT)
    y = np.zeros(2 * N, np.float32)
    for i in range(4):
        pj, pt = _both(np.asarray(Z[i]))
        u = np.asarray(U0[i])
        for c in (10.0, 1250.0):
            gj = np.asarray(_jax_merit_grad(jnp.asarray(u), jnp.asarray(y),
                                            jnp.float32(c), pj))
            gt = grad(_merit_torch(pt, tlo, thi))(
                torch.from_numpy(u.copy()), torch.from_numpy(y),
                torch.tensor(c)).numpy()
            scale = max(np.abs(gj).max(), 1.0)
            np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5 * scale)


def test_block_curvature_and_hessian_match_jax():
    rng = np.random.default_rng(7)
    tlo, thi = tcosts.acceleration_bounds(CFG, ROBOT)
    t_hess = thessian(lambda p: tcosts.split_objective(p, CFG, ROBOT),
                      lambda x: tcosts._clip(x, tlo, thi), "block")
    for seed in range(2):
        z, u = _busy_problem(seed)
        pj, pt = _both(z)
        u = u + rng.normal(0, 0.05, u.shape).astype(np.float32)
        y = rng.normal(0, 1.0, 2 * N).astype(np.float32)
        X = jcosts.rollout_states(pj.s0, jnp.asarray(u).reshape(N, NU),
                                  CFG.ts)
        for c in (10.0, 1250.0):
            C7j, gFj = _jax_blocks(X, jnp.asarray(u), jnp.asarray(y),
                                   jnp.float32(c), pj)
            C7t, gFt = tcosts.make_block_curvature(pt, CFG, ROBOT)(
                torch.from_numpy(np.array(X)), torch.from_numpy(u),
                torch.from_numpy(y), torch.tensor(c))
            for a, b in ((C7j, C7t), (gFj, gFt)):
                a = np.asarray(a)
                scale = max(np.abs(a).max(), 1.0)
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                           atol=1e-5 * scale)
            Hj = np.asarray(_jax_hessian(jnp.asarray(u), jnp.asarray(y),
                                         jnp.float32(c), pj))
            Ht = t_hess(torch.from_numpy(u), torch.from_numpy(y),
                        torch.tensor(c), pt).numpy()
            # The same exact Hessian up to f32 accumulation order; penalty
            # curvature reaches ~1e6, so the tolerance is scale-aware (as
            # tests/test_hessian.py holds the JAX modes to each other).
            scale = max(np.abs(Hj).max(), 1.0)
            np.testing.assert_allclose(Ht, Hj, rtol=5e-4, atol=5e-5 * scale,
                                       err_msg=f"seed={seed} c={c}")
