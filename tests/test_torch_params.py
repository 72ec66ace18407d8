"""The port's parameter layout and configurations against the JAX package.

`dyobav_tpu_torch.ops.params` must keep the flat parameter vector
byte-compatible with `dyobav_tpu.ops.params` (the reference solver's
layout), and `dyobav_tpu_torch.configs` / `convert` must carry the JAX
package's configurations over field for field.  Inputs are made by numpy
from a seed and handed to both packages.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.ops import params as jparams
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.convert import config_from_dict, params_from_numpy
from dyobav_tpu_torch.ops import params as tparams

CFG = tcfg.MpcConfiguration()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_z(n_lead=(), seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n_lead + (CFG.n_params,)).astype(np.float32)


def test_unpack_matches_jax_layout():
    z = _random_z()
    pj = jparams.unpack(jnp.asarray(z), jcfg.MpcConfiguration())
    pt = tparams.unpack(torch.from_numpy(z), CFG)
    assert pt._fields == pj._fields
    for name in pt._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_pack_unpack_round_trip_and_batch_dims():
    z = _random_z((4, 3), seed=1)
    p = tparams.unpack(torch.from_numpy(z), CFG)
    assert p.dyn_obs.shape == (4, 3, CFG.Ndynobs, CFG.N_hor + 1, CFG.ndynobs)
    np.testing.assert_array_equal(tparams.pack(p).numpy(), z)
    # Each lane of a batched unpack is the unbatched unpack of that lane,
    # and the JAX pack of the same fields gives the same bytes.
    lane = tparams.unpack(torch.from_numpy(z[2, 1]), CFG)
    for name in p._fields:
        np.testing.assert_array_equal(getattr(p, name)[2, 1].numpy(),
                                      getattr(lane, name).numpy())
    pj = jparams.MpcParams(*[jnp.asarray(f.numpy()) for f in lane])
    np.testing.assert_array_equal(np.asarray(jparams.pack(pj)), z[2, 1])
    with pytest.raises(ValueError, match="elements"):
        tparams.unpack(torch.zeros(CFG.n_params - 1), CFG)


def test_empty_params_and_tuning_vector_match_jax():
    ej = jparams.empty_params(jcfg.MpcConfiguration())
    et = tparams.empty_params(CFG)
    for name in et._fields:
        a, b = np.asarray(getattr(ej, name)), getattr(et, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert not b.any(), name
    cfg = tcfg.MpcConfiguration(qrpd=7.0, qvel=3.0, lin_acc_penalty=2.0)
    np.testing.assert_array_equal(
        tparams.tuning_vector(cfg),
        jparams.tuning_vector(jcfg.MpcConfiguration(
            qrpd=7.0, qvel=3.0, lin_acc_penalty=2.0)))
    assert cfg.n_params == jcfg.MpcConfiguration().n_params == 2778


def test_params_from_numpy_carries_jax_params():
    z = _random_z(seed=2)
    pj = jparams.unpack(jnp.asarray(z), jcfg.MpcConfiguration())
    pt = params_from_numpy(pj, device="cpu")
    np.testing.assert_array_equal(tparams.pack(pt).numpy(), z)
    as_dict = {k: np.asarray(v) for k, v in pj._asdict().items()}
    np.testing.assert_array_equal(
        tparams.pack(params_from_numpy(as_dict)).numpy(), z)


@pytest.mark.parametrize("name", ["MpcConfiguration",
                                  "CircularRobotSpecification",
                                  "SolverConfiguration"])
def test_config_defaults_and_conversion_match_jax(name):
    jkind, tkind = getattr(jcfg, name), getattr(tcfg, name)
    jfields = {f.name: f.default for f in dataclasses.fields(jkind)}
    tfields = {f.name: f.default for f in dataclasses.fields(tkind)}
    assert list(jfields) == list(tfields)
    jdefault = dataclasses.asdict(jkind())
    assert config_from_dict(tkind, jdefault) == tkind()
    # A non-default configuration crosses unchanged, list-valued profiles
    # (as YAML/JSON give them back) included.
    if name == "SolverConfiguration":
        j = jkind(dtype=jnp.float32, escalation_ladder=((3, 2, 2, 3, 1250.0),
                                                        (6, 10, 5, 2, 10.0)))
        d = dataclasses.asdict(j)
        d["escalation_ladder"] = [list(s) for s in d["escalation_ladder"]]
        t = config_from_dict(tkind, d)
        assert t.dtype is torch.float32
        assert t.escalation_ladder == j.escalation_ladder
        assert t.linear_solver == "pallas"
    else:
        j = jkind(ts=0.1)
        assert config_from_dict(tkind, j.to_dict()) == tkind(ts=0.1)


def test_reference_yamls_load_like_jax():
    for fname, name in [("mpc_default.yaml", "MpcConfiguration"),
                        ("mpc_fast.yaml", "MpcConfiguration"),
                        ("mpc_default.yaml", "CircularRobotSpecification")]:
        path = os.path.join(REPO, "config", fname)
        j = getattr(jcfg, name).from_yaml(path)
        t = getattr(tcfg, name).from_yaml(path)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), fname
