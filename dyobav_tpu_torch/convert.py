"""Carry the NMPC and simulation state across from the JAX package.

The batched solve and simulation have no learned weights: what crosses is
the structured parameter set, the configurations, the warm start and the
scenario tensors, each as plain numpy data or plain dicts, so this module
needs neither JAX nor the JAX package.

    params_from_numpy(p_jax_as_numpy, device)  -> ops.params.MpcParams
    config_from_dict(SolverConfiguration, d)   -> configs.SolverConfiguration
    scenario_from_numpy(sc_jax_as_numpy, device) -> sim.batch.Scenario
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .ops.params import MpcParams

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16}


def params_from_numpy(p: Any, device=None, dtype=torch.float32) -> MpcParams:
    """MpcParams fields as numpy arrays → the port's MpcParams on `device`.

    `p` is anything with the MpcParams field names, as attributes (the JAX
    package's MpcParams, after `np.asarray` of each field or not) or as a
    mapping.  Leading batch dims carry over.
    """
    get = p.get if isinstance(p, Mapping) else (lambda k: getattr(p, k))
    return MpcParams(*[
        torch.tensor(np.asarray(get(name)), dtype=dtype, device=device)
        for name in MpcParams._fields])


def _torch_dtype(value):
    """A dtype given as a numpy/JAX dtype, a type or a name → torch dtype."""
    if value is None or isinstance(value, torch.dtype):
        return value
    name = np.dtype(value).name
    if name not in _DTYPES:
        raise ValueError(f"no torch dtype for {value!r}")
    return _DTYPES[name]


def config_from_dict(kind: type, d: Mapping[str, Any]):
    """A JAX config dataclass's `to_dict()` (or `dataclasses.asdict`) →
    the port's dataclass `kind`.  Unknown keys are dropped; a `dtype`
    field becomes a torch dtype; list-valued profile fields become tuples
    again (YAML and JSON round trips turn tuples into lists)."""
    names = {f.name for f in dataclasses.fields(kind)}
    kwargs = {k: v for k, v in d.items() if k in names}
    if "dtype" in kwargs:
        kwargs["dtype"] = _torch_dtype(kwargs["dtype"])
    for k in ("cold_profile", "escalation_ladder", "escalation_slots"):
        v = kwargs.get(k)
        if isinstance(v, (list, tuple)):
            kwargs[k] = tuple(tuple(s) if isinstance(s, (list, tuple)) else s
                              for s in v)
    return kind(**kwargs)


def scenario_from_numpy(sc: Any, device=None):
    """A `sim.batch.Scenario` of the JAX package (single or batched), its
    fields as numpy arrays or anything `np.asarray` takes, or a mapping of
    them -> the port's Scenario as tensors on `device` (None: the CPU):
    floating fields float32, integer fields int64."""
    from .sim.batch import Scenario, scenario_to_device

    get = sc.get if isinstance(sc, Mapping) else (lambda k: getattr(sc, k))
    return scenario_to_device(
        Scenario(*[np.asarray(get(name)) for name in Scenario._fields]),
        device or "cpu")
