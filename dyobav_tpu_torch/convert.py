"""Carry state and weights across from the JAX package.

What crosses is the structured parameter set, the configurations, the warm
start, the scenario tensors and the SWTA net's Flax variables, each as
plain numpy data or plain dicts, so this module needs neither JAX nor the
JAX package.

    params_from_numpy(p_jax_as_numpy, device)  -> ops.params.MpcParams
    config_from_dict(SolverConfiguration, d)   -> configs.SolverConfiguration
    config_from_dict(DwaConfiguration, d)      -> configs.DwaConfiguration
    scenario_from_numpy(sc_jax_as_numpy, device) -> sim.batch.Scenario
    wta_state_dict_from_flax(variables_as_numpy) -> models.wta_net state_dict
    state_dict_from_flax(variables_as_numpy, net) -> the SWTA / MDN nets'
        state_dict, or their parameters (a gradient tree) alone
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


_HEADS = {
    "wta": (("Dense_0", "fc1"), ("Dense_1", "swarm.layer_hypos")),
    "mdn": (("Dense_0", "fc1"),
            ("ClassicMixtureDensityModule_0/Dense_0", "mdn.layer")),
    "mdnfit": (("Dense_0", "fc1"), ("Dense_1", "layer_hypos"),
               ("SamplingMixtureDensityModule_0/Dense_0", "smdn.layer")),
}


def _module_pairs(params: Mapping, net: str, lite: bool, blocks) -> list:
    """Ordered (flax_path, torch_prefix, kind) for every weighted module of
    the port's net `net` ("wta": `models.wta_net.ConvMultiHypoNet`, "mdn":
    `models.mdn.ConvMixtureDensityNet`, "mdnfit":
    `models.mdn.ConvMultiHypoMixtureDensityFit`), kind 'conv' | 'bn' |
    'dense'.  A block has a shortcut where its Flax parameters hold one."""
    bb = "ResNet34Lite_0" if lite else "ResNet34_0"
    pairs = []
    for i in range(1 if lite else 3):
        pairs += [(f"{bb}/ConvBNLeaky_{i}/Conv_0",
                   f"resnet34.stem.conv{i + 1}.0", "conv"),
                  (f"{bb}/ConvBNLeaky_{i}/BatchNorm_0",
                   f"resnet34.stem.conv{i + 1}.1", "bn")]
    b = 0
    for stage, nb in enumerate(blocks):
        for i in range(nb):
            fx, tp = f"{bb}/BasicBlock_{b}", f"resnet34.layer{stage + 1}.{i}"
            for c in (0, 1):
                pairs += [(f"{fx}/ConvBNLeaky_{c}/Conv_0",
                           f"{tp}.conv{c + 1}.0", "conv"),
                          (f"{fx}/ConvBNLeaky_{c}/BatchNorm_0",
                           f"{tp}.conv{c + 1}.1", "bn")]
            if "Conv_0" in params[bb][f"BasicBlock_{b}"]:
                pairs += [(f"{fx}/Conv_0", f"{tp}.downsample.0", "conv"),
                          (f"{fx}/BatchNorm_0", f"{tp}.downsample.1", "bn")]
            b += 1
    return pairs + [(fx, tp, "dense") for fx, tp in _HEADS[net]]


def _fc1_perm(fc_input: int, n_channels: int) -> np.ndarray:
    """perm[i_flax] = i_torch: Flax flattens the (Hs, Ws, C) feature map,
    torch the (C, Hs, Ws) one."""
    spatial = fc_input // n_channels
    hs = int(round(np.sqrt(spatial)))
    if hs * hs != spatial:
        raise ValueError(f"non-square feature map of {spatial} cells")
    return np.arange(fc_input).reshape(n_channels, hs, hs).transpose(
        1, 2, 0).reshape(-1)


def state_dict_from_flax(variables: Mapping, net: str = "wta",
                         lite: bool = True, blocks=(3, 4, 6, 3)) -> dict:
    """The JAX package's variables `{'params', 'batch_stats'}` (numpy
    leaves, nested dicts) of the net `net` ("wta": `ConvMultiHypoNet`,
    "mdn": `ConvMixtureDensityNet`, "mdnfit":
    `ConvMultiHypoMixtureDensityFit`) -> the port's `state_dict` of the same
    net (CPU tensors).

    Conv kernels HWIO -> OIHW, dense kernels transposed, BatchNorm
    scale / bias / mean / var to weight / bias / running_mean /
    running_var, and fc1's input axis permuted from the NHWC flattening to
    the NCHW one.  `blocks` is the net's blocks per stage.  Without
    'batch_stats' the result holds the parameters only, so the same
    mapping carries a gradient tree (`{'params': grads}`) onto
    `named_parameters()`.
    """
    params = variables["params"]
    stats = variables.get("batch_stats")

    def leaves(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return {k: np.asarray(v, dtype=np.float32) for k, v in tree.items()}

    sd = {}
    last_channels = None
    for fx, tp, kind in _module_pairs(params, net, lite, blocks):
        p = leaves(params, fx)
        if kind == "conv":
            sd[f"{tp}.weight"] = p["kernel"].transpose(3, 2, 0, 1)  # HWIO
            if "bias" in p:
                sd[f"{tp}.bias"] = p["bias"]
            last_channels = p["kernel"].shape[3]
        elif kind == "bn":
            sd[f"{tp}.weight"], sd[f"{tp}.bias"] = p["scale"], p["bias"]
            if stats is not None:
                s = leaves(stats, fx)
                sd[f"{tp}.running_mean"] = s["mean"]
                sd[f"{tp}.running_var"] = s["var"]
                sd[f"{tp}.num_batches_tracked"] = np.asarray(0, np.int64)
        else:
            w = p["kernel"].T                            # (out, in)
            if tp == "fc1":
                w = w[:, np.argsort(_fc1_perm(w.shape[1], last_channels))]
            sd[f"{tp}.weight"], sd[f"{tp}.bias"] = w, p["bias"]
    return {k: torch.tensor(v) for k, v in sd.items()}


def wta_state_dict_from_flax(variables: Mapping, lite: bool = True,
                             blocks=(3, 4, 6, 3)) -> dict:
    """`state_dict_from_flax` of the JAX package's `ConvMultiHypoNet` ->
    the port's `models.wta_net.ConvMultiHypoNet` `state_dict`."""
    return state_dict_from_flax(variables, "wta", lite, blocks)
