"""Device lists and batch sharding (the port's communication layer), the
counterpart of `dyobav_tpu.parallel.mesh`.

Scenario batches split across devices along their leading (batch) axis;
each device runs its own shard, and the statistics reduce afterwards:
on one host by concatenating the shards' results, across processes with
`torch.distributed` collectives.

A mesh is an explicit, ordered list of `torch.device`s.  A caller may
repeat a device (`make_mesh(devices=["cpu"] * 4)`): each entry is a shard
of its own, which is how the CPU tests stand in for the JAX package's
virtual devices and how two shards share one card.

The JAX module's `batch_sharding` / `replicated_sharding` return
`NamedSharding` objects, for which torch has no counterpart: here
`shard_batch` returns each device's rows and `replicate` each device's copy
directly.  `shard_map_batch` keeps what the JAX function promises: every
shard runs the whole function on its own rows, so a solver's cold and
escalation slots follow the shard's local batch, and no shard waits on
another's lanes.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: {d} asked for and no CUDA device "
                           f"is available")
    if d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if d.index >= torch.cuda.device_count():
        raise ValueError(f"make_mesh: {d} asked for, "
                         f"{torch.cuda.device_count()} CUDA devices "
                         f"available")
    return d


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """1-D data-parallel mesh: the first `n_devices` of `devices`, which
    defaults to every visible CUDA device and raises without one.  Unlike
    the JAX function, asking for more devices than there are raises
    (ValueError), as does a CUDA device that is not there."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices="
                "['cpu'] * n for CPU shards")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: an empty device list")
    return devices


def _map(fn, tree):
    """`fn` over the leaves of a tree of tuples (named tuples included),
    lists and dicts; every other object is a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _rows(tree, n_shards: int, first: int, count: int, mesh: list) -> list:
    """Shards first .. first + count - 1 of `n_shards` equal chunks of every
    leaf's leading axis, shard first + i on mesh[i]."""
    def chunk(i):
        def put(x):
            x = _tensor(x)
            B = x.shape[0]
            if B % n_shards:
                raise ValueError(f"a batch of {B} rows does not split into "
                                 f"{n_shards} shards (pad_to_multiple)")
            step = B // n_shards
            return x[(first + i) * step:(first + i + 1) * step].to(mesh[i])
        return _map(put, tree)

    return [chunk(i) for i in range(count)]


def shard_batch(mesh: list, tree) -> list:
    """The batch split along its leading axis: entry i is the tree of
    device i's rows, [i B/N, (i+1) B/N), on mesh[i] (JAX's `P("data")`).
    Leaves are tensors or numpy arrays; B must be a multiple of N."""
    return _rows(tree, len(mesh), 0, len(mesh), mesh)


def replicate(mesh: list, tree) -> list:
    """One copy of the tree on each device of the mesh."""
    return [_map(lambda x: _tensor(x).to(d), tree) for d in mesh]


def _concat(outs: list, device: torch.device):
    first = outs[0]
    if torch.is_tensor(first):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_concat(list(x), device) for x in zip(*outs)])
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(x), device) for x in zip(*outs))
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    raise TypeError(f"shard_map_batch: an output leaf of type "
                    f"{type(first).__name__} is not a tensor")


def shard_map_batch(fn, mesh: list):
    """Wrap a batched function so each device runs it on its own shard.

    The returned function takes, for every argument of `fn`, the list that
    `shard_batch` (or `make_global_batch`) gives, calls `fn` on shard i on
    mesh[i] (a CUDA shard under `torch.cuda.device(d)`) and concatenates
    the shards' outputs, trees of leading-axis-batched tensors, on mesh[0].
    As in the JAX function, the whole decision rule stays local: a
    solver's slot counts follow the shard's batch.

    The shards run one after another in the calling thread.  The solver
    differentiates with `torch.func.jvp` / `jacfwd`, whose forward-mode AD
    levels are global to the process and must be left in the order they
    were entered, so two threads solving at once fail ("Trying to access a
    forward AD level with an invalid index").  Devices work in parallel
    across processes instead: one process a device under
    `init_distributed` (`sim.sweep --distributed`)."""
    mesh = list(mesh)

    def one(args, device):
        if device.type == "cuda":
            with torch.cuda.device(device):
                return fn(*args)
        return fn(*args)

    def run(*shards):
        for s in shards:
            if len(s) != len(mesh):
                raise ValueError(f"shard_map_batch: {len(s)} shards for a "
                                 f"mesh of {len(mesh)} devices")
        outs = [one([s[i] for s in shards], d) for i, d in enumerate(mesh)]
        return outs[0] if len(mesh) == 1 else _concat(outs, mesh[0])

    return run


def init_distributed(device=None) -> bool:
    """Multi-process entry: join the `torch.distributed` process group that
    a launcher (`torchrun`, or any that sets RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT and LOCAL_RANK) describes, one process per device: NCCL
    for a CUDA `device` (the default when a card is visible), Gloo for the
    CPU.  Without that environment it prints the JAX function's
    single-host fallback line to stderr and returns False, so the same
    entry point runs everywhere."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        print(f"init_distributed: single-host fallback (no "
              f"{', '.join(missing)} in the environment)", file=sys.stderr)
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def make_global_batch(mesh: list, tree) -> list:
    """This process's rows of the global batch that every process builds
    identically (same seed): with W processes of len(mesh) devices each,
    the batch splits into W * len(mesh) shards, and process r owns shards
    r * len(mesh) .. (r + 1) * len(mesh) - 1, entry i on mesh[i].  On one
    process (no process group) this is `shard_batch`."""
    import torch.distributed as dist

    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    n = len(mesh)
    return _rows(tree, world * n, rank * n, n, mesh)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad the leading axis to a multiple (returns padded array + true n)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
