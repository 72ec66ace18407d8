"""What every cell shares: the manifest, the files a cell is made of, the
result line and the guards around a run.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`); the mix names its driver
(`drivers/<driver>.py`), its generator (`generators/<generator>.py`) and
the cell's limits are `limits/<cell>.json`.  Each per-layer metric is read
by `metrics/<metric>.py`.  A new cell or metric is new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "dyobav_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(workload: str, man: dict | None = None) -> dict:
    """The cell `workload` with its configuration, traffic, limits, and
    its end-to-end and per-layer metric entries."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in man["configs"] if c["name"] == w["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in man["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {
        "workload": w,
        "config": load_json(os.path.join(ROOT, cfg_entry["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          w["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", workload + ".json")),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def load_module(kind: str, name: str):
    """navbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"navbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Whole top-level names in sys.modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def compare(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every reading at or under its
    limit.  A reading that is missing or not a number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = isinstance(v, (int, float)) and v == v and v <= limit
        ok &= good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def peaks() -> dict:
    return load_json(os.path.join(HERE, "peaks.json"))


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where the tests run)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
