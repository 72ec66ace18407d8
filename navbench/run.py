#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on a CUDA card.

    python3 navbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's driver builds the program under
test from the cell's configuration and traffic (set-up, timed as
`setup_s`), then either measures for `--seconds` (`--trace 0`: the cell's
end-to-end metrics) or traces its calls (`--trace 1`: the per-layer
metrics, `busy_s`, `window_s` and `breakdown`).  After that the program's
state is freed and the plain reference judges the outputs; each number
compared is printed beside its limit on standard error and under
"compared", the last key of the result.  The last line of standard output
is the result as one JSON object.  Without a CUDA card, with fewer cards
than the cell asks for, or when JAX or the JAX package is loaded, the run
exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# Every cache of the program and its libraries at a fixed path inside the
# checkout, so that only a checkout's first run builds.
CACHE = os.path.join(ROOT, ".navbench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
os.environ.setdefault("USE_FLAX", "0")
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "4")


def power_limit_w():
    """The card's power limit (W), as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from navbench import harness

    spec = harness.cell(args.workload)
    chips = spec["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"navbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    driver = harness.load_module("drivers", spec["traffic"]["driver"])
    run = driver.Cell(spec["config"], spec["traffic"], args.seed, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    if args.trace:
        res = run.traced()
    else:
        res = run.window(args.seconds)
    torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"navbench: the run loaded {bad}", file=sys.stderr)
        return 3

    run.release()
    readings = run.judge()
    correct, compared = harness.compare(readings,
                                        spec["limits"]["limits"])

    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            v = harness.load_module("metrics", m["name"]).read(
                res["observations"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": int(memory_peak),
                   "power_limit_w": power_limit_w()}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"])}
    out["metrics"] = metrics
    out["device"] = device_info
    if args.trace:
        device_info["busy_s"] = res["busy_s"]
        device_info["window_s"] = res["window_s"]
        out["breakdown"] = res["breakdown"]
    out["setup_s"] = setup_s
    out["compared"] = compared
    for name, v in readings.items():
        if name not in compared:
            print(f"reading {name}: {v!r}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"navbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
