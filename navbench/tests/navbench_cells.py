"""Cells of the benchmark's tests, those out of BENCHMARK.json included."""
from __future__ import annotations

# The solve and training cells' files stay in navbench/ while the cells are
# out of BENCHMARK.json (their runs spread too widely for a bound; PERF.md
# section 7); the tests build them from those files.
KEPT_OUT = {
    "configs": [{"name": "nmpc_warehouse",
                 "file": "navbench/configs/nmpc_warehouse.json"}],
    "workloads": [{"name": "nmpc.solve.b2048", "config": "nmpc_warehouse",
                   "traffic": "receding_b2048", "chips": 1},
                  {"name": "swta.train.b20", "config": "swta_wsd_1t20",
                   "traffic": "walks_b20", "chips": 1}],
}


def spec(workload: str) -> dict:
    """harness.cell of `workload`, the cells kept out included."""
    from navbench import harness

    man = harness.manifest()
    if workload not in {w["name"] for w in man["workloads"]}:
        man = dict(man, **{k: man[k] + v for k, v in KEPT_OUT.items()})
    return harness.cell(workload, man)
