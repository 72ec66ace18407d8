"""BENCHMARK.json against the benchmark's contract, and the files it
names."""
from __future__ import annotations

import json
import os
import re

import pytest

from navbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/") for p in man["paths"])
    assert len(man["command"]) <= 32
    assert all(1 <= len(w) <= 200 and not w.startswith("/")
               for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51
    n = 24     # later PRs may add cells up to 24 under the same length
    assert (2 + 14 * n) * (man["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_names_and_units(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in man[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)


def test_configs(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert os.path.isfile(os.path.join(harness.ROOT, cfg["reference"]))
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))


def test_end_to_end(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for w in cells:
        mine = [m for m in e2e.values() if w in m.get("workloads", [w])]
        assert len(mine) >= 2          # setup_s and one more


def test_per_layer_moves_reported(man):
    """Every per-layer metric's `moves` is reported by each cell that
    reports the metric, and every cell reports one per-layer metric."""
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m["workloads"] for m in man["per_layer"])


def test_cell_files(man):
    """Each cell's traffic, driver, generator and limits, and each metric's
    reader, sit in files of their own, found by name."""
    for w in man["workloads"]:
        spec = harness.cell(w["name"], man)
        t = spec["traffic"]
        for kind, name in (("drivers", t["driver"]),
                           ("generators", t["generator"])):
            assert os.path.isfile(os.path.join(harness.HERE, kind,
                                               name + ".py"))
        assert spec["limits"]["limits"]
        assert spec["end_to_end"] and spec["per_layer"]
    for m in man["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert harness.load_module("metrics", m["name"]).read({}) is None


def test_compare():
    ok, out = harness.compare({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0})
    assert ok and out["a"] == {"value": 1.0, "limit": 1.0}
    assert not harness.compare({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.compare({}, {"a": 1.0})[0]
    assert not harness.compare({"a": 2.0}, {"a": 1.0})[0]
    json.dumps(out)
