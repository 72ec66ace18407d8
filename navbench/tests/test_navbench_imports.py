"""No module that the benchmark runs imports JAX or the JAX package, by
whole top-level name (`dyobav_tpu_torch` begins with `dyobav_tpu`), and
the references import nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from navbench import harness


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x != "tests"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in sources():
        bad = set(imported(path)) & {"jax", "jaxlib", "flax", "dyobav_tpu"}
        assert not bad, (path, bad)


def test_references_import_no_program():
    for path in sources("reference"):
        assert "dyobav_tpu_torch" not in set(imported(path)), path


def strings(path):
    """String constants of a module, docstrings left out."""
    tree = ast.parse(open(path).read(), path)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_old_benchmark_read():
    """No string of the benchmark's code names the JAX package's benchmark
    or its records."""
    for path in sources():
        for text in strings(path):
            assert not any(k in text for k in (
                "bench.py", "BENCH_", "MULTICHIP_", "BASELINE")), path


def test_run_without_card_prints_nothing():
    """Without CUDA the run fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "swta.predict.s64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
