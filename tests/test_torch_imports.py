"""The port stands alone: no JAX, nothing of `dyobav_tpu`, and its entry
points run on a CUDA device unless the caller asks for the CPU."""
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "profile_torch_solve.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dyobav_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) >= 10
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "dyobav_tpu")]
    assert not bad, bad


def test_build_mpc_solver_defaults_to_cuda():
    from dyobav_tpu_torch.ops import engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.build_mpc_solver(engine.MpcConfiguration(),
                                engine.CircularRobotSpecification())
    assert engine.resolve_device("cpu") == torch.device("cpu")
