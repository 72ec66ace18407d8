"""The port stands alone: no JAX, nothing of `dyobav_tpu`, and its entry
points run on a CUDA device unless the caller asks for the CPU."""
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    scripts = os.path.join(REPO, "scripts")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(scripts, n) for n in os.listdir(scripts)
        if (n.startswith("profile_torch_") and n.endswith(".py"))
        or n == "deploy_latency_torch.py"]
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
    assert len(files) >= 25
    # The scan covers the per-episode harness, its entry, the baselines,
    # the deployment node with its script, the fleet and the training
    # stack.
    rel = {os.path.relpath(p, REPO) for p in files}
    assert {f"dyobav_tpu_torch/{m}.py" for m in (
        "trackers/mpc_tracker", "interfaces/mpc_interface", "motion/agents",
        "motion/models", "predictors/cvmp", "sim/metrics", "sim/harness",
        "sim/entry", "sim/__main__", "ops/panoc", "ops/dwa",
        "trackers/dwa_tracker", "interfaces/dwa_interface", "motion/kalman",
        "predictors/kfmp", "maps/preset", "sim/deploy", "sim/ros_adapter",
        "sim/plotter", "sim/fleet", "models/losses", "models/mdn",
        "models/data", "models/manager", "models/train",
        "utils/density")} <= rel
    assert "scripts/deploy_latency_torch.py" in rel
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "dyobav_tpu", "PIL")]
    assert not bad, bad


def _module_level_imports(path):
    """Imports that run when the module is imported: every import statement
    outside a function body (class bodies and `if`/`try` blocks run too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def test_port_needs_no_plotting_or_graph_library_to_import():
    """The machine with the card has numpy, scipy and einops, but no
    networkx, PIL, pandas or matplotlib (nor ROS): no module of the port
    may import one of them when it is imported."""
    bad = [(os.path.relpath(p, REPO), m) for p in _port_sources()
           for m in _module_level_imports(p)
           if m.split(".")[0] in ("networkx", "PIL", "pandas", "matplotlib",
                                  "rospy", "geometry_msgs", "nav_msgs",
                                  "std_msgs")]
    assert not bad, bad
    # The scan sees what it should: the JAX package's graph module does
    # import networkx at module level.
    jax_graph = os.path.join(REPO, "dyobav_tpu", "maps", "graph.py")
    assert "networkx" in set(_module_level_imports(jax_graph))


def test_build_mpc_solver_defaults_to_cuda():
    from dyobav_tpu_torch.ops import engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.build_mpc_solver(engine.MpcConfiguration(),
                                engine.CircularRobotSpecification())
    assert engine.resolve_device("cpu") == torch.device("cpu")
