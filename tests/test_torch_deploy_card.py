"""The deployment latency script (`scripts/deploy_latency_torch.py`) where
it needs no JAX: one timed tick on the CPU, and on a card its own run.

This file imports no JAX, so that its `cuda`-marked test runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_deploy_card.py -m cuda -q
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REPO, "Model",
                                    "wsd_1t20_full_torch.pt")),
    reason="the SWTA checkpoint is not in the checkout")

KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ms", "p99_ms",
        "mean_ms", "n", "path", "ckpt", "platform", "card"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(argv, capsys):
    import deploy_latency_torch

    assert deploy_latency_torch.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS
    assert out["metric"] == "deploy_tick_latency_p95"
    assert out["ckpt"] == "wsd_1t20_full_torch.pt"
    assert 0 < out["p50_ms"] <= out["value"] <= out["p99_ms"]
    assert np.isclose(out["vs_baseline"], 200.0 / out["value"])
    return out


def test_deploy_latency_script_on_the_cpu(capsys, tmp_path):
    path = tmp_path / "deploy.json"
    out = _run(["--n", "1", "--device", "cpu", "--out", str(path)], capsys)
    assert out["n"] == 1 and out["platform"] == "cpu" and out["card"] is None
    with open(path) as f:
        assert json.load(f) == out


@pytest.mark.cuda
def test_deploy_latency_script_on_the_card(cuda_device, capsys):
    out = _run(["--n", "2"], capsys)
    assert out["n"] == 2 and out["platform"] == "cuda"
    assert out["card"]
