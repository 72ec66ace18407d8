"""The port's neural predictor where it needs no JAX: its device defaults,
its slot limit, and the card against the port's own CPU run.

This file imports no JAX, so that its `cuda`-marked test runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_wta_card.py -m cuda -q
"""
import os

import numpy as np
import pytest
import torch

from dyobav_tpu_torch.configs import MpcConfiguration
from dyobav_tpu_torch.models.wta_net import load_checkpoint
from dyobav_tpu_torch.ops.cluster import cluster_gaussian_fit
from dyobav_tpu_torch.predictors.mmp import MmpInterface, ObstacleSnapper
from dyobav_tpu_torch.sim import batch as tb
from dyobav_tpu_torch.sim.harness import MainBase

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")
pytestmark = pytest.mark.skipif(
    not (os.path.exists(PT) and os.path.exists(os.path.join(
        REPO, "data", "warehouse_sim_original", "label.png"))),
    reason="trained checkpoint or map data absent")


def _hist():
    """(2, 5, 1, 2) world-frame pedestrian histories."""
    up = [[1.0, 9.3 - 0.3 * (4 - i)] for i in range(5)]
    turn = [[-4.0 + 0.25 * i, -6.0 + 0.1 * i * i] for i in range(5)]
    return np.array([up, turn], np.float32)[:, :, None, :]


def test_predictor_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(PT)
    with pytest.raises(RuntimeError, match="CUDA"):
        MmpInterface()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(os.path.join(REPO, "Model", "absent.pt"), "cpu")


def test_prediction_slots_beyond_ndynobs_raise():
    """H x max_clusters prediction slots must fit the solver's Ndynobs."""
    cfg = MpcConfiguration()
    N, H, K = cfg.N_hor, 2, 8                            # 16 > 15 slots
    pred = (torch.zeros(1, N, H * K, 2), torch.ones(1, N, H * K, 2),
            torch.ones(1, N, H * K))
    with pytest.raises(ValueError, match="Ndynobs"):
        tb.assemble_dyn_obstacles(torch.zeros(1, H, 2), pred, cfg.Ndynobs,
                                  cfg.ndynobs, N, torch.float32)
    dyn = tb.assemble_dyn_obstacles(
        torch.zeros(1, 1, 2), tuple(x[:, :, :K] for x in pred),
        cfg.Ndynobs, cfg.ndynobs, N, torch.float32)
    assert dyn.shape == (1, cfg.Ndynobs, N + 1, cfg.ndynobs)
    assert bool((dyn[0, K:, 1:, 5] == 1.0).all())        # inactive slots


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wta_predictor_card_matches_cpu(cuda_device):
    """make_wta_predictor on the card against the port's CPU run: the net in
    full float32 on both, so hypotheses agree far inside the clusters' 1 m
    eps and the slots match."""
    base = MainBase(seed=0)
    tables = ObstacleSnapper(255.0 - base.ref_map).tables()
    out = {}
    for dev in ("cpu", cuda_device):
        pred = tb.make_wta_predictor(
            load_checkpoint(PT, dev), base.ref_map, base.ct2real, 20,
            snap_tables=tables, device=dev)
        out[str(dev)] = [x.cpu().numpy()
                         for x in pred(torch.from_numpy(_hist()).to(dev))]
    (mu_c, std_c, a_c), (mu_g, std_g, a_g) = out["cpu"], out["cuda"]
    assert a_c[:, 0].sum() >= 2
    np.testing.assert_array_equal(a_g, a_c)
    np.testing.assert_allclose(mu_g, mu_c, rtol=0, atol=1e-3)
    np.testing.assert_allclose(std_g, std_c, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_cgf_on_card_ignores_callers_tf32(cuda_device):
    """The CGF at map coordinates with the caller's cuBLAS TF32 on gives the
    port's CPU answer (its mean is a masked sum, not a matrix product)."""
    rng = np.random.default_rng(0)
    centers = rng.uniform([-15.0, -15.0], [18.0, 14.3], (64, 3, 2))
    pts = (centers[np.arange(64)[:, None], rng.integers(0, 3, (64, 20))]
           + rng.normal(0, 0.3, (64, 20, 2))).astype(np.float32)
    ref = cluster_gaussian_fit(torch.from_numpy(pts))
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        out = cluster_gaussian_fit(torch.from_numpy(pts).to(cuda_device))
    finally:
        matmul.allow_tf32 = saved
    mu, std, alpha = (x.cpu() for x in out)
    assert float(ref[2].sum()) >= 64
    torch.testing.assert_close(alpha, ref[2], rtol=0, atol=0)
    torch.testing.assert_close(mu, ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close((std / 2) ** 2, (ref[1] / 2) ** 2, rtol=0,
                               atol=1e-5)
