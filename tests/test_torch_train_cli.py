"""`python -m dyobav_tpu_torch.models.train` on the CPU, and the trained
checkpoint through the port's `NetworkManager.load_checkpoint` against the
JAX package's.

The CLI runs on a small synthetic WSD directory (walks on a 64 x 64 map)
with `--device cpu`: the device loop, the host loop, a resumed fine-tuning
run at k_top 1 with the relaxed loss and a subsampled index; each writes
`<out>.pt` and `<out>_profile.json`, and an SWTA `.pt` loads with
`models.wta_net.load_checkpoint` and predicts through
`sim.batch.make_wta_predictor` with no other step.  The MDN nets abort on
pixel labels as the JAX package's do (tests/test_torch_train_mdn.py trains
them on the labels of tests/test_models.py).  Without `--device`, the CLI
needs a CUDA device.
"""
import json
import os

import numpy as np
import pytest
import torch

from dyobav_tpu_torch.configs import WtaNetConfiguration as TCfg
from dyobav_tpu_torch.maps.transforms import ScaleOffsetReverseTransform
from dyobav_tpu_torch.models import data as td
from dyobav_tpu_torch.models import train as ttrain
from dyobav_tpu_torch.models import wta_net as tw
from dyobav_tpu_torch.models.manager import NetworkManager as TManager
from dyobav_tpu_torch.sim.batch import make_wta_predictor
from test_torch_train_loop import write_png

torch.set_num_threads(1)

HW = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = os.path.join(REPO, "Model", "wsd_1t20_full_torch.pt")


@pytest.fixture(scope="module")
def wsd_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    gray = np.full((HW, HW), 255, np.uint8)
    gray[28:36, 8:56] = 0
    write_png(str(root / "label.png"), gray)
    return td.write_synthetic_wsd(str(root / "data"), str(root / "label.png"),
                                  n_videos=2, n_peds=2, n_frames=12, seed=2,
                                  speed=1.5)


@pytest.fixture(scope="module")
def trained(wsd_dir, tmp_path_factory):
    """The device loop's run: 2 epochs (k_top 20 then 1), chunks of 4."""
    out = str(tmp_path_factory.mktemp("out") / "wsd_tiny")
    assert ttrain.main(["--data", wsd_dir, "--out", out, "--epochs", "2",
                        "--batch-size", "4", "--chunk-steps", "4",
                        "--recalibrate-bn", "2", "--device", "cpu"]) == 0
    return out


def _profile(out):
    with open(out + "_profile.json") as f:
        return json.load(f)


def test_device_loop_writes_a_checkpoint_the_predictor_runs(trained):
    prof = _profile(trained)
    assert len(prof["val_loss"]) == 2 and np.isfinite(prof["val_loss"]).all()
    assert len(prof["loss"]) >= 2 and np.isfinite(prof["loss"]).all()
    out_dir = os.path.dirname(trained)
    assert {"model_ckp_0.pt", "model_ckp_1.pt", "wsd_tiny.pt"} <= set(
        os.listdir(out_dir))
    net = tw.load_checkpoint(trained + ".pt", "cpu", TCfg(fc_input=128))
    ref = np.full((HW, HW), 255.0, np.float32)
    transform = ScaleOffsetReverseTransform(
        scale=0.1, offsetx_after=-3.2, offsety_after=-3.2, y_reverse=True,
        y_max_before=HW)
    predict = make_wta_predictor(net, ref, transform, n_hor=3, device="cpu")
    hist = torch.tensor([[[[0.1 * i - 1.0, 0.5]] for i in range(5)]])
    mu, std, alpha = predict(hist)                  # (1, 5, 1, 2) world
    assert mu.shape == std.shape == (1, 3, 8, 2) and alpha.shape == (1, 3, 8)
    assert torch.isfinite(mu).all() and torch.isfinite(std).all()
    np.testing.assert_allclose(alpha.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_host_loop(wsd_dir, tmp_path):
    out = str(tmp_path / "host")
    assert ttrain.main(["--data", wsd_dir, "--out", out, "--epochs", "2",
                        "--batch-size", "4", "--steps-per-epoch", "3",
                        "--val-every", "2", "--recalibrate-bn", "0",
                        "--device", "cpu"]) == 0
    prof = _profile(out)
    assert len(prof["loss"]) == 6 and np.isfinite(prof["loss"]).all()
    # one validation at step 2 of each epoch and one at its end
    assert len(prof["val_loss"]) == 4
    sd = torch.load(out + ".pt", map_location="cpu", weights_only=True)
    tw.ConvMultiHypoNet(fc_input=128).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("net", ["mdn", "mdnfit"])
def test_mdn_nets_on_pixel_labels_abort_as_in_jax(wsd_dir, tmp_path, net,
                                                  capsys):
    """The mixture NLL (no log-sum-exp, as the reference writes it) of a
    fresh MDN net is +inf on labels tens of pixels from every component:
    exp(-(d / sigma)^2 / 2) underflows.  The next step's loss is NaN and
    the run aborts, writing no checkpoint, in both packages: the JAX
    package's loss gives +inf on the port's first outputs too."""
    import jax.numpy as jnp

    from dyobav_tpu.models import losses as jl
    from dyobav_tpu_torch.models import losses as tl
    from dyobav_tpu_torch.models import mdn as tm

    out = str(tmp_path / net)
    assert ttrain.main(["--data", wsd_dir, "--out", out, "--epochs", "1",
                        "--batch-size", "4", "--steps-per-epoch", "3",
                        "--net", net, "--device", "cpu"]) == 0
    assert "Loss is NaN" in capsys.readouterr().out
    assert not os.path.exists(out + ".pt")
    assert not os.path.exists(out + "_profile.json")
    dh = td.DataHandler(td.WsdDataset(wsd_dir), batch_size=4, seed=0)
    batch = dh.next_batch()
    kind, jloss, tloss = {
        "mdn": (tm.ConvMixtureDensityNet, jl.mdn_nll_loss, tl.mdn_nll_loss),
        "mdnfit": (tm.ConvMultiHypoMixtureDensityFit, jl.smdn_nll_loss,
                   tl.smdn_nll_loss)}[net]
    mgr = TManager(TCfg(x_max_px=HW, y_max_px=HW), net=kind(fc_input=128),
                   loss=tloss, verbose=False, device="cpu")
    mgr.build_network(input_shape=(1, 7, HW, HW))
    images = mgr._images(batch["traj"], batch["offset"],
                         dh.ds.ref_map(batch["video"][0]))
    outputs = mgr.inference(images)
    assert np.isposinf(float(tloss(tuple(map(torch.from_numpy, outputs)),
                                   torch.from_numpy(batch["label"]))))
    assert np.isposinf(float(jloss(tuple(map(jnp.asarray, outputs)),
                                   jnp.asarray(batch["label"]))))


def test_resume_fine_tune_and_max_samples(wsd_dir, trained, tmp_path):
    out = str(tmp_path / "tuned")
    assert ttrain.main(["--data", wsd_dir, "--out", out, "--epochs", "1",
                        "--batch-size", "4", "--resume", trained + ".pt",
                        "--k-top", "1", "--relax", "0.1", "--max-samples", "40",
                        "--chunk-steps", "2", "--recalibrate-bn", "1",
                        "--device", "cpu"]) == 0
    prof = _profile(out)
    assert len(prof["loss"]) == 32 // 4 // 2    # 40 samples, 32 to train
    assert np.isfinite(prof["loss"]).all()


def test_cli_needs_cuda_without_device(wsd_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--data", wsd_dir, "--out", str(tmp_path / "x"),
                     "--epochs", "1"])


@pytest.mark.skipif(not os.path.exists(PT), reason="trained checkpoint absent")
def test_load_checkpoint_of_the_trained_net_matches_jax():
    """The shipped `Model/wsd_1t20_full_torch.pt` through the port's manager
    and through the JAX package's (`NetworkManager.load_checkpoint` on the
    same `.pt`): hypotheses within 1e-3 px, the bar of
    tests/test_torch_wta_net.py."""
    from dyobav_tpu.configs import WtaNetConfiguration as JCfg
    from dyobav_tpu.models.manager import NetworkManager as JManager

    x = np.random.default_rng(0).random((2, 7, 293, 330), np.float32)
    x[:, 5] *= 255.0
    tmgr = TManager(TCfg(), verbose=False, device="cpu")
    tmgr.load_checkpoint(PT)
    jmgr = JManager(JCfg(), verbose=False)
    jmgr.build_network()
    jmgr.load_checkpoint(PT)
    got = tmgr.inference(x)
    want = jmgr.inference(x.transpose(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 20, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
