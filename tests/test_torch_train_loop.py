"""The port's training loops (`dyobav_tpu_torch.models.manager`) against the
JAX package's `NetworkManager`, on the CPU: a small synthetic WSD dataset
(walks on a 64 x 64 map, batch 4, 20 hypotheses), one Flax init carried
across by `convert.state_dict_from_flax`, float32 against float32.

- The host-paced `train` in lockstep with JAX's: the same batches from one
  `DataHandler` seed, 5 epochs of one step, both nets in float64 (see the
  test for why): every step's loss and every `Val_loss` within 1e-6
  relative (measured: 2.4e-8), the parameters after the five AdamW steps
  within 0.01 lr (measured: 1.7e-3 lr), 99.9 % of them within 1e-4 lr, the
  BatchNorm statistics, which follow them, within 1e-5 + 1e-4 x |value|.
- `train_on_device` by outcome (its permutation is torch's, not
  `jax.random`'s), as tests/test_models.py holds JAX's: loss drop, one
  `Val_loss` an epoch, `model_ckp_2.pt`, one host sync a chunk; and the
  small-dataset clamps.
- `recalibrate_batch_stats` against JAX's on the same batches.
- A checkpoint's round trip: the same `inference` within 1e-6.
"""
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from dyobav_tpu.configs import WtaNetConfiguration as JCfg
from dyobav_tpu.models import data as jd
from dyobav_tpu.models.manager import NetworkManager as JManager
from dyobav_tpu_torch.configs import WtaNetConfiguration as TCfg
from dyobav_tpu_torch.convert import state_dict_from_flax
from dyobav_tpu_torch.models import data as td
from dyobav_tpu_torch.models import wta_net as tw
from dyobav_tpu_torch.models.manager import NetworkManager as TManager
from dyobav_tpu_torch.ops import engine

torch.set_num_threads(1)

HW, B = 64, 4
LR = 1e-3


def write_png(path, gray):
    """An 8-bit RGBA PNG (filter 0) of the uint8 image `gray` (H, W)."""
    h, w = gray.shape
    rgba = np.dstack([gray, gray, gray, np.full_like(gray, 255)])
    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def wsd_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsd64")
    # Shelves on half the map: Flax's one-pass float32 BatchNorm variance
    # loses digits when a channel's mean is far above its spread (a map
    # mostly 255; tests/test_torch_train_net.py), which would part the two
    # packages by Flax's rounding, not the port's.
    gray = np.full((HW, HW), 255, np.uint8)
    gray[:, 8:16] = gray[:, 24:32] = gray[:, 40:48] = gray[:, 56:64] = 0
    write_png(str(root / "label.png"), gray)
    return td.write_synthetic_wsd(str(root / "data"), str(root / "label.png"),
                                  n_videos=2, n_peds=3, n_frames=14, seed=1,
                                  speed=1.5)


@pytest.fixture(scope="module")
def init():
    """One Flax init at 64 x 64: (its numpy variables, the JAX config)."""
    cfg = JCfg(x_max_px=HW, y_max_px=HW, batch_size=B, learning_rate=LR)
    mgr = JManager(cfg, seed=0, verbose=False)
    mgr.build_network(input_shape=(1, HW, HW, 7))
    return jax.tree_util.tree_map(np.asarray, {
        "params": mgr.state.params, "batch_stats": mgr.state.batch_stats})


def jax_manager(variables, **cfg):
    mgr = JManager(JCfg(x_max_px=HW, y_max_px=HW, batch_size=B,
                        learning_rate=LR, **cfg), seed=0, verbose=False)
    mgr.build_network(input_shape=(1, HW, HW, 7))
    mgr.state = mgr.state.replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jax.numpy.asarray,
                                           variables["batch_stats"]))
    return mgr


def port_manager(variables, **cfg):
    mgr = TManager(TCfg(x_max_px=HW, y_max_px=HW, batch_size=B,
                        learning_rate=LR, **cfg), seed=0, verbose=False,
                   device="cpu")
    mgr.build_network(input_shape=(1, 7, HW, HW))
    mgr.net.load_state_dict(state_dict_from_flax(variables), strict=True)
    return mgr


def handlers(wsd_dir, steps=None, seed=0, batch=B, val=0.2):
    out = []
    for mod in (jd, td):
        dh = mod.DataHandler(mod.WsdDataset(wsd_dir), batch_size=batch,
                             val_fraction=val, seed=seed)
        if steps:
            dh.batches_per_epoch = lambda: steps
        out.append(dh)
    return out


def state_dict_of(jmgr):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, {
        "params": jmgr.state.params, "batch_stats": jmgr.state.batch_stats}))


def jax_manager64(variables):
    """A JAX manager whose net computes in float64 from `variables` cast to
    float64 (its AdamW state follows); call it under `jax.enable_x64`."""
    from dyobav_tpu.models.manager import TrainState
    from dyobav_tpu.models.wta_net import ConvMultiHypoNet as JNet

    mgr = JManager(JCfg(x_max_px=HW, y_max_px=HW, batch_size=B,
                        learning_rate=LR), net=JNet(dtype=np.float64), seed=0,
                   verbose=False)
    mgr.build_network(input_shape=(1, HW, HW, 7))
    f64 = jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(a, np.float64), variables)
    mgr.state = TrainState.create(apply_fn=mgr.net.apply,
                                  params=f64["params"], tx=mgr.state.tx,
                                  batch_stats=f64["batch_stats"])
    return mgr


def test_host_train_lockstep_matches_jax(wsd_dir, init):
    """Five AdamW steps, one an epoch (the lr decays at each), each epoch
    ending in its loss sync and a validation of 2 batches.  In float32 two
    runs part by rounding: Adam's steps g / (|g| + eps) near eps and its
    first steps, about lr x sign(g), carry a rounding-level gap in a
    gradient into the parameters, and within a few steps the port's own
    float32 and float64 losses part far beyond any useful bound.  So both
    packages run the nets in float64 (`jax.enable_x64`; the port's net
    converted with `.double()`; the inputs rasterized in float32 by both):
    the losses agree within 2e-8 there, the parameters within 2e-3 lr."""
    dh_j, dh_t = handlers(wsd_dir, steps=1)
    with jax.enable_x64(True):
        jmgr = jax_manager64(init)
        jmgr.train(dh_j, B, 5, k_top_list=[1] * 5)
    tmgr = port_manager(init)
    tmgr.net.double()
    engine.to_host.syncs = 0
    tmgr.train(dh_t, B, 5, k_top_list=[1] * 5)
    assert jmgr.complete and tmgr.complete
    assert len(tmgr.Loss) == len(jmgr.Loss) == 5
    np.testing.assert_allclose(tmgr.Loss, jmgr.Loss, rtol=1e-6)
    assert len(tmgr.Val_loss) == len(jmgr.Val_loss) == 5
    np.testing.assert_allclose(tmgr.Val_loss, jmgr.Val_loss, rtol=1e-6)
    # Syncs: a loss burst at each epoch's end, and one host copy per
    # validation batch.
    assert engine.to_host.syncs == 5 * (1 + 2)
    want, got = state_dict_of(jmgr), tmgr.net.state_dict()
    dev = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel()
                          for k, _ in tmgr.net.named_parameters()]) / LR
    print(f"float64 lockstep: losses "
          f"{np.max(np.abs(np.divide(tmgr.Loss, jmgr.Loss) - 1)):.2e} "
          f"apart, parameters within {dev.max():.2e} lr")
    assert dev.max() <= 1e-2, dev.max()
    assert (dev > 1e-4).mean() <= 1e-3, (dev > 1e-4).mean()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_train_on_device_by_outcome(wsd_dir, init, tmp_path):
    """tests/test_models.py's device-loop outcomes, which JAX's
    `train_on_device` meets there: the loss drops, one `Val_loss` an epoch,
    per-epoch checkpoints; and one host sync a chunk."""
    _, dh = handlers(wsd_dir)
    mgr = port_manager(init)
    engine.to_host.syncs = 0
    mgr.train_on_device(dh, batch_size=B, epochs=3, k_top_list=[20, 4, 1],
                        chunk_steps=4, val_batches=2,
                        checkpoint_dir=str(tmp_path))
    assert mgr.complete
    n_chunks = len(dh.train_idx) // B // 4
    assert len(mgr.Loss) == 3 * n_chunks >= 3 * 4
    assert len(mgr.Val_loss) == 3 and np.isfinite(mgr.Val_loss).all()
    assert engine.to_host.syncs == 3 * (n_chunks + 1)   # chunks + val
    assert np.mean(mgr.Loss[-4:]) < np.mean(mgr.Loss[:4])
    for ep in range(3):
        assert os.path.exists(tmp_path / f"model_ckp_{ep}.pt")
    # The checkpoint is the net's state_dict, strictly loadable.
    net = tw.load_checkpoint(str(tmp_path / "model_ckp_2.pt"), "cpu",
                             TCfg(fc_input=128))
    sd = mgr.net.state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_train_on_device_small_dataset_clamps():
    """tests/test_models.py's ADVICE r2 case: an epoch shorter than
    `chunk_steps` clamps the chunk, and a validation split under one batch
    skips validation (early stopping must not fire on a NaN)."""
    rng = np.random.default_rng(1)

    class TinyDs:
        obsv_len = 5

        def __init__(self, n):
            self._map = rng.uniform(size=(HW, HW)).astype(np.float32)
            self.samples = [td.Sample(
                video="v0",
                traj=rng.uniform(10, 50, size=(5, 2)).astype(np.float32),
                offset=int(rng.integers(1, 5)),
                label=rng.uniform(10, 50, size=2).astype(np.float32))
                for _ in range(n)]

        def __len__(self):
            return len(self.samples)

        def ref_map(self, video):
            return self._map

        def image_shape(self):
            return self._map.shape

    mgr = TManager(TCfg(x_max_px=HW, y_max_px=HW, early_stopping=2),
                   verbose=False, device="cpu")
    mgr.build_network(input_shape=(1, 7, HW, HW))
    dh = td.DataHandler(TinyDs(40), batch_size=8, val_fraction=0.1, seed=0)
    mgr.train_on_device(dh, batch_size=8, epochs=2, k_top_list=[20, 4],
                        chunk_steps=512)
    assert mgr.complete
    assert len(mgr.Loss) == 2                   # one chunk an epoch
    assert len(mgr.Val_loss) == 2 and np.isnan(mgr.Val_loss).all()
    with pytest.raises(ValueError, match="full batch"):
        mgr.train_on_device(td.DataHandler(TinyDs(8), batch_size=8, seed=0),
                            batch_size=8, epochs=1)
    with pytest.raises(ValueError, match="k_top_list"):
        mgr.train_on_device(dh, batch_size=8, epochs=2, k_top_list=[1])


def test_recalibrate_batch_stats_matches_jax(wsd_dir, init):
    dh_j, dh_t = handlers(wsd_dir, seed=5)
    jmgr, tmgr = jax_manager(init), port_manager(init)
    jmgr.recalibrate_batch_stats(dh_j, n_batches=3)
    tmgr.recalibrate_batch_stats(dh_t, n_batches=3)
    want, got = state_dict_of(jmgr), tmgr.net.state_dict()
    keys = [k for k in want if "running" in k]
    moved = max(float((got[k] - torch.from_numpy(init_v)).abs().max())
                for k, init_v in ((k, state_dict_from_flax(init)[k].numpy())
                                  for k in keys))
    assert moved > 1e-2                     # the statistics did move
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_checkpoint_round_trip(wsd_dir, init, tmp_path):
    _, dh = handlers(wsd_dir, steps=2)
    mgr = port_manager(init)
    mgr.train(dh, B, 1, k_top_list=[1], val_after_batch=10)
    path = mgr.save_checkpoint(str(tmp_path), epoch=None)
    assert path == str(tmp_path / "model.pt")
    x = np.random.default_rng(2).normal(size=(3, 7, HW, HW)).astype(
        np.float32)
    back = TManager(TCfg(x_max_px=HW, y_max_px=HW), verbose=False,
                    device="cpu")
    back.build_network(input_shape=(1, 7, HW, HW))
    back.load_checkpoint(path)
    out = mgr.inference(x)
    assert out.shape == (3, 20, 2)
    np.testing.assert_allclose(back.inference(x), out, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="orbax"):
        back.load_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        back.load_checkpoint(str(tmp_path / "absent.pt"))


def test_manager_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TManager(TCfg(), verbose=False)
