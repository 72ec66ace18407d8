"""The port's training-data pipeline (`dyobav_tpu_torch.models.data`) and
training configuration against the JAX package's, on the CPU.

A synthetic WSD directory (`write_synthetic_wsd`: walks on the free space of
the real warehouse `label.png`, a few videos) is read by both packages: the
index (videos, trajectories, offsets, labels) and the map channel equal
JAX's bit for bit, `DataHandler` draws the same split and the same batches
from one seed, and `rasterize_batch` agrees within 1e-6.  The training YAML
loads field for field as JAX loads it.
"""
import os

import numpy as np
import pytest
import torch

from dyobav_tpu import configs as jcfg
from dyobav_tpu.models import data as jd
from dyobav_tpu_torch import configs as tcfg
from dyobav_tpu_torch.models import data as td

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL = os.path.join(REPO, "data", "warehouse_sim_original", "label.png")
TRAIN_YAML = os.path.join(REPO, "config", "wsd_1t20_train.yaml")


@pytest.fixture(scope="module")
def wsd_dir(tmp_path_factory):
    return td.write_synthetic_wsd(str(tmp_path_factory.mktemp("wsd")), LABEL,
                                  n_videos=3, n_peds=2, n_frames=14, seed=4)


@pytest.fixture(scope="module")
def datasets(wsd_dir):
    return jd.WsdDataset(wsd_dir), td.WsdDataset(wsd_dir)


def test_training_yaml_loads_as_jax_loads_it(tmp_path):
    j = jcfg.WtaNetConfiguration.from_yaml(TRAIN_YAML, with_partition=True)
    t = tcfg.WtaNetConfiguration.from_yaml(TRAIN_YAML, with_partition=True)
    assert t.to_dict() == j.to_dict()
    assert list(t.to_dict()) == list(j.to_dict())
    # The two defaults that differ, and only those.
    dj = jcfg.WtaNetConfiguration().to_dict()
    dt = tcfg.WtaNetConfiguration().to_dict()
    assert {k for k in dj if dj[k] != dt[k]} == {"device", "model_path"}
    assert (dt["device"], dt["model_path"]) == (
        "cuda", "Model/wsd_1t20_full_torch.pt")
    assert t._PARTITION == j._PARTITION
    out = str(tmp_path / "regen.yaml")
    t.save_yaml_partition(out)
    assert (tcfg.WtaNetConfiguration.from_yaml(out, with_partition=True)
            == t)
    with open(out) as f:
        assert f.read().count("---") == 4
    assert jcfg.WtaNetConfiguration.from_yaml(
        out, with_partition=True).to_dict() == j.to_dict()


def test_synthetic_walks_stay_on_free_space(datasets):
    _, ds = datasets
    gray = ds.ref_map("video_000")
    assert gray.shape == (293, 330)
    assert len({s.video for s in ds.samples}) == 3
    pts = np.concatenate([np.concatenate([s.traj, s.label[None]])
                          for s in ds.samples])
    cols, rows = pts[:, 0].astype(int), pts[:, 1].astype(int)
    assert (gray[rows, cols] == 255.0).all()
    steps = np.linalg.norm(np.diff(ds.samples[0].traj, axis=0), axis=1)
    np.testing.assert_allclose(steps, 2.0, atol=1e-3)


def test_index_and_ref_map_equal_jax_bit_for_bit(datasets):
    j, t = datasets
    assert len(t) == len(j) > 0
    assert (t.obsv_len, t.pred_offset_max) == (j.obsv_len, j.pred_offset_max)
    for a, b in zip(j.samples, t.samples):
        assert (a.video, a.offset) == (b.video, b.offset)
        assert a.traj.dtype == b.traj.dtype == np.float32
        np.testing.assert_array_equal(b.traj, a.traj)
        np.testing.assert_array_equal(b.label, a.label)
    for video in sorted({s.video for s in t.samples}):
        mj, mt = j.ref_map(video), t.ref_map(video)
        assert mt.dtype == mj.dtype == np.float32
        np.testing.assert_array_equal(mt, mj)
    assert t.image_shape() == j.image_shape()


@pytest.mark.parametrize("seed,batch,val", [(0, 4, 0.2), (3, 7, 0.1)])
def test_data_handler_draws_the_same_split_and_batches(datasets, seed, batch,
                                                       val):
    j, t = datasets
    hj = jd.DataHandler(j, batch_size=batch, val_fraction=val, seed=seed)
    ht = td.DataHandler(t, batch_size=batch, val_fraction=val, seed=seed)
    np.testing.assert_array_equal(ht.val_idx, hj.val_idx)
    np.testing.assert_array_equal(ht.train_idx, hj.train_idx)
    assert ht.batches_per_epoch() == hj.batches_per_epoch()
    for _ in range(2 * hj.batches_per_epoch() + 3):      # across reshuffles
        bj, bt = hj.next_batch(), ht.next_batch()
        assert bt["video"] == bj["video"]
        for k in ("traj", "offset", "label"):
            np.testing.assert_array_equal(bt[k], bj[k])
    vj, vt = list(hj.val_batches(3)), list(ht.val_batches(3))
    assert len(vt) == len(vj) == 3
    for bj, bt in zip(vj, vt):
        np.testing.assert_array_equal(bt["traj"], bj["traj"])


def test_rasterize_batch_matches_jax(datasets):
    j, t = datasets
    batch = td.DataHandler(t, batch_size=6, seed=1).next_batch()
    assert len(set(batch["video"])) > 1          # more than one map group
    img_j, lab_j = jd.rasterize_batch(batch, j)
    img_t, lab_t = td.rasterize_batch(batch, t, device="cpu")
    assert img_t.shape == (6, 7, 293, 330) and img_t.dtype == np.float32
    np.testing.assert_allclose(img_t, np.asarray(img_j).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lab_t, lab_j)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            td.rasterize_batch(batch, t)
