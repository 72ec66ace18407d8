"""The port's predictor inputs against the JAX package's, on the CPU: the
heat-map stacks (`dyobav_tpu_torch.models.heatmap`), `pad_traj`, the PNG
reader (`dyobav_tpu_torch.maps.png`, against PIL) and `MainBase.ref_map`.
"""
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyobav_tpu.models import heatmap as jhm
from dyobav_tpu.sim import harness as jh
from dyobav_tpu_torch.maps.png import read_png
from dyobav_tpu_torch.models import heatmap as thm
from dyobav_tpu_torch.sim import harness as th

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                    "warehouse_sim_original")
LABEL = os.path.join(DATA, "label.png")
pytestmark = pytest.mark.skipif(not os.path.exists(LABEL),
                                reason="warehouse data not imported")


@pytest.fixture(scope="module")
def ref_map():
    return th.MainBase(seed=0).ref_map


def _trajs(n, seed):
    """n random 5-point pixel trajectories inside (and one leaving) the
    330 x 293 map."""
    rng = np.random.default_rng(seed)
    start = rng.uniform([0, 0], [330, 293], (n, 1, 2))
    trajs = start + np.cumsum(rng.normal(0, 4, (n, 5, 2)), axis=1)
    trajs[0, -1] = [-30.0, 400.0]
    return trajs.astype(np.float32)


def test_input_stack_matches_jax(ref_map):
    trajs = _trajs(2, seed=0)
    offsets = np.arange(1, 21, dtype=np.float32)
    rm = ref_map.astype(np.float32)
    port = thm.traj_to_input_stack(torch.from_numpy(trajs),
                                   torch.from_numpy(rm),
                                   torch.from_numpy(offsets)).numpy()
    assert port.shape == (2, 20, 7, 293, 330)
    for i in range(2):
        ref = np.asarray(jhm.traj_to_input_stack(
            jnp.asarray(trajs[i]), jnp.asarray(rm), jnp.asarray(offsets)))
        np.testing.assert_allclose(port[i], ref.transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-6)
        # One trajectory alone gives its slice of the batched call.
        one = thm.traj_to_input_stack(trajs[i], rm, offsets).numpy()
        np.testing.assert_array_equal(one, port[i])
    bump = thm.gaussian_map(torch.tensor([12.5, 40.0]), 293, 330).numpy()
    jbump = jax.jit(lambda c: jhm.gaussian_map(c, 293, 330))(
        jnp.array([12.5, 40.0]))
    np.testing.assert_allclose(bump, np.asarray(jbump), rtol=0, atol=1e-6)
    assert bump.max() == 1.0


def test_input_batch_matches_jax(ref_map):
    trajs = _trajs(3, seed=1)
    offsets = np.array([1.0, 7.0, 20.0], np.float32)
    rm = ref_map.astype(np.float32)
    port = thm.traj_to_input_batch(trajs, rm, offsets).numpy()
    ref = np.asarray(jhm.traj_to_input_batch(
        jnp.asarray(trajs), jnp.asarray(rm), jnp.asarray(offsets)))
    assert port.shape == (3, 7, 293, 330)
    np.testing.assert_allclose(port, ref.transpose(0, 3, 1, 2), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_pad_traj_matches_jax(n):
    traj = [(float(i), 2.0 * i) for i in range(n)]
    assert thm.pad_traj(traj) == jhm.pad_traj(traj)
    assert len(thm.pad_traj(traj)) == 5


def _png(pixels: np.ndarray, filters, **header) -> bytes:
    """A PNG of uint8 RGBA `pixels` (H, W, 4) whose scanline r is written with
    filter filters[r % len(filters)]: the encoder's side of each filter.
    `header` overrides the IHDR's depth, color type or interlace byte."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for r in range(h):
        kind = filters[r % len(filters)]
        x = rows[r]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - cc
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - cc)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, cc))
        raw += bytes([kind]) + bytes(((x - pred) % 256).astype(np.uint8))
        prev = x
    ihdr = dict(depth=8, color=6, interlace=0)
    ihdr.update(header)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, ihdr["depth"],
                                         ihdr["color"], 0, 0,
                                         ihdr["interlace"]))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_reader_undoes_each_filter(tmp_path, filters):
    rng = np.random.default_rng(sum(filters))
    pixels = rng.integers(0, 256, (11, 13, 4), dtype=np.uint8)
    pixels[:, 4:9] = pixels[:, 4:5]                 # flat runs as well
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(_png(pixels, filters))
    img = read_png(path)
    np.testing.assert_array_equal(img, pixels)
    from PIL import Image
    np.testing.assert_array_equal(img, np.asarray(Image.open(path)))


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    pixels = np.zeros((2, 2, 4), np.uint8)
    path = str(tmp_path / "img.png")
    for header, match in ((dict(depth=16), "bit depth 16"),
                          (dict(color=0), "color type 0"),
                          (dict(color=2), "color type 2"),
                          (dict(color=3), "color type 3"),
                          (dict(interlace=1), "interlace 1")):
        with open(path, "wb") as f:
            f.write(_png(pixels, (0,), **header))
        with pytest.raises(ValueError, match=match):
            read_png(path)
    data = bytearray(_png(pixels, (0,)))
    data[20] ^= 1                                    # inside IHDR's body
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(path)


def test_label_png_and_ref_map_match_pil_and_jax(ref_map):
    from PIL import Image

    img = read_png(LABEL)
    assert img.shape == (293, 330, 4) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, np.asarray(Image.open(LABEL)))
    jref = jh.MainBase(seed=0).ref_map
    assert ref_map.dtype == jref.dtype
    np.testing.assert_array_equal(ref_map, jref)
