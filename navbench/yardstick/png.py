"""A small PNG reader on the standard library's `zlib` and `struct`.

Frozen copy of `dyobav_tpu_torch/maps/png.py`, so that the benchmark and
its references read the map without the program.

The predictor's map channel is read from `label.png`, and the port runs
where no imaging library is installed.  This reads what the map file is:
8-bit RGBA, non-interlaced, with scanline filters 0-4; it raises on
anything else (other color types, other bit depths, interlacing) and on a
failed chunk CRC.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_RGBA = 6                                  # the IHDR color type of RGBA


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes (uint8) with filter `kind` undone, given the
    previous reconstructed scanline (zeros for the first)."""
    if kind == 0:
        return row
    if kind == 2:                                            # Up
        return row + prev
    if kind == 1:                                            # Sub
        # Each byte adds the reconstructed byte bpp to its left: a running
        # sum per sample position, modulo 256.
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not defined")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:                                        # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0                   # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), dtype=np.uint8)


def read_png(path: str) -> np.ndarray:
    """The RGBA image as uint8 (H, W, 4), as
    `np.asarray(PIL.Image.open(path))` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color != _RGBA or interlace != 0 \
            or compression != 0 or filtering != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {color},"
            f" interlace {interlace}); only 8-bit non-interlaced RGBA is "
            "read")
    bpp = 4
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    img = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for r in range(height):
        prev = img[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prev, bpp)
    return img.reshape(height, width, bpp)


def gray_map(path: str) -> np.ndarray:
    """The map channel of the predictor: the mean of the RGB bytes, float64
    (H, W)."""
    return read_png(path)[:, :, :3].astype(np.float64).sum(axis=2) / 3.0
