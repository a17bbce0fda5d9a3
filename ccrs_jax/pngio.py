"""A small PNG codec on ``zlib`` and numpy (RFC 2083).

Reads and writes non-interlaced 8- and 16-bit grayscale, gray+alpha, RGB
and RGBA images, with all five scanline filters.  Unfiltering runs in the
native helper library (``native/quadproc.cpp`` ``png_unfilter``): the
Average and Paeth filters depend on the previous pixel of the same row,
which numpy cannot vectorize.  Palette images, bit depths below 8 and
interlaced files are refused with a ValueError.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to (H, W) or (H, W, C) uint8/uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = ihdr
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"unsupported PNG (color type {color}, bit depth {depth}, "
            f"interlace {interlace}): only 8/16-bit non-interlaced "
            "gray, gray+alpha, RGB and RGBA are read"
        )
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    out = np.empty((height, stride), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    from .native import load

    rc = load().png_unfilter(
        src.ctypes.data_as(u8p), height, stride, bpp, out.ctypes.data_as(u8p)
    )
    if rc != 0:
        raise ValueError("PNG row with an unknown filter type")
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return out.reshape(shape)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filter_type: int = 2, level: int = 6) -> bytes:
    """Encode (H, W) or (H, W, C) uint8/uint16 (C in 1..4) as PNG bytes.

    ``filter_type``: the filter of every row (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    height, width = img.shape[:2]
    depth = img.dtype.itemsize * 8
    bpp = channels * depth // 8
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    x = rows.view(np.uint8).reshape(height, width * bpp)

    def left(v):
        out = np.zeros_like(v)
        out[:, bpp:] = v[:, :-bpp]
        return out

    def up(v):
        out = np.zeros_like(v)
        out[1:] = v[:-1]
        return out

    predict = {
        0: lambda: 0,
        1: lambda: left(x),
        2: lambda: up(x),
        3: lambda: (left(x).astype(np.int16) + up(x)) >> 1,
        4: lambda: _paeth(*(v.astype(np.int16)
                            for v in (left(x), up(x), left(up(x))))),
    }
    if filter_type not in predict:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    filtered = np.empty((height, width * bpp + 1), np.uint8)
    filtered[:, 0] = filter_type
    filtered[:, 1:] = (x - predict[filter_type]()) & 0xFF

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body))
        )

    ihdr = struct.pack(">IIBBBBB", width, height, depth,
                       _COLOR_TYPE[channels], 0, 0, 0)
    return (
        _SIGNATURE + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, filter_type: int = 2,
              level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type, level))
