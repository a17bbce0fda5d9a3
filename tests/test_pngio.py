"""PNG codec (ccrs_jax/pngio.py): round trips over every filter type, bit
depth and channel layout, and interchange with imageio's files."""

import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ccrs_jax.pngio import decode_png, encode_png, read_png, write_png

LAYOUTS = [(), (2,), (3,), (4,)]  # gray, gray+alpha, RGB, RGBA


@settings(max_examples=60, deadline=None)
@given(
    h=st.integers(1, 9),
    w=st.integers(1, 9),
    layout=st.sampled_from(LAYOUTS),
    dtype=st.sampled_from([np.uint8, np.uint16]),
    ftype=st.integers(0, 4),
    seed=st.integers(0, 2**31),
)
def test_round_trip_property(h, w, layout, dtype, ftype, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (h, w) + layout).astype(dtype)
    data = encode_png(img, filter_type=ftype)
    out = decode_png(data)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_on_a_smooth_image(ftype, tmp_path):
    # smooth content makes Average/Paeth predictions non-trivial
    yy, xx = np.mgrid[0:37, 0:53]
    img = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img, filter_type=ftype)
    with open(p, "rb") as f:
        raw = zlib.decompress(f.read()[8 + 25 + 8 :].split(b"IEND")[0][:-8])
    assert set(raw[:: 53 + 1]) == {ftype}  # every row carries that filter
    np.testing.assert_array_equal(read_png(p), img)


@pytest.mark.parametrize(
    "shape,dtype",
    [((31, 45), np.uint8), ((31, 45, 2), np.uint8), ((31, 45, 3), np.uint8),
     ((31, 45, 4), np.uint8), ((31, 45), np.uint16)],
)
def test_interchange_with_imageio(shape, dtype):
    iio = pytest.importorskip("imageio.v3")
    rng = np.random.default_rng(3)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    # imageio (Pillow) picks its own, adaptive per-row filters
    theirs = iio.imwrite("<bytes>", img, extension=".png")
    np.testing.assert_array_equal(decode_png(theirs), img)
    for ftype in range(5):
        back = iio.imread(encode_png(img, ftype), extension=".png")
        np.testing.assert_array_equal(back, img)


def _png_with_ihdr(**kw):
    f = dict(w=4, h=3, depth=8, color=0, interlace=0)
    f.update(kw)
    ihdr = struct.pack(">IIBBBBB", f["w"], f["h"], f["depth"], f["color"], 0, 0,
                       f["interlace"])

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    body = zlib.compress(b"\x00" * (f["h"] * (f["w"] + 1)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", body)
            + chunk(b"IEND", b""))


@pytest.mark.parametrize(
    "kw", [dict(color=3), dict(depth=4), dict(interlace=1)],
    ids=["palette", "depth4", "interlaced"],
)
def test_unsupported_formats_refused(kw):
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(_png_with_ihdr(**kw))


def test_corrupt_files_refused():
    good = _png_with_ihdr()
    assert decode_png(good).shape == (3, 4)
    bad_crc = bytearray(good)
    bad_crc[20] ^= 1  # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad_crc))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])
    img = np.zeros((2, 2), np.uint8)
    data = bytearray(encode_png(img, 0))
    # rewrite the filter byte of row 0 to an unknown type (and fix the CRC)
    start = data.index(b"IDAT") + 4
    n = struct.unpack(">I", data[start - 8 : start - 4])[0]
    raw = bytearray(zlib.decompress(bytes(data[start : start + n])))
    raw[0] = 9
    body = zlib.compress(bytes(raw))
    idat = (struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body)))
    patched = bytes(data[: start - 8]) + idat + bytes(data[start + n + 4 :])
    with pytest.raises(ValueError, match="filter type"):
        decode_png(patched)
