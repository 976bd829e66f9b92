"""Native display bridge (native/display.cpp) parity tests.

The C++ resolve/pack/PNG path (built from native/display.cpp at first
use) must reproduce the Python reference
implementations exactly: core/color.py (finalize_image + pack_rgba8, which
themselves pin the reference's CPUPathTracer.cpp:87-117 output conversion)
and io/image.py's pure-Python PNG writer.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from spt_tpu.core import color
from spt_tpu.io import image as im
from spt_tpu.io import native_display as nd


@pytest.fixture(autouse=True)
def _library():
    """Builds the library at first use; skips only where it cannot build."""
    if not nd.available():
        pytest.skip("native display library did not build on this host")


@pytest.fixture(scope="module")
def accum(rng_np):
    # Radiance sums with a wide dynamic range, incl. exact zeros.
    a = rng_np.gamma(1.5, 2.0, (33, 47, 3)).astype(np.float32)
    a[0, 0] = 0.0
    return a


def _python_resolve(accum, n_samples, **kw):
    f32 = np.asarray(color.finalize_image(accum, n_samples, **kw))
    u32 = np.asarray(color.pack_rgba8(f32))
    u8 = np.asarray(color.to_u8_array(f32))
    return f32, u32, u8


def test_default_resolve_exact(accum):
    # Power-of-two sample count -> identical float math, bit-exact output.
    f32, u32, u8 = nd.resolve_pack(accum, 4.0)
    pf32, pu32, pu8 = _python_resolve(accum, 4.0)
    np.testing.assert_array_equal(f32, pf32)
    np.testing.assert_array_equal(u32, pu32)
    np.testing.assert_array_equal(u8, pu8)


@pytest.mark.parametrize("tonemap", ["none", "reinhard", "aces"])
@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_tonemap_gamma_parity(accum, tonemap, gamma):
    kw = dict(exposure=1.7, tonemap=tonemap, gamma=gamma)
    f32, u32, u8 = nd.resolve_pack(accum, 3.0, **kw)
    pf32, _, pu8 = _python_resolve(accum, 3.0, **kw)
    np.testing.assert_allclose(f32, pf32, atol=2e-6)
    assert np.max(np.abs(u8.astype(int) - pu8.astype(int))) <= 1
    # Pack layout: R in the high byte (reference Color.h:7-10).
    assert np.all((u32 & 0xFF) == 0xFF)
    np.testing.assert_array_equal((u32 >> 24) & 0xFF, u8[..., 0])


def test_auto_exposure_parity(accum):
    kw = dict(auto_exposure=True, target_exposure=0.18)
    f32, _, _ = nd.resolve_pack(accum, 5.0, **kw)
    pf32, _, _ = _python_resolve(accum, 5.0, **kw)
    np.testing.assert_allclose(f32, pf32, rtol=1e-4, atol=1e-6)


def _decode_png_rgb(data):
    """Minimal decoder for the subset we emit (RGB8, filter 0 per row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        assert crc == (zlib.crc32(tag + payload) & 0xFFFFFFFF)
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = 1 + 3 * w
    rows = []
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        assert row[0] == 0  # filter None
        rows.append(np.frombuffer(row[1:], np.uint8))
    return np.stack(rows).reshape(h, w, 3)


def test_png_roundtrip(rng_np, tmp_path):
    img = rng_np.integers(0, 256, (21, 37, 3), dtype=np.uint8)
    data = nd.encode_png(img)
    assert data is not None
    np.testing.assert_array_equal(_decode_png_rgb(data), img)

    # write_png routes through the native encoder and yields the same file.
    path = os.path.join(tmp_path, "out.png")
    im.write_png(path, img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(_decode_png_rgb(f.read()), img)


def test_png_matches_pure_python_decoded(rng_np, tmp_path):
    img = rng_np.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    pure = os.path.join(tmp_path, "pure.png")
    im._write_png_pure(pure, img)
    with open(pure, "rb") as f:
        np.testing.assert_array_equal(_decode_png_rgb(f.read()), img)
