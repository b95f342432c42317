"""The zlib + numpy PNG codec (nerf_jax/utils/png.py)."""

import struct
import zlib

import numpy as np
import pytest

from nerf_jax.utils.png import decode_png, encode_png, read_png, write_png


def _image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 7 + yy * 3 + k * 40) % 256 for k in range(c)], -1)
    img[h // 3:h // 2] = rng.integers(0, 256, (h // 2 - h // 3, w, c))
    return img.astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(img, ftypes):
    """A PNG of ``img`` whose row r uses filter ftypes[r] — the encoder
    side of the spec, written independently of the decoder."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for r in range(h):
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
                4: _paeth(left, up, upleft)}[ftypes[r]]
        rows.append(bytes([ftypes[r]]) + ((cur - pred) % 256)
                    .astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_round_trip(channels, tmp_path):
    img = _image(13, 17, channels)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decodes_filter_type(ftype):
    img = _image(11, 9, 4, seed=ftype)
    got = decode_png(_filtered_png(img, [ftype] * 11))
    np.testing.assert_array_equal(got, img)


def test_decodes_mixed_filters_rgb():
    img = _image(20, 15, 3, seed=7)
    ftypes = [r % 5 for r in range(20)]
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftypes)), img)


@pytest.mark.parametrize("header", [
    (8, 8, 16, 6, 0, 0, 0),   # 16-bit
    (8, 8, 8, 3, 0, 0, 0),    # palette
    (8, 8, 8, 2, 0, 0, 1),    # interlaced
])
def test_rejects_unsupported(header):
    data = bytearray(encode_png(_image(8, 8, 3)))
    body = struct.pack(">IIBBBBB", *header)
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    with pytest.raises(ValueError):
        decode_png(bytes(data))


def test_rejects_bad_crc():
    data = bytearray(encode_png(_image(8, 8, 3)))
    data[30] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
