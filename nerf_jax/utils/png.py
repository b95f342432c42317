"""A small PNG codec on zlib and numpy: the image I/O of the data loader,
the eval CLI and the render server, with no imaging package.

Reads 8-bit, non-interlaced greyscale, grey+alpha, RGB and RGBA images with
any of the five scanline filters; writes 8-bit greyscale, RGB and RGBA
(filter 0 on every row). Palette, 16-bit and interlaced files raise
``ValueError``.

Unfiltering runs along anti-diagonals: a byte depends on its left, upper
and upper-left neighbours only, so every pixel on one anti-diagonal
``row + col = d`` can be reconstructed at once, and an H x W image takes
H + W - 1 vectorized steps whatever the filters of its rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 4 grey+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ((h, 1 + w*bpp) uint8, filter
    byte first) -> (h, w, bpp) uint8."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ftype.max())}")
    if not ftype.any():   # all rows unfiltered, as encode_png writes them
        return raw[:, 1:].reshape(h, w, bpp).copy()
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # recon[r + 1, x + 1] is pixel (r, x); row 0 and column 0 are the
    # zero neighbours the filters assume outside the image
    recon = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = recon[r + 1, x]          # left
        b = recon[r, x + 1]          # up
        c = recon[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        recon[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return recon[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1, 2, 3 or 4."""
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"PNG: only 8-bit non-interlaced grey/RGB/RGBA is supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG: image data does not match its header")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 with C in {1, 2, 3, 4} -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG: expected uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG: {c} channels is not grey/RGB/RGBA")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
