"""A PNG encoder on the standard library (zlib + struct), in place of Pillow,
which the card's machine does not have.

Writes 8-bit RGB or RGBA images ([H, W, 3] or [H, W, 4] uint8 arrays), one
IDAT chunk, filter type 0 (none) on every row. Any PNG decoder reads the
same pixels back; only the bytes differ from Pillow's encoder.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}   # channels -> PNG color type (truecolor, with alpha)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of `img`, [H, W, 3] or [H, W, 4] uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"need an [H, W, 3|4] uint8 array, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.empty((h, 1 + w * c), dtype=np.uint8)
    rows[:, 0] = 0                      # filter type 0 on every scanline
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))


def idat_pixels(data: bytes) -> np.ndarray:
    """The pixels of a PNG that `encode_png` wrote (its IDAT inflated, the
    filter bytes dropped): the check that a file holds the array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color not in (2, 6):
                raise ValueError(f"not an 8-bit RGB/RGBA PNG: depth {depth}, color {color}")
            shape = (h, w, 3 if color == 2 else 4)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h, w, c = shape
    rows = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("a scanline uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, c).copy()
