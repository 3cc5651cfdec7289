"""PNG encoding of 8-bit RGB images without PIL.

The card's machine has no PIL, and the texture bake writes three PNGs per
asset; the JAX package encodes them with PIL at ``compress_level=1``. This
writer gives the same image with ``zlib`` at level 1: filter type 0 on every
row, one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(rgb: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no interlace)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type 0 (none) on every row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolor
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 image to ``path`` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb, level))
