"""A small PNG writer (8-bit greyscale or RGB, no filtering, zlib level 6),
so that the port writes its images without cv2 or matplotlib. A reader
gets the same pixels as from the PNGs the JAX package writes with
``cv2.imwrite``; the bytes differ."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path: str | Path, img: np.ndarray) -> Path:
    """Write a uint8 image, (H, W) greyscale or (H, W, 3) RGB, as a PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        channels, colour = 1, 0
    elif img.ndim == 3 and img.shape[2] == 3:
        channels, colour = 3, 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * channels)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = Path(path)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                     + chunk(b"IEND", b""))
    return path
