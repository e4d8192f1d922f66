"""PNG writing without an image library (the JAX package writes its
validation renders with cv2): 8-bit RGB, one IDAT of zlib-compressed rows,
filter type 0."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes of a PNG file."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"png_bytes takes uint8 [H, W, 3], not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [H, W, 3] in [0, 1] -> uint8, rounded (the JAX package's
    `native.pack_frame`)."""
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255.0 + 0.5).astype(np.uint8)
