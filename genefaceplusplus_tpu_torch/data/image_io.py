"""Image files without an image library (the JAX package reads and writes
them with cv2).

Reading: `read_image` sniffs the file's signature as cv2.imread does and
returns what JAX's `cv2.imread(..., IMREAD_UNCHANGED)` + `cvtColor` gives:
uint8 [H, W, 3] RGB, or [H, W, 4] RGBA for a PNG with alpha. No EXIF
orientation is applied, as with IMREAD_UNCHANGED.
  * PNG: 8-bit RGB or RGBA, not interlaced. The chunks, their CRCs and
    Python's zlib are walked here; the row filters are undone by
    `csrc/image_codec.cpp`.
  * JPEG: baseline (SOF0/SOF1), 8-bit, three components in one interleaved
    scan, 4:4:4, 4:2:2 or 4:2:0, restart intervals. `csrc/image_codec.cpp`
    decodes it with libjpeg-turbo's integer arithmetic, so the pixels equal
    cv2's bit for bit.
Anything else raises ValueError naming the file and the feature.

Writing: `png_bytes` / `write_png` (RGB or RGBA, filter type 0) and
`jpeg_bytes` / `write_jpeg` (baseline, at cv2.imwrite's defaults: quality
95, 4:2:0), which stand in for cv2.imwrite.

The C++ source is compiled at first use with the host compiler into
`build/host/` (`utils/build.py`), keyed by the hash of the source, the
compiler (path and version) and the flags; a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from genefaceplusplus_tpu_torch.utils.build import compile_libraries, keyed_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "image_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_ERR_LEN = 256

Source = Union[str, os.PathLike, bytes]


def _find_cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("cannot build csrc/image_codec.cpp: no C++ compiler (c++ or g++) on PATH")


def build_codec() -> Path:
    """Compile csrc/image_codec.cpp into build/host/ unless the library for
    this source, compiler (path and version) and flags exists; returns its
    path."""
    cxx = _find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    lib = keyed_library(BUILD_DIR, "image_codec", [SOURCE.read_bytes(), " ".join((cxx, version, *CXX_FLAGS)).encode()])
    compile_libraries({lib: [cxx, *CXX_FLAGS, str(SOURCE)]})
    return lib


@functools.lru_cache(maxsize=None)
def _codec() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_codec()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gf_png_unfilter.argtypes = [ptr, i64, ptr, i32, i32, i32, ctypes.c_char_p, i32]
    lib.gf_png_unfilter.restype = i32
    lib.gf_jpeg_decode.argtypes = [ptr, i64, ptr, i64, ptr, ctypes.c_char_p, i32]
    lib.gf_jpeg_decode.restype = i32
    lib.gf_jpeg_encode.argtypes = [ptr, i32, i32, ptr, i64, ctypes.c_char_p, i32]
    lib.gf_jpeg_encode.restype = i64
    return lib


def _load(src: Source):
    """(bytes, name for messages) of a path or of bytes."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------- PNG

_PNG_COLOR = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale with alpha", 6: "RGBA"}
_PNG_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def read_png(src: Source) -> np.ndarray:
    """8-bit RGB or RGBA PNG -> uint8 [H, W, 3|4] (RGB order, as cv2 +
    cvtColor gives)."""
    return _decode_png(*_load(src))


def _decode_png(data: bytes, name: str) -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    p, header, idat, ended = len(PNG_SIGNATURE), None, [], False
    while not ended:
        if p + 12 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        (length,), kind = struct.unpack(">I", data[p:p + 4]), data[p + 4:p + 8]
        body = data[p + 8:p + 8 + length]
        if p + 12 + length > len(data):
            raise ValueError(f"{name}: truncated PNG (in chunk {kind!r})")
        (crc,) = struct.unpack(">I", data[p + 8 + length:p + 12 + length])
        p += 12 + length
        critical = kind in _PNG_CRITICAL or not (kind[0] & 0x20)
        if critical and zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC on PNG chunk {kind.decode('latin-1')}")
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{name}: bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
        elif kind == b"tRNS":
            raise ValueError(f"{name}: PNG transparency chunk (tRNS) is not supported")
        elif critical and kind != b"PLTE":
            raise ValueError(f"{name}: unknown critical PNG chunk {kind.decode('latin-1')}")
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, compression, filt, interlace = header
    if color not in (2, 6):
        raise ValueError(f"{name}: {_PNG_COLOR.get(color, f'color type {color}')} PNG is not supported "
                         "(only 8-bit RGB and RGBA)")
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG is not supported (only 8-bit)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if compression or filt or not w or not h:
        raise ValueError(f"{name}: bad PNG header")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: truncated or corrupt PNG image data ({e})") from None
    ch = 3 if color == 2 else 4
    out = np.empty((h, w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _codec().gf_png_unfilter(_ptr(raw), len(raw), _ptr(out), h, w, ch, err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB or [H, W, 4] RGBA -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"png_bytes takes uint8 [H, W, 3|4], not {img.dtype} {img.shape}")
    h, w, ch = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(png_bytes(img))


# ---------------------------------------------------------------- JPEG

def read_jpeg(src: Source) -> np.ndarray:
    """Baseline JPEG -> uint8 [H, W, 3] RGB, equal to cv2.imread +
    cvtColor(BGR2RGB)."""
    return _decode_jpeg(*_load(src))


def _decode_jpeg(data: bytes, name: str) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    dims = np.zeros(2, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = _codec()
    rc = lib.gf_jpeg_decode(_ptr(buf), len(buf), None, 0, _ptr(dims), err, _ERR_LEN)
    if rc == 1:
        out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
        rc = lib.gf_jpeg_decode(_ptr(buf), len(buf), _ptr(out), out.nbytes, _ptr(dims), err, _ERR_LEN)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def jpeg_bytes(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> a baseline JPEG (JFIF) at cv2.imwrite's
    defaults: quality 95 (libjpeg's scaling of the standard tables) and
    4:2:0 sampling."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"jpeg_bytes takes uint8 [H, W, 3], not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    # at most ~430 bytes a block (16-bit codes, 0xFF stuffing), 6 blocks per 16x16 MCU
    cap = ((w + 15) // 16) * ((h + 15) // 16) * 6 * 430 + 1024
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = _codec().gf_jpeg_encode(_ptr(rgb), h, w, _ptr(out), cap, err, _ERR_LEN)
    if n < 0:
        raise ValueError(f"jpeg_bytes: {err.value.decode()}")
    return out[:n].tobytes()


def write_jpeg(path: str, rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(jpeg_bytes(rgb))


# ---------------------------------------------------------------- either

def read_image(path: Source) -> np.ndarray:
    """A PNG or JPEG file, told apart by its signature (not its name), as
    uint8 [H, W, 3] RGB or [H, W, 4] RGBA."""
    data, name = _load(path)
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data, name)
    if data.startswith(JPEG_SIGNATURE):
        return _decode_jpeg(data, name)
    raise ValueError(f"{name}: not a PNG or JPEG file (signature {data[:8]!r})")


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [H, W, 3] in [0, 1] -> uint8, rounded (the JAX package's
    `native.pack_frame`)."""
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255.0 + 0.5).astype(np.uint8)
