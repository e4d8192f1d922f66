"""H.264 decoding on the host (the JAX package decodes with FFmpeg inside
cv2): a ctypes binding of `csrc/h264_decode.cpp`, built at first use into
`build/host/` as `data/image_io.py` builds its codec.

The decoder reads progressive 8-bit 4:2:0 streams of the Baseline, Main
and High profiles (CAVLC and CABAC; I, P and B slices; weighted
prediction; long-term references), as cameras, phones and libx264 write
them, and gives the pictures any conforming decoder gives, bit for bit.
It raises NotImplementedError naming what lies outside that (interlace,
another bit depth or chroma format, slice groups, SP/SI slices, data
partitioning, redundant pictures, gaps in frame_num) and ValueError naming
the sample where the data is malformed; it conceals nothing.

`H264Decoder` takes samples in decoding order and gives frames in output
order (the order of FFmpeg's decoder, which cv2 hands to JAX), cropped;
`to_rgb` converts a frame as cv2's BGR conversion does (swscale's matrix
and range as the stream's VUI signals them).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path
from typing import Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.image_io import BUILD_DIR, CXX_FLAGS, _find_cxx
from genefaceplusplus_tpu_torch.utils.build import compile_libraries, keyed_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "h264_decode.cpp"
_ERR_LEN = 512


def decoder_job() -> Tuple[Path, List[str]]:
    """The library's path in build/host/ (keyed by the source, the compiler's
    path and version, and the flags) and the compiler's command for it, for
    `utils.build.compile_libraries`."""
    cxx = _find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    lib = keyed_library(BUILD_DIR, "h264_decode", [SOURCE.read_bytes(), " ".join((cxx, version, *CXX_FLAGS)).encode()])
    return lib, [cxx, *CXX_FLAGS, str(SOURCE)]


def build_decoder() -> Path:
    """Compile csrc/h264_decode.cpp into build/host/ unless its library exists; returns its path."""
    lib, cmd = decoder_job()
    compile_libraries({lib: cmd})
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_decoder()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gf_h264_open.restype = ptr
    lib.gf_h264_close.argtypes = [ptr]
    lib.gf_h264_decode.argtypes = [ptr, ctypes.c_char_p, i64, i32, ctypes.c_char_p, i32]
    lib.gf_h264_decode.restype = i32
    lib.gf_h264_flush.argtypes = [ptr, ctypes.c_char_p, i32]
    lib.gf_h264_flush.restype = i32
    lib.gf_h264_ready.argtypes = [ptr, ctypes.POINTER(i32)]
    lib.gf_h264_ready.restype = i32
    lib.gf_h264_take.argtypes = [ptr, ptr, ptr, ptr]
    lib.gf_h264_take.restype = i32
    lib.gf_h264_held.argtypes = [ptr]
    lib.gf_h264_held.restype = i32
    lib.gf_h264_cabac_init.argtypes = [ptr]
    return lib


def cabac_init_table() -> np.ndarray:
    """The decoder's CABAC initialisation values [4, 460, 2] (m, n): I
    slices, then cabac_init_idc 0, 1, 2."""
    out = np.zeros((4, 460, 2), np.int8)
    _library().gf_h264_cabac_init(out.ctypes.data)
    return out


class Frame(NamedTuple):
    y: np.ndarray  # [H, W] uint8
    cb: np.ndarray  # [H/2, W/2] uint8
    cr: np.ndarray
    full_range: bool  # the VUI's video_full_range_flag
    matrix: int  # the VUI's matrix_coefficients (2: unspecified)


class H264Decoder:
    """Decodes samples (access units of length-prefixed NAL units) in
    decoding order; `decode` and `flush` return the frames that became
    ready, in output order. `name` prefixes the errors."""

    def __init__(self, nal_length_size: int = 4, name: str = "stream"):
        if nal_length_size not in (1, 2, 4):
            raise ValueError(f"{name}: NAL unit lengths of {nal_length_size} bytes")
        self._lib = _library()
        self._h = self._lib.gf_h264_open()
        self.length_size = nal_length_size
        self.name = name
        self.samples = 0

    def close(self):
        if self._h:
            self._lib.gf_h264_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _check(self, rc: int, err, where: str):
        if rc == 1:
            raise NotImplementedError(f"{self.name}: {where}: {err.value.decode()}")
        if rc:
            raise ValueError(f"{self.name}: {where}: {err.value.decode()}")

    def parameter_set(self, unit: bytes):
        """One SPS or PPS NAL unit (as avcC carries them)."""
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._check(self._lib.gf_h264_decode(self._h, bytes(unit), len(unit), 0, err, _ERR_LEN), err,
                    "a parameter set")

    def _take(self) -> List[Frame]:
        out = []
        info = (ctypes.c_int * 4)()
        while self._lib.gf_h264_ready(self._h, info):  # width, height, full range, matrix
            w, h = info[0], info[1]
            y = np.empty((h, w), np.uint8)
            cb = np.empty((h // 2, w // 2), np.uint8)
            cr = np.empty((h // 2, w // 2), np.uint8)
            self._lib.gf_h264_take(self._h, y.ctypes.data, cb.ctypes.data, cr.ctypes.data)
            out.append(Frame(y, cb, cr, bool(info[2]), int(info[3])))
        return out

    def decode(self, sample: bytes) -> List[Frame]:
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.gf_h264_decode(self._h, bytes(sample), len(sample), self.length_size, err, _ERR_LEN)
        self._check(rc, err, f"sample {self.samples}")
        self.samples += 1
        return self._take()

    def flush(self) -> List[Frame]:
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._check(self._lib.gf_h264_flush(self._h, err, _ERR_LEN), err, "the end of the stream")
        return self._take()

    def held(self) -> int:
        """The pictures the decoder holds: references and those waiting for output."""
        return self._lib.gf_h264_held(self._h)


def decode_frames(samples: Iterable[bytes], parameter_sets: Iterable[bytes] = (), nal_length_size: int = 4,
                  name: str = "stream") -> Iterator[Frame]:
    """Each frame of `samples` (decoding order) in output order, as it becomes ready."""
    dec = H264Decoder(nal_length_size, name)
    try:
        for unit in parameter_sets:
            dec.parameter_set(unit)
        for sample in samples:
            yield from dec.decode(sample)
        yield from dec.flush()
    finally:
        dec.close()


# (Kr, Kb) of the matrices swscale applies, by the VUI's matrix_coefficients (BT.601 otherwise)
_MATRICES = {1: (0.2126, 0.0722)}


@functools.lru_cache(maxsize=None)
def _coefficients(full_range: bool, matrix: int):
    """(luma scale, Cr to R, Cb to G, Cr to G, Cb to B) in 1/256."""
    kr, kb = _MATRICES.get(matrix, (0.299, 0.114))
    kg = 1 - kr - kb
    c = 1.0 if full_range else 255 / 224
    return tuple(int(round(256 * v)) for v in (
        1.0 if full_range else 255 / 219, 2 * (1 - kr) * c, 2 * kb * (1 - kb) / kg * c, 2 * kr * (1 - kr) / kg * c,
        2 * (1 - kb) * c))


def to_rgb(frame: Frame) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a frame, as cv2 converts FFmpeg's frame to
    BGR: each chroma sample over its 2x2 quad, the matrix (BT.601, or
    BT.709 where the VUI names it) and range the stream signals,
    in 8-bit fixed point (for limited-range BT.601, `h264.ycbcr_to_rgb`'s
    integers)."""
    ys, rv, gu, gv, bu = _coefficients(frame.full_range, frame.matrix)
    c = np.repeat(np.repeat(frame.cb.astype(np.int32), 2, 0), 2, 1) - 128
    d = np.repeat(np.repeat(frame.cr.astype(np.int32), 2, 0), 2, 1) - 128
    e = ys * (frame.y.astype(np.int32) - (0 if frame.full_range else 16)) + 128
    rgb = np.stack([(e + rv * d) >> 8, (e - gu * c - gv * d) >> 8, (e + bu * c) >> 8], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
