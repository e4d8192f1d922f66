"""The H.264 intra encoder on the card: `h264_intra` launches
`csrc/h264_intra.cu` (built with nvcc at first use into build/kernels/,
loaded with ctypes) for a CUDA tensor and runs the plain versions,
`data/h264.py:encode_plain` then `frame_slices`, for a CPU one; the kernel
writes their bytes exactly.

`encode_access_units` is what the mp4 writer calls: a chunk of frames to
each frame's access unit (AVCC), the NAL units framed on the device,
compacted by one gather and copied to the host once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from genefaceplusplus_tpu_torch.data import h264
from genefaceplusplus_tpu_torch.ops.fused_field import BUILD_DIR, CSRC, NVCC_FLAGS, _find_nvcc
from genefaceplusplus_tpu_torch.utils.build import compile_libraries, keyed_library

SOURCE = CSRC / "h264_intra.cu"


def kernel_tables() -> List[int]:
    """data/h264.py's tables flattened as the kernel's `gfpp_h264_tables`
    flattens its own (each padded to the kernel's array shape)."""

    def padded(rows, width):
        return [v for r in rows for v in tuple(r) + (0,) * (width - len(r))]

    out = padded(h264.COEFF_TOKEN_LEN, 68) + padded(h264.COEFF_TOKEN_BITS, 68)
    out += list(h264.CHROMA_DC_TOKEN_LEN) + list(h264.CHROMA_DC_TOKEN_BITS)
    out += padded(h264.TOTAL_ZEROS_LEN, 16) + padded(h264.TOTAL_ZEROS_BITS, 16)
    out += padded(h264.CHROMA_DC_TOTAL_ZEROS_LEN, 4) + padded(h264.CHROMA_DC_TOTAL_ZEROS_BITS, 4)
    out += padded(h264.RUN_BEFORE_LEN, 16) + padded(h264.RUN_BEFORE_BITS, 16)
    out += padded(h264.MF, 3) + padded(h264.V, 3) + list(h264.QPC) + list(h264.ZIGZAG)
    return out + [x for x, _ in h264.BLK_XY] + [y for _, y in h264.BLK_XY]


def library_path():
    """build/kernels/libh264_intra-<key>.so, keyed by the source and flags."""
    return keyed_library(BUILD_DIR, "h264_intra", [SOURCE.read_bytes(), " ".join(NVCC_FLAGS).encode()])


def build() -> str:
    """Compile csrc/h264_intra.cu where it is not built yet (nvcc's -Xptxas
    -v report beside it as .log); returns the library's path."""
    lib = library_path()
    if not lib.exists():
        compile_libraries({lib: [_find_nvcc("the H.264 encoder"), *NVCC_FLAGS, str(SOURCE)]}, keep_log=True)
    return str(lib)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.gfpp_h264_intra.argtypes = [ptr, c_int, c_int, c_int, c_int, c_int, c_int, ptr, c_int, c_int, ptr, ptr]
    lib.gfpp_h264_intra.restype = c_int
    lib.gfpp_h264_plan.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.gfpp_h264_plan.restype = c_int
    lib.gfpp_h264_tables.argtypes = [ctypes.POINTER(c_int), c_int]
    lib.gfpp_h264_tables.restype = c_int
    lib.gfpp_cuda_error_string.argtypes = [c_int]
    lib.gfpp_cuda_error_string.restype = ctypes.c_char_p
    want = kernel_tables()
    got = (c_int * len(want))()
    if lib.gfpp_h264_tables(got, len(want)) != len(want) or list(got) != want:
        raise RuntimeError("csrc/h264_intra.cu's tables differ from data/h264.py's")
    return lib


def h264_intra(frames: torch.Tensor, first_index: int = 0, qp: int = h264.QP):
    """[B, H, W, 3] uint8 RGB frames (frame b is picture first_index + b of
    the clip) -> (units [B * mb_rows, unit_bytes] uint8: each slice's NAL
    unit as the file holds it, AVCC length first, from the start of its
    row (the bytes past it unspecified; on the card a view of wider rows
    where the kernel keeps a slice's words there, past the unit: frames too
    wide for them in shared memory); lengths [B * mb_rows] int32, each
    unit's bytes), on the frames' device: the kernel for a CUDA tensor,
    `encode_plain` and `frame_slices` for a CPU one.
    `h264_intra.launches` counts kernel launches."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"h264_intra: frames must be [B, H, W, 3] uint8, got {frames.dtype} {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        enc = h264.encode_plain(frames, first_index, qp)
        return h264.frame_slices(enc.rows, enc.bits)
    if frames.device.type != "cuda":
        raise ValueError(f"h264_intra: unsupported device {frames.device}")
    if not 0 <= qp <= 51:
        raise ValueError(f"h264_intra: qp {qp} outside 0..51")
    B, H, W, _ = frames.shape
    h264.padded_size(H, W)  # raises for an odd size
    frames = frames.contiguous()
    slices, unit, words = B * ((H + 15) // 16), h264.unit_bytes(W), h264.row_bytes(W) // 4
    lengths = torch.empty(slices, dtype=torch.int32, device=frames.device)
    if B == 0:
        return torch.empty((0, unit), dtype=torch.uint8, device=frames.device), lengths
    lib = _library()
    with torch.cuda.device(frames.device):
        shared = ctypes.c_int()
        rc = lib.gfpp_h264_plan(W, words, ctypes.byref(shared))
        if rc == 0:
            words_at = -1 if shared.value else unit  # else the words follow the unit in its row
            rows = torch.empty((slices, unit + (0 if shared.value else (4 * words + 15) // 16 * 16)),
                               dtype=torch.uint8, device=frames.device)
            rc = lib.gfpp_h264_intra(frames.data_ptr(), B, H, W, int(first_index), int(qp), words, rows.data_ptr(),
                                     rows.shape[1], words_at, lengths.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    if rc == -2:
        raise ValueError(f"h264_intra: frames {W} wide need more shared memory a block than the card gives")
    if rc != 0:
        raise RuntimeError(f"h264_intra kernel launch failed: CUDA error {rc} "
                           f"({lib.gfpp_cuda_error_string(rc).decode()})")
    h264_intra.launches += 1
    return rows[:, :unit], lengths


h264_intra.launches = 0


def copy_units(units: torch.Tensor, lengths: torch.Tensor) -> bytes:
    """The units' bytes, each row's first `lengths`, one after another: one
    gather on their device and one copy to the host."""
    keep = torch.arange(units.shape[1], device=units.device)[None, :] < lengths[:, None]
    return units[keep].cpu().numpy().tobytes()


def split_access_units(data: bytes, frames: int) -> List[bytes]:
    """Each frame's access unit of `copy_units`' bytes: the frames' slices
    in order, as many a frame, each unit led by its 4-byte length."""
    ends, at = [], 0
    while at < len(data):
        at += 4 + int.from_bytes(data[at:at + 4], "big")
        ends.append(at)
    if at != len(data) or (len(ends) % frames if frames else ends):
        raise ValueError(f"{len(data)} bytes are not whole units of {frames} frames")
    bounds = [0] + ends[len(ends) // frames - 1::len(ends) // frames] if frames else []
    return [data[a:b] for a, b in zip(bounds, bounds[1:])]


def encode_access_units(frames: torch.Tensor, first_index: int = 0) -> List[bytes]:
    """Each frame's access unit (AVCC) of a [B, H, W, 3] uint8 chunk, encoded
    and framed on the chunk's device."""
    units, lengths = h264_intra(frames, first_index)
    return split_access_units(copy_units(units, lengths), frames.shape[0])
