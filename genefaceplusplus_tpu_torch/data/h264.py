"""H.264 intra coding for the port's mp4 output: the plain version of the
encoder, the parameter sets, the framing, and a decoder for exactly the
subset that the port writes.

The JAX package writes mp4 through libx264 (imageio) or cv2's mp4v
(`genefaceplusplus_tpu/data/video.py`); the port writes H.264 itself. The
subset is one that every decoder reads: Constrained Baseline (profile 66
with constraint_set1), CAVLC, every picture an IDR picture, one slice per
macroblock row, deblocking off, and each macroblock Intra 16x16 (DC, or
Horizontal from the left neighbour, chosen by SAD; DC-128 at the start of a
row; chroma DC or Horizontal alike) or, where its coded bits would exceed
its PCM size, I_PCM. The I_PCM escape bounds every row's bits, so a row
fits a buffer of `row_bytes`. With deblocking off the encoder's
reconstruction is the decoded picture.

The pixel stages of `encode_plain` run in PyTorch on [B, H, W, 3] uint8
(on the tensor's device), the macroblocks of every row of every frame side
by side and the columns one after another; the bit writer is plain Python
over the levels. All arithmetic is integer: `ops/h264_encode.py`'s kernel
(`csrc/h264_intra.cu`) writes the same bytes. `encode_plain` gives each
slice's RBSP (slice header, macroblocks, trailing bits) in a row of
`row_bytes` zero padded bytes and its length in bits; `access_units` adds
the NAL header, emulation prevention and the 4-byte AVCC lengths, each
frame's slices one after another. The kernel frames the slices itself and
writes them in `frame_slices`' layout; `cavlc_bits` is the length-only
CAVLC its macroblock chain counts.

`decode_own` parses such access units with the SPS and PPS and rebuilds
the picture as the standard's decoding process does (ITU-T H.264 8.3.1.2,
8.3.4, 8.5); it raises NotImplementedError naming any feature outside the
subset.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

QP = 22  # the one quantiser of every macroblock (the slice QP; mb_qp_delta is 0)
FPS = 25
PCM_BITS = 384 * 8  # a 4:2:0 macroblock's samples; more coded bits than this take the I_PCM escape
HEADER_MAX_BITS = 96  # a slice header, first_mb_in_slice included
MB_MAX_BITS = 9 + 7 + PCM_BITS  # I_PCM: mb_type, alignment, samples
NAL_IDR, NAL_SPS, NAL_PPS = 5, 7, 8

# raster index (y * 4 + x) of each position of the 4x4 zig-zag scan
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
# (x, y) in 4x4 blocks of luma4x4BlkIdx 0..15 (8x8 quadrants in z order)
BLK_XY = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
          (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3))
# the forward quantiser's multipliers and the dequantiser's normAdjust, by
# QP % 6 and position class: (0,0)-like, (1,1)-like, the rest
MF = ((13107, 5243, 8066), (11916, 4660, 7490), (10082, 4194, 6554),
      (9362, 3647, 5825), (8192, 3355, 5243), (7282, 2893, 4559))
V = ((10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18), (16, 25, 20), (18, 29, 23))
QPC = (29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39)
# Table A-1: level_idc, MaxMBPS, MaxFS
LEVELS = ((10, 1485, 99), (11, 3000, 396), (12, 6000, 396), (13, 11880, 396), (20, 11880, 396),
          (21, 19800, 792), (22, 20250, 1620), (30, 40500, 1620), (31, 108000, 3600), (32, 216000, 5120),
          (40, 245760, 8192), (42, 522240, 8704), (50, 589824, 22080), (51, 983040, 36864),
          (52, 2073600, 36864))


def chroma_qp(qp: int) -> int:
    return qp if qp < 30 else QPC[qp - 30]


def pos_class(i: int, j: int) -> int:
    """The quantiser class of 4x4 position (row i, column j)."""
    return 0 if i % 2 == 0 and j % 2 == 0 else (1 if i % 2 == 1 and j % 2 == 1 else 2)


# ---------------------------------------------------------------------------
# CAVLC tables (ITU-T H.264 Tables 9-5, 9-7, 9-8, 9-9a, 9-10), as (length,
# value) indexed [TotalCoeff * 4 + TrailingOnes]
# ---------------------------------------------------------------------------

COEFF_TOKEN_LEN = (
    (1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9,
     13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15,
     16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16),
    (2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6,
     11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13,
     13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14),
    (4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4,
     8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10),
    tuple(6 if t1 <= min(tc, 3) else 0 for tc in range(17) for t1 in range(4)),  # nC >= 8: 6-bit codes
)
COEFF_TOKEN_BITS = (
    (1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4,
     8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12,
     11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8),
    (3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4,
     11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12,
     7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4),
    (15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9,
     8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8,
     13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2),
    tuple((3 if t1 == 0 else 0) if tc == 0 else ((tc - 1) << 2) | t1 for tc in range(17) for t1 in range(4)),
)
CHROMA_DC_TOKEN_LEN = (2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7)
CHROMA_DC_TOKEN_BITS = (1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0)
TOTAL_ZEROS_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9), (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6), (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5), (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6), (6, 5, 3, 3, 3, 2, 3, 4, 3, 6),
    (6, 4, 5, 3, 2, 2, 3, 3, 6), (6, 6, 4, 2, 2, 3, 2, 5), (5, 5, 3, 2, 2, 2, 4), (4, 4, 3, 3, 1, 3),
    (4, 4, 2, 1, 3), (3, 3, 1, 2), (2, 2, 1), (1, 1))
TOTAL_ZEROS_BITS = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1), (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0), (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0), (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0), (1, 1, 5, 4, 3, 3, 2, 1, 1, 0),
    (1, 1, 1, 3, 3, 2, 2, 1, 0), (1, 0, 1, 3, 2, 1, 1, 1), (1, 0, 1, 3, 2, 1, 1), (0, 1, 1, 2, 1, 3),
    (0, 1, 1, 1, 1), (0, 1, 1, 1), (0, 1, 1), (0, 1))
CHROMA_DC_TOTAL_ZEROS_LEN = ((1, 2, 3, 3), (1, 2, 2), (1, 1))
CHROMA_DC_TOTAL_ZEROS_BITS = ((1, 1, 1, 0), (1, 1, 0), (1, 0))
RUN_BEFORE_LEN = ((1, 1), (1, 2, 2), (2, 2, 2, 2), (2, 2, 2, 3, 3), (2, 2, 3, 3, 3, 3), (2, 3, 3, 3, 3, 3, 3),
                  (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11))
RUN_BEFORE_BITS = ((1, 0), (1, 1, 0), (3, 2, 1, 0), (3, 2, 1, 1, 0), (3, 2, 3, 2, 1, 0), (3, 0, 1, 3, 2, 5, 4),
                   (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1))


def _code(n: int, v: int) -> str:
    return format(v, f"0{n}b") if n else ""


# the same tables as bit strings
_TOKEN = [[_code(n, v) for n, v in zip(ln, bits)] for ln, bits in zip(COEFF_TOKEN_LEN, COEFF_TOKEN_BITS)]
_TOKEN_DC = [_code(n, v) for n, v in zip(CHROMA_DC_TOKEN_LEN, CHROMA_DC_TOKEN_BITS)]
_TZ = [None] + [[_code(n, v) for n, v in zip(ln, bits)] for ln, bits in zip(TOTAL_ZEROS_LEN, TOTAL_ZEROS_BITS)]
_TZ_DC = [None] + [[_code(n, v) for n, v in zip(ln, bits)]
                   for ln, bits in zip(CHROMA_DC_TOTAL_ZEROS_LEN, CHROMA_DC_TOTAL_ZEROS_BITS)]
_RUN = [None] + [[_code(n, v) for n, v in zip(ln, bits)] for ln, bits in zip(RUN_BEFORE_LEN, RUN_BEFORE_BITS)]


def token_table(nc: int) -> int:
    """coeff_token's table for nC >= 0 (Table 9-5's columns)."""
    return 0 if nc < 2 else (1 if nc < 4 else (2 if nc < 8 else 3))


def ue(v: int) -> str:
    v += 1
    n = v.bit_length()
    return "0" * (n - 1) + format(v, "b")


def se(v: int) -> str:
    return ue(2 * v - 1 if v > 0 else -2 * v)


def residual_block(coeffs: Sequence[int], nc: int, max_coeff: int) -> Optional[str]:
    """CAVLC residual_block() of `coeffs` (the block's levels in scan order,
    `max_coeff` of them) as a bit string; nc -1 is the 4:2:0 chroma DC.
    None where a level is too large for Baseline's level_prefix <= 15."""
    nz = [i for i, c in enumerate(coeffs) if c]
    tc = len(nz)
    tokens = _TOKEN_DC if nc < 0 else _TOKEN[token_table(nc)]
    if tc == 0:
        return tokens[0]
    rev = [coeffs[i] for i in reversed(nz)]  # highest frequency first
    t1 = 0
    while t1 < 3 and t1 < tc and (rev[t1] == 1 or rev[t1] == -1):
        t1 += 1
    parts = [tokens[tc * 4 + t1]]
    parts += ["1" if rev[k] < 0 else "0" for k in range(t1)]
    suffix_len = 1 if tc > 10 and t1 < 3 else 0
    for k in range(t1, tc):
        level = rev[k]
        code = 2 * level - 2 if level > 0 else -2 * level - 1
        if k == t1 and t1 < 3:
            code -= 2
        if suffix_len == 0:
            if code < 14:
                parts.append("0" * code + "1")
            elif code < 30:
                parts.append("000000000000001" + format(code - 14, "04b"))
            elif code < 30 + 4096:
                parts.append("0000000000000001" + format(code - 30, "012b"))
            else:
                return None
        elif code < (15 << suffix_len):
            parts.append("0" * (code >> suffix_len) + "1" + format(code & ((1 << suffix_len) - 1), f"0{suffix_len}b"))
        elif code - (15 << suffix_len) < 4096:
            parts.append("0000000000000001" + format(code - (15 << suffix_len), "012b"))
        else:
            return None
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    total_zeros = nz[-1] + 1 - tc
    if tc < max_coeff:
        parts.append((_TZ_DC if nc < 0 else _TZ)[tc][total_zeros])
    zeros_left = total_zeros
    for k in range(tc - 1):
        if zeros_left == 0:
            break
        run = nz[tc - 1 - k] - nz[tc - 2 - k] - 1
        parts.append(_RUN[min(zeros_left, 7)][run])
        zeros_left -= run
    return "".join(parts)


def cavlc_bits(coeffs: Sequence[int], nc: int, max_coeff: int) -> Optional[int]:
    """The length in bits of `residual_block(coeffs, nc, max_coeff)`,
    counted without writing it (what the kernel's chain counts to decide
    the I_PCM escape): None where `residual_block` is None."""
    nz = [i for i, c in enumerate(coeffs) if c]
    tc = len(nz)
    lens = CHROMA_DC_TOKEN_LEN if nc < 0 else COEFF_TOKEN_LEN[token_table(nc)]
    if tc == 0:
        return lens[0]
    rev = [coeffs[i] for i in reversed(nz)]
    t1 = 0
    while t1 < 3 and t1 < tc and abs(rev[t1]) == 1:
        t1 += 1
    n = lens[tc * 4 + t1] + t1
    suffix_len = 1 if tc > 10 and t1 < 3 else 0
    for k in range(t1, tc):
        level = rev[k]
        code = (2 * level - 2 if level > 0 else -2 * level - 1) - (2 if k == t1 and t1 < 3 else 0)
        if suffix_len == 0:
            if code >= 30 + 4096:
                return None
            n += code + 1 if code < 14 else (19 if code < 30 else 28)
        elif code < (15 << suffix_len):
            n += (code >> suffix_len) + 1 + suffix_len
        elif code - (15 << suffix_len) < 4096:
            n += 28
        else:
            return None
        suffix_len = max(suffix_len, 1)
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    total_zeros = nz[-1] + 1 - tc
    if tc < max_coeff:
        n += (CHROMA_DC_TOTAL_ZEROS_LEN if nc < 0 else TOTAL_ZEROS_LEN)[tc - 1][total_zeros]
    for k in range(tc - 1):  # run_before while zeros are left below the coefficient
        zeros_left = nz[tc - 1 - k] - (tc - 1 - k)
        if zeros_left == 0:
            break
        n += RUN_BEFORE_LEN[min(zeros_left, 7) - 1][nz[tc - 1 - k] - nz[tc - 2 - k] - 1]
    return n


# ---------------------------------------------------------------------------
# Colour: integer BT.601 limited range (swscale's matrix), 4:2:0 from the
# sum of each 2x2 quad
# ---------------------------------------------------------------------------

def padded_size(height: int, width: int) -> Tuple[int, int]:
    if height % 2 or width % 2 or height < 2 or width < 2:
        raise ValueError(f"{height}x{width}: 4:2:0 H.264 needs an even height and width")
    return (height + 15) // 16 * 16, (width + 15) // 16 * 16


def rgb_to_ycbcr(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] uint8 RGB -> Y [B, Hp, Wp], Cb and Cr [B, Hp/2, Wp/2]
    int32, padded to whole macroblocks by repeating the edge pixels."""
    B, H, W, _ = frames.shape
    Hp, Wp = padded_size(H, W)
    dev = frames.device
    rows = torch.arange(Hp, device=dev).clamp(max=H - 1)
    cols = torch.arange(Wp, device=dev).clamp(max=W - 1)
    x = frames.index_select(1, rows).index_select(2, cols).to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16

    def quads(c):
        return c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]

    rs, gs, bs = quads(r), quads(g), quads(b)
    cb = ((-38 * rs - 74 * gs + 112 * bs + 512) >> 10) + 128
    cr = ((112 * rs - 94 * gs - 18 * bs + 512) >> 10) + 128
    return y, cb, cr


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The port's inverse conversion: [H, W] Y and [H/2, W/2] Cb, Cr (each
    chroma sample over its 2x2 quad) -> [H, W, 3] uint8 RGB."""
    c = np.repeat(np.repeat(cb.astype(np.int32), 2, 0), 2, 1) - 128
    d = np.repeat(np.repeat(cr.astype(np.int32), 2, 0), 2, 1) - 128
    e = 298 * (y.astype(np.int32) - 16) + 128
    rgb = np.stack([(e + 409 * d) >> 8, (e - 100 * c - 208 * d) >> 8, (e + 516 * c) >> 8], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def luma(frames: np.ndarray) -> np.ndarray:
    """The Y plane [.., H, W] int32 of uint8 RGB [.., H, W, 3], as the encoder converts."""
    x = frames.astype(np.int32)
    return ((66 * x[..., 0] + 129 * x[..., 1] + 25 * x[..., 2] + 128) >> 8) + 16


# ---------------------------------------------------------------------------
# Transforms and quantisation (integer, on tensors of [..., 4, 4])
# ---------------------------------------------------------------------------

def _fwd1(a, b, c, d):
    s03, d03, s12, d12 = a + d, a - d, b + c, b - c
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def forward4x4(x: torch.Tensor) -> torch.Tensor:
    """The core transform Cf X Cf^T of each [4, 4] (rows i = y, columns j = x)."""
    x = torch.stack(_fwd1(*x.unbind(-1)), -1)  # along each row
    return torch.stack(_fwd1(*x.unbind(-2)), -2)  # along each column


def _inv1(a, b, c, d):
    e0, e1, e2, e3 = a + c, a - c, (b >> 1) - d, b + (d >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def inverse4x4(d: torch.Tensor) -> torch.Tensor:
    """8.5.12.2: rows first, then columns, then (h + 32) >> 6."""
    f = torch.stack(_inv1(*d.unbind(-1)), -1)
    h = torch.stack(_inv1(*f.unbind(-2)), -2)
    return (h + 32) >> 6


def hadamard4(x: torch.Tensor) -> torch.Tensor:
    def h1(a, b, c, d):
        return a + b + c + d, a + b - c - d, a - b - c + d, a - b + c - d

    x = torch.stack(h1(*x.unbind(-1)), -1)
    return torch.stack(h1(*x.unbind(-2)), -2)


def hadamard2(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d = x[..., 0, 0], x[..., 0, 1], x[..., 1, 0], x[..., 1, 1]
    return torch.stack([torch.stack([a + b + c + d, a - b + c - d], -1),
                        torch.stack([a + b - c - d, a - b - c + d], -1)], -2)


def _class_table(table, m: int, dev) -> torch.Tensor:
    return torch.tensor([[table[m][pos_class(i, j)] for j in range(4)] for i in range(4)], dtype=torch.int32,
                        device=dev)


def quantise(w: torch.Tensor, mf, qbits: int, off: int) -> torch.Tensor:
    return torch.sign(w) * ((w.abs() * mf + off) >> qbits)


def scale_ac(c: torch.Tensor, qp: int) -> torch.Tensor:
    """8.5.12.1 with flat scaling matrices (LevelScale4x4 = 16 normAdjust)."""
    ls = 16 * _class_table(V, qp % 6, c.device)
    q = qp // 6
    return (c * ls) << (q - 4) if q >= 4 else (c * ls + (1 << (3 - q))) >> (4 - q)


def scale_luma_dc(f: torch.Tensor, qp: int) -> torch.Tensor:
    ls, q = 16 * V[qp % 6][0], qp // 6
    return (f * ls) << (q - 6) if q >= 6 else (f * ls + (1 << (5 - q))) >> (6 - q)


def scale_chroma_dc(f: torch.Tensor, qpc: int) -> torch.Tensor:
    return ((f * (16 * V[qpc % 6][0])) << (qpc // 6)) >> 5


# ---------------------------------------------------------------------------
# The plain encoder
# ---------------------------------------------------------------------------

class Encoded(NamedTuple):
    rows: torch.Tensor  # [B * mb_rows, row_bytes] uint8: each slice's RBSP, zero padded
    bits: torch.Tensor  # [B * mb_rows] int32: each RBSP's length in bits (whole bytes)
    recon: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # Y, Cb, Cr as decoded, padded


def row_bytes(width: int) -> int:
    """The bytes of a slice buffer: the header, every macroblock at its
    I_PCM bound and the trailing bits, in whole 32-bit words."""
    mbw = (width + 15) // 16
    return (HEADER_MAX_BITS + mbw * MB_MAX_BITS + 8 + 31) // 32 * 4


def unit_bytes(width: int) -> int:
    """The bytes of a row of `frame_slices`' output: the 4-byte AVCC length,
    the NAL header byte and a slice of `row_bytes` whose emulation
    prevention inserts at most one byte every two, in whole 16 bytes."""
    return _unit_stride(row_bytes(width))


def _unit_stride(rbsp_bytes: int) -> int:
    return (5 + rbsp_bytes * 3 // 2 + 15) // 16 * 16


def slice_header(first_mb: int, idr_pic_id: int, qp: int = QP) -> str:
    """slice_header() of an IDR I slice under `sps_pps`' parameter sets."""
    return (ue(first_mb) + ue(7) + ue(0) + "0000" + ue(idr_pic_id) + "00" + se(qp - 26) + ue(1))


def _mb_bits(mode: int, cmode: int, dc: list, ac: list, cdc: list, cac: list,
             nnz_left: Optional[list], cnnz_left: Optional[list]) -> Tuple[Optional[str], list, list]:
    """One Intra 16x16 macroblock's bits (None: a level Baseline cannot
    code), with the AC totals of its blocks (by (x, y) in 4x4 blocks, and
    per chroma component by (x, y) in a 2x2) that the next one's nC reads.
    `nnz_left`: the left macroblock's totals of its right column (4 luma,
    2 + 2 chroma), None at the start of a row."""
    nnz = [sum(1 for v in ac[b] if v) for b in range(16)]
    counts = [[0] * 4 for _ in range(4)]  # [y][x]
    for b, (x, y) in enumerate(BLK_XY):
        counts[y][x] = nnz[b]
    cbp_luma = 15 if any(nnz) else 0
    ccounts = [[[sum(1 for v in cac[c][2 * y + x] if v) for x in range(2)] for y in range(2)] for c in range(2)]
    any_cac = any(ccounts[c][y][x] for c in range(2) for y in range(2) for x in range(2))
    cbp_chroma = 2 if any_cac else (1 if any(v for c in range(2) for v in cdc[c]) else 0)
    mb_type = 1 + mode + 4 * cbp_chroma + (12 if cbp_luma else 0)
    parts = [ue(mb_type), ue(cmode), "1"]  # mb_qp_delta 0

    def nc(n_a, n_b):
        if n_a is not None and n_b is not None:
            return (n_a + n_b + 1) >> 1
        return n_a if n_a is not None else (n_b if n_b is not None else 0)

    def luma_nc(x, y):
        n_a = counts[y][x - 1] if x > 0 else (nnz_left[y] if nnz_left is not None else None)
        n_b = counts[y - 1][x] if y > 0 else None
        return nc(n_a, n_b)

    blocks = [residual_block(dc, luma_nc(0, 0), 16)]
    if cbp_luma:
        blocks += [residual_block(ac[b], luma_nc(*BLK_XY[b]), 15) for b in range(16)]
    if cbp_chroma:
        blocks += [residual_block(cdc[c], -1, 4) for c in range(2)]
    if cbp_chroma == 2:
        for c in range(2):
            for b in range(4):
                x, y = b % 2, b // 2
                n_a = ccounts[c][y][x - 1] if x > 0 else (cnnz_left[c][y] if cnnz_left is not None else None)
                n_b = ccounts[c][y - 1][x] if y > 0 else None
                blocks.append(residual_block(cac[c][b], nc(n_a, n_b), 15))
    if any(b is None for b in blocks):
        return None, counts, ccounts
    return "".join(parts + blocks), counts, ccounts


def _pcm_bits(pos: int, y: list, cb: list, cr: list) -> str:
    """I_PCM at bit `pos` of the slice: mb_type 25, the alignment, the samples."""
    head = ue(25)
    pad = (-(pos + len(head))) % 8
    return head + "0" * pad + "".join(format(v, "08b") for v in y + cb + cr)


def _bits_to_row(bits: str, nbytes: int) -> np.ndarray:
    n = len(bits) // 8
    out = np.zeros(nbytes, np.uint8)
    if n:
        out[:n] = np.frombuffer(int(bits, 2).to_bytes(n, "big"), np.uint8)
    return out


def encode_plain(frames: torch.Tensor, first_index: int = 0, qp: int = QP) -> Encoded:
    """The plain version of the `h264_intra` kernel: [B, H, W, 3] uint8 RGB
    frames (frame b is picture first_index + b of the clip: its idr_pic_id
    is that parity) -> each slice's RBSP and bit length, and the
    reconstruction. The pixel stages run on the tensor's device."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [B, H, W, 3] uint8, got {frames.dtype} {tuple(frames.shape)}")
    B, H, W, _ = frames.shape
    Hp, Wp = padded_size(H, W)
    mbh, mbw = Hp // 16, Wp // 16
    S, dev = B * mbh, frames.device
    y, cb, cr = rgb_to_ycbcr(frames)
    Y = y.reshape(B, mbh, 16, Wp).reshape(S, 16, Wp)
    C = torch.stack([cb, cr], 1).reshape(B, 2, mbh, 8, Wp // 2).transpose(1, 2).reshape(S, 2, 8, Wp // 2)
    recY, recC = torch.empty_like(Y), torch.empty_like(C)
    qpc = chroma_qp(qp)
    qbits, qbits_c = 15 + qp // 6, 15 + qpc // 6
    mf, mf_c = _class_table(MF, qp % 6, dev), _class_table(MF, qpc % 6, dev)
    zz = torch.tensor(ZIGZAG, device=dev)
    blk = torch.tensor([y_ * 4 + x_ for x_, y_ in BLK_XY], device=dev)
    streams = [slice_header((s % mbh) * mbw, (first_index + s // mbh) & 1, qp) for s in range(S)]
    parts = [[h] for h in streams]
    pos = [len(h) for h in streams]
    nnz_left: List[Optional[list]] = [None] * S
    cnnz_left: List[Optional[list]] = [None] * S
    for mx in range(mbw):
        sy = Y[:, :, 16 * mx:16 * mx + 16]
        sc = C[:, :, :, 8 * mx:8 * mx + 8]
        if mx == 0:
            pred_y = torch.full_like(sy, 128)
            pred_c = torch.full_like(sc, 128)
            use_h = use_hc = torch.zeros(S, dtype=torch.bool, device=dev)
        else:
            left_y, left_c = recY[:, :, 16 * mx - 1], recC[:, :, :, 8 * mx - 1]
            dc_y = ((left_y.sum(1) + 8) >> 4)[:, None, None].expand(S, 16, 16)
            h_y = left_y[:, :, None].expand(S, 16, 16)
            use_h = (sy - h_y).abs().sum((1, 2)) < (sy - dc_y).abs().sum((1, 2))
            pred_y = torch.where(use_h[:, None, None], h_y, dc_y)
            dc_c = ((left_c.reshape(S, 2, 2, 4).sum(-1) + 2) >> 2).repeat_interleave(4, -1)[..., None].expand(S, 2, 8, 8)
            h_c = left_c[..., None].expand(S, 2, 8, 8)
            use_hc = (sc - h_c).abs().sum((1, 2, 3)) < (sc - dc_c).abs().sum((1, 2, 3))
            pred_c = torch.where(use_hc[:, None, None, None], h_c, dc_c)
        # luma: [S, by, bx, 4, 4] blocks, their DCs through the Hadamard
        w = forward4x4((sy - pred_y).reshape(S, 4, 4, 4, 4).transpose(2, 3))
        dc = quantise(hadamard4(w[..., 0, 0]) >> 1, MF[qp % 6][0], qbits + 1, (1 << (qbits + 1)) // 3)
        ac = quantise(w, mf, qbits, (1 << qbits) // 3)
        ac[..., 0, 0] = 0
        # chroma: [S, 2, by, bx, 4, 4]
        wc = forward4x4((sc - pred_c).reshape(S, 2, 2, 4, 2, 4).transpose(3, 4))
        cdc = quantise(hadamard2(wc[..., 0, 0]), MF[qpc % 6][0], qbits_c + 1, (1 << (qbits_c + 1)) // 3)
        cac = quantise(wc, mf_c, qbits_c, (1 << qbits_c) // 3)
        cac[..., 0, 0] = 0
        # reconstruction, as the decoder does it
        d = scale_ac(ac, qp)
        d[..., 0, 0] = scale_luma_dc(hadamard4(dc), qp)
        rec_y = (pred_y + inverse4x4(d).transpose(2, 3).reshape(S, 16, 16)).clamp(0, 255)
        dcn = scale_ac(cac, qpc)
        dcn[..., 0, 0] = scale_chroma_dc(hadamard2(cdc), qpc)
        rec_c = (pred_c + inverse4x4(dcn).transpose(3, 4).reshape(S, 2, 8, 8)).clamp(0, 255)
        # the bits, and the I_PCM escape
        dc_l = dc.reshape(S, 16)[:, zz].tolist()
        ac_l = ac.reshape(S, 16, 16)[:, blk][:, :, zz[1:]].tolist()
        cdc_l = cdc.reshape(S, 2, 4).tolist()
        cac_l = cac.reshape(S, 2, 4, 16)[:, :, :, zz[1:]].tolist()
        modes, cmodes = torch.where(use_h, 1, 2).tolist(), use_hc.to(torch.int64).tolist()
        pcm = []
        src_l = sy.reshape(S, 256).tolist(), sc.reshape(S, 2, 64).tolist()
        for s in range(S):
            bits, counts, ccounts = _mb_bits(modes[s], cmodes[s], dc_l[s], ac_l[s], cdc_l[s], cac_l[s],
                                             nnz_left[s], cnnz_left[s])
            if bits is None or len(bits) > PCM_BITS:
                bits = _pcm_bits(pos[s], src_l[0][s], src_l[1][s][0], src_l[1][s][1])
                nnz_left[s], cnnz_left[s] = [16] * 4, [[16] * 2, [16] * 2]
                pcm.append(s)
            else:
                nnz_left[s] = [counts[y_][3] for y_ in range(4)]
                cnnz_left[s] = [[ccounts[c][y_][1] for y_ in range(2)] for c in range(2)]
            parts[s].append(bits)
            pos[s] += len(bits)
        if pcm:
            esc = torch.zeros(S, dtype=torch.bool, device=dev)
            esc[torch.tensor(pcm, device=dev)] = True
            rec_y = torch.where(esc[:, None, None], sy, rec_y)
            rec_c = torch.where(esc[:, None, None, None], sc, rec_c)
        recY[:, :, 16 * mx:16 * mx + 16] = rec_y
        recC[:, :, :, 8 * mx:8 * mx + 8] = rec_c
    nbytes = row_bytes(W)
    rows, lengths = np.zeros((S, nbytes), np.uint8), np.zeros(S, np.int32)
    for s in range(S):
        bits = "".join(parts[s]) + "1"
        bits += "0" * ((-len(bits)) % 8)
        rows[s] = _bits_to_row(bits, nbytes)
        lengths[s] = len(bits)
    rec = (recY.reshape(B, Hp, Wp), recC[:, 0].reshape(B, Hp // 2, Wp // 2), recC[:, 1].reshape(B, Hp // 2, Wp // 2))
    return Encoded(torch.from_numpy(rows).to(dev), torch.from_numpy(lengths).to(dev), rec)


# ---------------------------------------------------------------------------
# Parameter sets and framing
# ---------------------------------------------------------------------------

def level_idc(height: int, width: int, fps: int = FPS) -> int:
    """The least level of Table A-1 whose MaxFS, MaxMBPS and frame
    dimensions (each at most sqrt(8 MaxFS) macroblocks) take the size."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    for level, max_mbps, max_fs in LEVELS:
        if mbw * mbh <= max_fs and mbw * mbh * fps <= max_mbps and max(mbw, mbh) ** 2 <= 8 * max_fs:
            return level
    raise ValueError(f"{width}x{height} at {fps} fps exceeds H.264 level 5.2")


def _rbsp(bits: str) -> bytes:
    bits += "1"
    bits += "0" * ((-len(bits)) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 after every two zero bytes that a byte <= 3 follows."""
    return re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp)


def remove_emulation_prevention(ebsp: bytes) -> bytes:
    return re.sub(b"\x00\x00\x03", b"\x00\x00", ebsp)


def nal(nal_type: int, rbsp: bytes) -> bytes:
    return bytes([0x60 | nal_type]) + emulation_prevention(rbsp)  # nal_ref_idc 3


def sps_pps(height: int, width: int, fps: int = FPS) -> Tuple[bytes, bytes]:
    """The SPS and PPS NAL units: Constrained Baseline, POC type 2, frame
    cropping where the size is not whole macroblocks, a VUI stating BT.601
    limited range and `fps`; CAVLC, deblocking control present."""
    Hp, Wp = padded_size(height, width)
    level = level_idc(height, width, fps)
    sps = format(66, "08b") + "01000000" + format(level, "08b") + ue(0) + ue(0) + ue(2) + ue(1) + "0"
    sps += ue(Wp // 16 - 1) + ue(Hp // 16 - 1) + "1" + "1"
    if (Hp, Wp) != (height, width):
        sps += "1" + ue(0) + ue((Wp - width) // 2) + ue(0) + ue((Hp - height) // 2)
    else:
        sps += "0"
    sps += "1"  # vui_parameters_present_flag
    sps += "0" + "0"  # aspect ratio, overscan
    sps += "1" + "101" + "0" + "1" + format(6, "08b") * 3  # video signal: limited range, SMPTE 170M (BT.601)
    sps += "0"  # chroma location
    sps += "1" + format(1, "032b") + format(2 * fps, "032b") + "1"  # timing: fps = time_scale / 2
    sps += "0" + "0" + "0"  # no HRD, no pic_struct
    sps += "1" + "1" + ue(0) + ue(0) + ue(16) + ue(16) + ue(0) + ue(1)  # no reordering, one frame buffered
    pps = ue(0) + ue(0) + "0" + "0" + ue(0) + ue(0) + ue(0) + "0" + "00" + se(0) + se(0) + se(0) + "1" + "0" + "0"
    return nal(NAL_SPS, _rbsp(sps)), nal(NAL_PPS, _rbsp(pps))


def access_units(rows: torch.Tensor, bits: torch.Tensor, frames: int) -> List[bytes]:
    """Each frame's access unit in AVCC form (4-byte big-endian lengths)
    from the slices' RBSPs (`rows`, `bits`: an encoder's output for
    `frames` frames). Only the slices' bytes leave the device."""
    nbytes = (bits.to(torch.int64) + 7) // 8
    keep = torch.arange(rows.shape[1], device=rows.device)[None, :] < nbytes[:, None]
    data = rows[keep].cpu().numpy().tobytes()
    lengths = nbytes.cpu().tolist()
    per = len(lengths) // frames
    out, at = [], 0
    for f in range(frames):
        au = []
        for n in lengths[f * per:(f + 1) * per]:
            unit = nal(NAL_IDR, data[at:at + n])
            au.append(len(unit).to_bytes(4, "big") + unit)
            at += n
        out.append(b"".join(au))
    return out


def frame_slices(rows: torch.Tensor, bits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel's framing: each slice's RBSP
    (`rows`, `bits`: an encoder's output) as the NAL unit the file holds,
    its 4-byte AVCC length, header byte and emulation-prevented bytes, at
    the start of its row of `unit_bytes` (zeros past it), and each unit's
    bytes (the length included): `access_units` is these, a frame's rows
    one after another."""
    nbytes = ((bits.to(torch.int64) + 7) // 8).tolist()
    data = rows.cpu().numpy()
    units = np.zeros((len(nbytes), _unit_stride(rows.shape[1])), np.uint8)
    lengths = np.zeros(len(nbytes), np.int32)
    for s, n in enumerate(nbytes):
        unit = nal(NAL_IDR, data[s, :n].tobytes())
        framed = np.frombuffer(len(unit).to_bytes(4, "big") + unit, np.uint8)
        units[s, :len(framed)] = framed
        lengths[s] = len(framed)
    return torch.from_numpy(units).to(rows.device), torch.from_numpy(lengths).to(rows.device)


def split_avcc(sample: bytes) -> List[bytes]:
    units, at = [], 0
    while at < len(sample):
        if at + 4 > len(sample):
            raise ValueError("a truncated AVCC length")
        n = int.from_bytes(sample[at:at + 4], "big")
        if n == 0 or at + 4 + n > len(sample):
            raise ValueError(f"an AVCC unit of {n} bytes at {at} runs past the sample's {len(sample)}")
        units.append(sample[at + 4:at + 4 + n])
        at += 4 + n
    return units


# ---------------------------------------------------------------------------
# The decoder of the port's subset
# ---------------------------------------------------------------------------

class _Bits:
    def __init__(self, rbsp: bytes):
        self.s = format(int.from_bytes(rbsp, "big"), f"0{8 * len(rbsp)}b") if rbsp else ""
        self.p = 0

    def u(self, n: int) -> int:
        if self.p + n > len(self.s):
            raise ValueError("read past the end of the RBSP")
        v = int(self.s[self.p:self.p + n], 2) if n else 0
        self.p += n
        return v

    def ue(self) -> int:
        z = self.s.find("1", self.p)
        if z < 0 or z - self.p > 31:
            raise ValueError("a bad Exp-Golomb code")
        n = z - self.p
        self.p = z + 1
        return (1 << n) - 1 + self.u(n)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def more_rbsp_data(self) -> bool:
        last = self.s.rfind("1")
        return self.p < last


def _reverse(table: List[str]) -> dict:
    return {code: i for i, code in enumerate(table) if code}


_TOKEN_R = [_reverse(t) for t in _TOKEN]
_TOKEN_DC_R = _reverse(_TOKEN_DC)
_TZ_R = [None] + [_reverse(t) for t in _TZ[1:]]
_TZ_DC_R = [None] + [_reverse(t) for t in _TZ_DC[1:]]
_RUN_R = [None] + [_reverse(t) for t in _RUN[1:]]


def _vlc(b: _Bits, table: dict, what: str) -> int:
    for n in range(1, 17):
        v = table.get(b.s[b.p:b.p + n])
        if v is not None and b.p + n <= len(b.s):
            b.p += n
            return v
    raise ValueError(f"no {what} code at bit {b.p}")


def read_residual_block(b: _Bits, nc: int, max_coeff: int) -> List[int]:
    """9.2: the levels of one CAVLC residual block in scan order."""
    tc_t1 = _vlc(b, _TOKEN_DC_R if nc < 0 else _TOKEN_R[token_table(nc)], "coeff_token")
    tc, t1 = tc_t1 // 4, tc_t1 % 4
    coeffs = [0] * max_coeff
    if tc == 0:
        return coeffs
    if tc > max_coeff:
        raise ValueError(f"coeff_token: {tc} coefficients in a block of {max_coeff}")
    levels = []
    for _ in range(t1):
        levels.append(-1 if b.u(1) else 1)
    suffix_len = 1 if tc > 10 and t1 < 3 else 0
    for i in range(t1, tc):
        prefix = 0
        while b.u(1) == 0:
            prefix += 1
            if prefix > 15:
                raise NotImplementedError("level_prefix > 15 (not in the Baseline profile)")
        size = 4 if prefix == 14 and suffix_len == 0 else (12 if prefix == 15 else suffix_len)
        code = (min(15, prefix) << suffix_len) + (b.u(size) if size else 0)
        if prefix >= 15 and suffix_len == 0:
            code += 15
        if i == t1 and t1 < 3:
            code += 2
        level = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
        levels.append(level)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    zeros_left = 0
    if tc < max_coeff:
        zeros_left = _vlc(b, (_TZ_DC_R if nc < 0 else _TZ_R)[tc], "total_zeros")
    runs = []
    for i in range(tc - 1):
        run = _vlc(b, _RUN_R[min(zeros_left, 7)], "run_before") if zeros_left > 0 else 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)
    k = -1
    for i in range(tc - 1, -1, -1):
        k += runs[i] + 1
        coeffs[k] = levels[i]
    return coeffs


class Decoded(NamedTuple):
    y: np.ndarray  # [H, W] uint8
    cb: np.ndarray  # [H/2, W/2] uint8
    cr: np.ndarray
    rgb: np.ndarray  # [H, W, 3] uint8, by ycbcr_to_rgb
    pcm: np.ndarray  # [mb_rows, mb_cols] bool: the macroblocks coded as I_PCM


class Sps(NamedTuple):
    height: int
    width: int
    mbh: int
    mbw: int
    log2_max_frame_num: int
    poc_type: int
    log2_max_poc_lsb: int


def parse_sps(unit: bytes) -> Sps:
    if unit[0] & 0x1F != NAL_SPS:
        raise ValueError("not an SPS NAL unit")
    b = _Bits(remove_emulation_prevention(unit[1:]))
    profile = b.u(8)
    b.u(16)
    if profile != 66:
        raise NotImplementedError(f"profile_idc {profile} (the port decodes the Baseline profile, 66)")
    b.ue()
    log2_fn = b.ue() + 4
    poc_type = b.ue()
    lsb = 0
    if poc_type == 0:
        lsb = b.ue() + 4
    elif poc_type == 1:
        raise NotImplementedError("pic_order_cnt_type 1")
    b.ue()
    b.u(1)
    mbw, mbh = b.ue() + 1, b.ue() + 1
    if not b.u(1):
        raise NotImplementedError("field coding (frame_mbs_only_flag 0)")
    b.u(1)
    crop = (0, 0, 0, 0)
    if b.u(1):
        crop = (b.ue(), b.ue(), b.ue(), b.ue())
    height, width = 16 * mbh - 2 * (crop[2] + crop[3]), 16 * mbw - 2 * (crop[0] + crop[1])
    if crop[0] or crop[2]:
        raise NotImplementedError("frame cropping at the left or top")
    return Sps(height, width, mbh, mbw, log2_fn, poc_type, lsb)


def check_pps(unit: bytes) -> None:
    if unit[0] & 0x1F != NAL_PPS:
        raise ValueError("not a PPS NAL unit")
    b = _Bits(remove_emulation_prevention(unit[1:]))
    b.ue()
    b.ue()
    if b.u(1):
        raise NotImplementedError("CABAC (entropy_coding_mode_flag 1)")
    b.u(1)
    if b.ue():
        raise NotImplementedError("slice groups")
    b.ue()
    b.ue()
    if b.u(1) or b.u(2):
        raise NotImplementedError("weighted prediction")
    if b.se() or b.se() or b.se():
        raise NotImplementedError("pic_init_qp/qs or chroma_qp_index_offset other than 26, 26, 0")
    if not b.u(1):
        raise NotImplementedError("deblocking on (deblocking_filter_control_present_flag 0)")
    if b.u(1):
        raise NotImplementedError("constrained intra prediction")
    if b.u(1):
        raise NotImplementedError("redundant pictures")
    if b.more_rbsp_data():
        raise NotImplementedError("PPS extensions (transform_8x8_mode, scaling matrices)")


def _inverse4x4_np(d: np.ndarray) -> np.ndarray:
    def inv(a, b, c, e):
        e0, e1, e2, e3 = a + c, a - c, (b >> 1) - e, b + (e >> 1)
        return e0 + e3, e1 + e2, e1 - e2, e0 - e3

    f = np.stack(inv(d[..., 0], d[..., 1], d[..., 2], d[..., 3]), -1)
    h = np.stack(inv(f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]), -2)
    return (h + 32) >> 6


def _levelscale(qp: int) -> np.ndarray:
    return np.array([[16 * V[qp % 6][pos_class(i, j)] for j in range(4)] for i in range(4)], np.int64)


def _dequant(c: np.ndarray, qp: int) -> np.ndarray:
    q = qp // 6
    ls = _levelscale(qp)
    return (c * ls) << (q - 4) if q >= 4 else (c * ls + (1 << (3 - q))) >> (4 - q)


def _scan(levels: Sequence[int], start: int) -> np.ndarray:
    c = np.zeros(16, np.int64)
    for k, v in enumerate(levels):
        c[ZIGZAG[start + k]] = v
    return c.reshape(4, 4)


def decode_own(sample: bytes, sps: bytes, pps: bytes) -> Decoded:
    """Decode one access unit (AVCC, 4-byte lengths) of the port's subset
    with its SPS and PPS NAL units. Raises NotImplementedError naming the
    feature where the stream leaves the subset (CABAC, P or B slices,
    Intra 4x4, Intra 16x16 vertical or plane, deblocking on, another
    profile, ...), ValueError where it is malformed."""
    info = parse_sps(sps)
    check_pps(pps)
    mbw, mbh = info.mbw, info.mbh
    Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
    C = np.zeros((2, 8 * mbh, 8 * mbw), np.int64)
    done = np.zeros(mbw * mbh, bool)
    pcm = np.zeros(mbw * mbh, bool)
    for unit in split_avcc(sample):
        kind = unit[0] & 0x1F
        if kind in (NAL_SPS, NAL_PPS, 6, 9):  # parameter sets, SEI, delimiters
            continue
        if kind == 1:
            raise NotImplementedError("non-IDR slices (the port writes IDR pictures only)")
        if kind != NAL_IDR:
            raise NotImplementedError(f"NAL unit type {kind}")
        b = _Bits(remove_emulation_prevention(unit[1:]))
        first = b.ue()
        slice_type = b.ue()
        if slice_type % 5 != 2:
            raise NotImplementedError(f"slice_type {slice_type} (P, B, SP or SI slices)")
        b.ue()
        b.u(info.log2_max_frame_num)
        b.ue()  # idr_pic_id
        if info.poc_type == 0:
            b.u(info.log2_max_poc_lsb)
        b.u(2)  # dec_ref_pic_marking of an IDR picture
        qp = 26 + b.se()
        if b.ue() != 1:
            raise NotImplementedError("deblocking on (disable_deblocking_filter_idc other than 1)")
        _decode_slice(b, first, qp, mbw, mbh, Y, C, done, pcm)
    if not done.all():
        raise ValueError(f"{int((~done).sum())} macroblocks of {done.size} are missing from the picture")
    y = Y[:info.height, :info.width].astype(np.uint8)
    cb = C[0, :info.height // 2, :info.width // 2].astype(np.uint8)
    cr = C[1, :info.height // 2, :info.width // 2].astype(np.uint8)
    return Decoded(y, cb, cr, ycbcr_to_rgb(y, cb, cr), pcm.reshape(mbh, mbw))


def _decode_slice(b: _Bits, first: int, qp: int, mbw: int, mbh: int, Y: np.ndarray, C: np.ndarray,
                  done: np.ndarray, pcm: np.ndarray) -> None:
    n_mb = mbw * mbh
    counts = {}  # mb -> ([4][4] luma totals [y][x], [2][2][2] chroma totals [c][y][x])
    mb = first
    while True:
        if mb >= n_mb or done[mb]:
            raise ValueError(f"macroblock {mb} out of the picture or decoded twice")
        mx, my = mb % mbw, mb // mbw
        left = mb - 1 if mx > 0 and mb - 1 >= first else None
        up = mb - mbw if mb - mbw >= first else None
        mb_type = b.ue()
        ys, xs = slice(16 * my, 16 * my + 16), slice(16 * mx, 16 * mx + 16)
        cys, cxs = slice(8 * my, 8 * my + 8), slice(8 * mx, 8 * mx + 8)
        if mb_type == 25:
            while b.p % 8:
                if b.u(1):
                    raise ValueError("a pcm_alignment_zero_bit is 1")
            Y[ys, xs] = np.array([b.u(8) for _ in range(256)]).reshape(16, 16)
            C[:, cys, cxs] = np.array([b.u(8) for _ in range(128)]).reshape(2, 8, 8)
            counts[mb] = ([[16] * 4 for _ in range(4)], [[[16] * 2 for _ in range(2)] for _ in range(2)])
            pcm[mb] = True
        elif mb_type == 0:
            raise NotImplementedError("Intra 4x4 macroblocks (I_NxN)")
        elif mb_type > 25:
            raise ValueError(f"mb_type {mb_type} in an I slice")
        else:
            mode, cbp_chroma, cbp_luma = (mb_type - 1) % 4, ((mb_type - 1) // 4) % 3, 15 if mb_type >= 13 else 0
            cmode = b.ue()
            if up is not None or mode not in (1, 2) or cmode not in (0, 1):
                if mode in (0, 3) or cmode in (2, 3):
                    raise NotImplementedError("Intra 16x16 or chroma vertical/plane prediction")
                raise NotImplementedError("a slice of more than one macroblock row (prediction from above)")
            qp = (qp + b.se() + 52) % 52
            lcount = [[0] * 4 for _ in range(4)]
            ccount = [[[0] * 2 for _ in range(2)] for _ in range(2)]
            lc = counts[left] if left is not None else None

            def nc_of(n_a):
                return n_a if n_a is not None else 0

            def luma_nc(x, y_):
                n_a = lcount[y_][x - 1] if x > 0 else (lc[0][y_][3] if lc else None)
                n_b = lcount[y_ - 1][x] if y_ > 0 else None
                if n_a is not None and n_b is not None:
                    return (n_a + n_b + 1) >> 1
                return n_a if n_a is not None else nc_of(n_b)

            dc = read_residual_block(b, luma_nc(0, 0), 16)
            ac = [[0] * 15 for _ in range(16)]
            if cbp_luma:
                for k in range(16):
                    x, y_ = BLK_XY[k]
                    ac[k] = read_residual_block(b, luma_nc(x, y_), 15)
                    lcount[y_][x] = sum(1 for v in ac[k] if v)
            cdc = [[0] * 4, [0] * 4]
            cac = [[[0] * 15 for _ in range(4)] for _ in range(2)]
            if cbp_chroma:
                cdc = [read_residual_block(b, -1, 4) for _ in range(2)]
            if cbp_chroma == 2:
                for c in range(2):
                    for k in range(4):
                        x, y_ = k % 2, k // 2
                        n_a = ccount[c][y_][0] if x > 0 else (lc[1][c][y_][1] if lc else None)
                        n_b = ccount[c][y_ - 1][x] if y_ > 0 else None
                        n = ((n_a + n_b + 1) >> 1) if n_a is not None and n_b is not None else nc_of(
                            n_a if n_a is not None else n_b)
                        cac[c][k] = read_residual_block(b, n, 15)
                        ccount[c][y_][x] = sum(1 for v in cac[c][k] if v)
            counts[mb] = (lcount, ccount)
            # luma prediction (8.3.3) from the left column only
            if left is None:
                pred = np.full((16, 16), 128, np.int64)
            elif mode == 1:
                pred = np.repeat(Y[ys, 16 * mx - 1][:, None], 16, 1)
            else:
                pred = np.full((16, 16), (int(Y[ys, 16 * mx - 1].sum()) + 8) >> 4, np.int64)
            f = _hadamard4_np(_scan(dc, 0))
            q = qp // 6
            ls0 = 16 * V[qp % 6][0]
            dcy = (f * ls0) << (q - 6) if q >= 6 else (f * ls0 + (1 << (5 - q))) >> (6 - q)
            for k in range(16):
                x, y_ = BLK_XY[k]
                d = _dequant(_scan(ac[k], 1), qp)
                d[0, 0] = dcy[y_, x]
                Y[16 * my + 4 * y_:16 * my + 4 * y_ + 4, 16 * mx + 4 * x:16 * mx + 4 * x + 4] = np.clip(
                    pred[4 * y_:4 * y_ + 4, 4 * x:4 * x + 4] + _inverse4x4_np(d), 0, 255)
            qpc = chroma_qp(qp)
            for c in range(2):
                if left is None:
                    cpred = np.full((8, 8), 128, np.int64)
                elif cmode == 1:
                    cpred = np.repeat(C[c, cys, 8 * mx - 1][:, None], 8, 1)
                else:
                    col = C[c, cys, 8 * mx - 1]
                    cpred = np.repeat(np.array([(int(col[:4].sum()) + 2) >> 2, (int(col[4:].sum()) + 2) >> 2]),
                                      4)[:, None].repeat(8, 1)
                cd = cdc[c]
                fc = np.array([[cd[0] + cd[1] + cd[2] + cd[3], cd[0] - cd[1] + cd[2] - cd[3]],
                               [cd[0] + cd[1] - cd[2] - cd[3], cd[0] - cd[1] - cd[2] + cd[3]]], np.int64)
                dcc = ((fc * (16 * V[qpc % 6][0])) << (qpc // 6)) >> 5
                for k in range(4):
                    x, y_ = k % 2, k // 2
                    d = _dequant(_scan(cac[c][k], 1), qpc)
                    d[0, 0] = dcc[y_, x]
                    C[c, 8 * my + 4 * y_:8 * my + 4 * y_ + 4, 8 * mx + 4 * x:8 * mx + 4 * x + 4] = np.clip(
                        cpred[4 * y_:4 * y_ + 4, 4 * x:4 * x + 4] + _inverse4x4_np(d), 0, 255)
        done[mb] = True
        if not b.more_rbsp_data():
            break
        mb += 1
    if b.s[b.p:] != "1" + "0" * (len(b.s) - b.p - 1):
        raise ValueError("the slice's trailing bits are not rbsp_slice_trailing_bits")


def _hadamard4_np(x: np.ndarray) -> np.ndarray:
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    return h @ x @ h
