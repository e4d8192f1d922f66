"""Seeded H.264 streams of random syntax in mp4 files, and FFmpeg (cv2) as
the referee of their decoding: the fixtures of the port's decoder
(`csrc/h264_decode.cpp`). Only the tests and chip_smoke.py import this;
the port's runtime does not.

The writer picks every syntax element at random among the values that are
valid where it stands (intra modes the neighbours allow, reference indices
that name a picture, small motion vector differences, levels whose
scaled coefficients and transforms stay within 16 bits, memory management
operations that name existing pictures) and writes it with CAVLC or with a
CABAC encoding engine (9.3.4) whose context selection mirrors the
decoder's. It never reconstructs a picture: FFmpeg's decode of the file is
the reference. Each stream records the CABAC contexts and the CAVLC codes
(coeff_token, total_zeros, run_before, coded_block_pattern) it reached.

`FIXTURES` names the streams the tests use; `write_fixture(name, path)`
writes one into an mp4 whose container options (ctts, an edit list, stco
or co64, several samples a chunk, moov first or last, avc1 or avc3, NAL
lengths of 1, 2 or 4 bytes) the fixture chooses, written here and not by
the product's `Mp4Muxer`. `ffmpeg_decode(path)` runs cv2 in a subprocess
with FFmpeg's log let through and returns its frames (luma planes and BGR)
with the log's errors and warnings.

    python -m genefaceplusplus_tpu_torch.tools.h264_streams OUT_DIR
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data import h264
from genefaceplusplus_tpu_torch.data.mp4 import box, full_box

MASK = (1 << 64) - 1

# ---------------------------------------------------------------------------
# Tables (the same values as the decoder's)
# ---------------------------------------------------------------------------

RANGE_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216), (123, 150, 178, 205), (116, 142, 169, 195),
    (111, 135, 160, 185), (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158), (90, 110, 130, 150),
    (85, 104, 123, 142), (81, 99, 117, 135), (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94), (53, 65, 77, 89),
    (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72), (41, 50, 59, 69),
    (39, 48, 56, 65), (37, 45, 54, 62), (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41),
    (23, 28, 33, 39), (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33), (19, 23, 27, 31),
    (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21), (12, 14, 17, 20), (11, 14, 16, 19),
    (11, 13, 15, 18), (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14),
    (8, 10, 12, 14), (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2))
TRANS_LPS = (0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21,
             22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35,
             35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63)
SIG8 = (0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7, 7, 6, 11,
        12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12)
LAST8 = (0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3,
         3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8)
ZZ8 = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
       21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
       60, 61, 54, 47, 55, 62, 63)
ZZ4 = h264.ZIGZAG
BLK_X = tuple(x for x, _ in h264.BLK_XY)
BLK_Y = tuple(y for _, y in h264.BLK_XY)
CBP_INTRA = (47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37,
             42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41)
CBP_INTER = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40,
             39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41)
V8 = ((20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26), (26, 23, 42, 24, 33, 31), (28, 25, 45, 26, 35, 33),
      (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43))
B_TYPES = ((0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0), (1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 2, 2), (1, 1, 2),
           (2, 1, 2), (1, 2, 1), (2, 2, 1), (1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 2, 3), (1, 3, 1), (2, 3, 1),
           (1, 3, 2), (2, 3, 2), (1, 3, 3), (2, 3, 3))
B_SUB = ((4, 0), (0, 1), (0, 2), (0, 3), (1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (2, 3), (3, 1), (3, 2), (3, 3))
SUB_GEOM = (((0, 0, 8, 8),), ((0, 0, 8, 4), (0, 4, 8, 4)), ((0, 0, 4, 8), (4, 0, 4, 8)),
            ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4)))
DEFAULT4 = ((6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42),
            (10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34))
DEFAULT8 = ((6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23, 23, 25, 25, 25, 25, 25,
             25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31, 31, 33, 33, 33,
             33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42),
            (9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21, 21, 22, 22, 22, 22, 22,
             22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 28, 28, 28,
             28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35))
F_INTRA, F_I4, F_I8, F_I16, F_PCM, F_SKIP, F_DIRECT16, F_T8 = 1, 2, 4, 8, 16, 32, 64, 128
INTRA_IN_INTER = 0.1  # the share of intra macroblocks in P and B slices
LIMIT = 32767 - 64  # every scaled coefficient and transform value stays within 16 bits, with room
# for the rounding constant FFmpeg adds to the DC coefficient before its 16-bit first pass

# the CABAC contexts that progressive 8-bit 4:2:0 frames use: all of 0..459 but SI's
# mb_type prefix (0-2), mb_field_decoding_flag (70-72), the terminating bin (276) and
# the field-coded significance maps (277-398, 436-459)
FRAME_CONTEXTS = frozenset(range(3, 70)) | frozenset(range(73, 276)) | frozenset(range(399, 436))


def cavlc_code_set() -> frozenset:
    """Every CAVLC code of 9.2 a 4:2:0 frame can use, as the keys `_Writer`
    records: coeff_token (5 tables), total_zeros (4x4 and chroma DC),
    run_before, and coded_block_pattern's codeNum (intra and inter)."""
    keys = set()
    for t in range(4):
        for tc in range(17):
            for t1 in range(min(tc, 3) + 1):
                keys.add(("coeff_token", t, tc, t1))
    for tc in range(5):
        for t1 in range(min(tc, 3) + 1):
            keys.add(("coeff_token", -1, tc, t1))
    for tc in range(1, 16):
        for tz in range(17 - tc):
            keys.add(("total_zeros", 16, tc, tz))
    for tc in range(1, 4):
        for tz in range(5 - tc):
            keys.add(("total_zeros", 4, tc, tz))
    for zl in range(1, 8):
        for run in range(zl + 1 if zl < 7 else 15):
            keys.add(("run_before", zl, run))
    for k in range(48):
        keys.add(("cbp", 0, k))
        keys.add(("cbp", 1, k))
    return frozenset(keys)


# ---------------------------------------------------------------------------
# Randomness and bits
# ---------------------------------------------------------------------------

class Rng:
    """splitmix64: the same numbers on every machine and numpy version."""

    def __init__(self, seed: int):
        self.s = (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & MASK

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & MASK
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK
        return z ^ (z >> 31)

    def int(self, lo: int, hi: int) -> int:  # inclusive
        return lo + self.next() % (hi - lo + 1)

    def chance(self, p: float) -> bool:
        return self.next() < p * 2.0 ** 64

    def choice(self, seq):
        return seq[self.next() % len(seq)]

    def weighted(self, items: Sequence[Tuple[object, float]]):
        total = sum(w for _, w in items)
        x = (self.next() / 2.0 ** 64) * total
        for item, w in items:
            x -= w
            if x < 0:
                return item
        return items[-1][0]


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0

    def bit(self, b: int):
        self.cur = (self.cur << 1) | (b & 1)
        self.n += 1
        if self.n == 8:
            self.out.append(self.cur)
            self.cur = self.n = 0

    def u(self, n: int, v: int):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def ue(self, v: int):
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def bits(self, s: str):
        for ch in s:
            self.bit(ch == "1")

    def aligned(self) -> bool:
        return self.n == 0

    def trailing(self):
        self.bit(1)
        while self.n:
            self.bit(0)

    def data(self) -> bytes:
        assert self.n == 0
        return bytes(self.out)


class CabacEncoder:
    """The arithmetic encoder of 9.3.4 over a BitWriter; records the contexts it codes."""

    def __init__(self, bw: BitWriter, reached: set):
        self.bw = bw
        self.reached = reached
        self.state = [0] * 460
        self.mps = [0] * 460
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def init_contexts(self, table, qp: int):
        for i in range(460):
            m, n = table[i]
            pre = min(126, max(1, ((m * min(51, max(0, qp))) >> 4) + n))
            if pre <= 63:
                self.state[i], self.mps[i] = 63 - pre, 0
            else:
                self.state[i], self.mps[i] = pre - 64, 1

    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.bw.bit(b)
        while self.outstanding:
            self.bw.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int):
        self.reached.add(ctx)
        s, m = self.state[ctx], self.mps[ctx]
        lps = RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if b != m:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - m
            self.state[ctx] = TRANS_LPS[s]
        elif s < 62:
            self.state[ctx] = s + 1
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()

    def eg(self, v: int, k: int):  # k-th order Exp-Golomb, bypass
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)


def cabac_init_values():
    """The decoder's (m, n) pairs [4, 460, 2] (I, then cabac_init_idc 0-2): the writer
    encodes with them and FFmpeg, which holds its own, judges the result."""
    from genefaceplusplus_tpu_torch.data.h264_decode import cabac_init_table

    return cabac_init_table().astype(int).tolist()


# ---------------------------------------------------------------------------
# Scaling and transforms (the decoder's integer arithmetic), for the 16-bit bound
# ---------------------------------------------------------------------------

def _v4(m: int, i: int, j: int) -> int:
    return h264.V[m][h264.pos_class(i, j)]


def _v8(m: int, i: int, j: int) -> int:
    if i % 4 == 0 and j % 4 == 0:
        k = 0
    elif i % 2 == 1 and j % 2 == 1:
        k = 1
    elif i % 4 == 2 and j % 4 == 2:
        k = 2
    elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        k = 3
    elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        k = 4
    else:
        k = 5
    return V8[m][k]


def _deq4(c: int, qp: int, w: int, i: int, j: int) -> int:
    ls = w * _v4(qp % 6, i, j)
    return (c * ls) << (qp // 6 - 4) if qp >= 24 else (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def _idct4_fits(d: List[int]) -> bool:
    x = list(d)
    if any(abs(v) > LIMIT for v in x):
        return False
    for i in range(4):
        r = x[4 * i:4 * i + 4]
        e0, e1, e2, e3 = r[0] + r[2], r[0] - r[2], (r[1] >> 1) - r[3], r[1] + (r[3] >> 1)
        x[4 * i:4 * i + 4] = [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    if any(abs(v) > LIMIT for v in x):
        return False
    for j in range(4):
        a, b, c, e = x[j], x[4 + j], x[8 + j], x[12 + j]
        e0, e1, e2, e3 = a + c, a - c, (b >> 1) - e, b + (e >> 1)
        if any(abs(v) > LIMIT for v in (e0 + e3, e1 + e2, e1 - e2, e0 - e3)):
            return False
    return True


def _idct8_1d(v: List[int]) -> List[int]:
    d0, d1, d2, d3, d4, d5, d6, d7 = v
    a0, a4, a2, a6 = d0 + d4, d0 - d4, (d2 >> 1) - d6, d2 + (d6 >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1, a3 = -d3 + d5 - d7 - (d7 >> 1), d1 + d7 - d3 - (d3 >> 1)
    a5, a7 = -d1 + d7 + d5 + (d5 >> 1), d3 + d5 + d1 + (d1 >> 1)
    b1, b7, b3, b5 = a1 + (a7 >> 2), a7 - (a1 >> 2), a3 + (a5 >> 2), (a3 >> 2) - a5
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7]


def _idct8_fits(d: List[int]) -> bool:
    if any(abs(v) > LIMIT for v in d):
        return False
    rows = [_idct8_1d(d[8 * i:8 * i + 8]) for i in range(8)]
    if any(abs(v) > LIMIT for r in rows for v in r):
        return False
    cols = [_idct8_1d([rows[i][j] for i in range(8)]) for j in range(8)]
    return not any(abs(v) > LIMIT for c in cols for v in c)


# ---------------------------------------------------------------------------
# Stream options
# ---------------------------------------------------------------------------

@dataclass
class PicPlan:
    kind: str  # "I", "P" or "B"
    display: int  # output position within its IDR period
    idr: bool = False
    ref: bool = True
    long_term_reference: bool = False  # IDR only
    mmco: bool = False  # random memory management operations


@dataclass
class Spec:
    width: int
    height: int
    pictures: List[PicPlan]
    cabac: bool = False
    profile: int = 100
    crop_top: int = 0
    slices: Tuple[int, int] = (1, 1)  # slices a picture, at least and at most
    deblock: Tuple[int, ...] = (0,)  # disable_deblocking_filter_idc choices
    deblock_offsets: bool = False
    transform8x8: bool = False
    scaling: str = ""  # "", "sps", "pps", "both"
    constrained_intra: bool = False
    weighted_pred: bool = False
    weighted_bipred: int = 0
    direct_spatial: bool = True
    direct_8x8_inference: bool = True
    poc_type: int = 0
    max_refs: int = 4
    refs_active: Tuple[int, int] = (1, 1)
    list_mods: bool = False
    qp: Tuple[int, int] = (18, 36)
    pcm: float = 0.02
    skip: float = 0.15
    big_mvd: float = 0.03
    full_range: bool = False
    matrix: int = 6  # matrix_coefficients (6: BT.601, 1: BT.709)
    level_scale: float = 1.0  # how dense the residuals are
    sparse: bool = False  # residual blocks of a few small levels only (small NAL units)
    frame_mbs_only: bool = True  # False writes an SPS of interlaced video (for the refusals)
    bit_depth: int = 8  # another depth writes a High 10 SPS (for the refusals)
    # container
    sample_entry: str = "avc1"
    length_size: int = 4
    moov_last: bool = False
    co64: bool = False
    chunk: int = 1  # samples a chunk
    edit_start: int = 0  # frames skipped at the start by the edit list (with B frames: ctts + elst)
    edit_frames: int = 0  # frames the edit list shows (0: all after edit_start)
    ctts_v1: bool = False  # signed composition offsets (ctts version 1), no shift
    extra_parameter_sets: bool = False  # avcC also holds an SPS and a PPS the stream does not use
    brand: bytes = b"isom"  # ftyp's major brand (b"qt  ": QuickTime)
    restriction: bool = True  # the VUI's bitstream_restriction (max_num_reorder_frames)
    rotation: int = 0  # clockwise degrees in the track header's matrix, as phones write portrait video


def ip_plan(n: int, idr_every: int = 0, non_ref_every: int = 0, mmco: bool = False,
            long_first: bool = False) -> List[PicPlan]:
    out = []
    for i in range(n):
        idr = i == 0 or (idr_every and i % idr_every == 0)
        base = (i // idr_every) * idr_every if idr_every else 0
        ref = not (non_ref_every and i % non_ref_every == non_ref_every - 1) or idr
        out.append(PicPlan("I" if idr else "P", i - base, idr=idr, ref=ref,
                           long_term_reference=long_first and i == 0, mmco=mmco and not idr))
    return out


def b_plan(n_groups: int, b_frames: int = 3, pyramid: bool = True, intra_every: int = 0) -> List[PicPlan]:
    """IDR, then groups of `b_frames` B pictures before a P (decoding order P first), the
    middle B a reference (B-pyramid) where `pyramid`."""
    out = [PicPlan("I", 0, idr=True)]
    d = 0
    for g in range(n_groups):
        anchor = d + b_frames + 1
        kind = "I" if intra_every and (g + 1) % intra_every == 0 else "P"
        out.append(PicPlan(kind, anchor))
        bs = list(range(d + 1, anchor))
        if pyramid and len(bs) >= 3:
            mid = bs[len(bs) // 2]
            out.append(PicPlan("B", mid, ref=True))
            for b in bs:
                if b != mid:
                    out.append(PicPlan("B", b, ref=False))
        else:
            for b in bs:
                out.append(PicPlan("B", b, ref=False))
        d = anchor
    return out


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------

class _Pic:
    """A picture as the writer tracks it: marking, order and its blocks' references."""

    def __init__(self, pid: int, nmb: int, w4: int, h4: int):
        self.id = pid
        self.frame_num = 0
        self.poc = 0
        self.short = self.long = False
        self.long_idx = -1
        self.fnw = 0
        self.ref = np.full((2, h4, w4), -1, np.int32)
        self.rpic = np.full((2, h4, w4), -1, np.int64)
        self.intra = np.zeros(nmb, bool)


class _Writer:
    def __init__(self, spec: Spec, seed: int):
        self.s = spec
        self.rng = Rng(seed)
        self.mbw = (spec.width + 15) // 16
        self.mbh = (spec.height + spec.crop_top + 15) // 16
        self.nmb = self.mbw * self.mbh
        self.w4, self.h4 = 4 * self.mbw, 4 * self.mbh
        self.contexts: set = set()
        self.codes: set = set()
        self.init_tables = cabac_init_values()
        self.dpb: List[_Pic] = []
        self.next_id = 1
        self.max_long_idx = -1
        self.log2_fn, self.log2_lsb = 6, 8
        self.poc_cycle = [2]  # POC type 1: offset_for_ref_frame
        self.offset_non_ref = -1
        self._scaling()

    # ---- parameter sets ----
    def _scaling(self):
        s, r = self.s, self.rng
        self.sps_lists = self.pps_lists = None
        # each list: None (absent), "default" or 16/64 values in zig-zag order
        def lists(n8):
            out = []
            for i in range(6 + n8):
                size = 16 if i < 6 else 64
                out.append(r.weighted([(None, 1), ("default", 1), ([r.int(4, 40) for _ in range(size)], 3)]))
            return out
        if s.scaling in ("sps", "both"):
            self.sps_lists = lists(2)
        if s.scaling in ("pps", "both"):
            self.pps_lists = lists(2 if s.transform8x8 else 0)
        # the weights each (intra/inter, component) uses, resolved as the decoder does
        def resolve(given, fallback):
            w4, w8 = [None] * 6, [None] * 2
            for i in range(6):
                v = given[i] if given else None
                if isinstance(v, list):
                    w4[i] = v
                elif v == "default" or (v is None and i in (0, 3) and fallback is None):
                    w4[i] = list(DEFAULT4[i >= 3])
                elif v is None and i in (0, 3):
                    w4[i] = fallback[0][i]
                else:
                    w4[i] = w4[i - 1]
            for i in range(2):
                v = given[6 + i] if given and len(given) > 6 else None
                if isinstance(v, list):
                    w8[i] = v
                elif v == "default" or fallback is None:
                    w8[i] = list(DEFAULT8[i])
                else:
                    w8[i] = fallback[1][i]
            return w4, w8
        flat = ([[16] * 16 for _ in range(6)], [[16] * 64 for _ in range(2)])
        seq = resolve(self.sps_lists, None) if self.sps_lists else flat
        self.weights = resolve(self.pps_lists, seq if self.sps_lists else None) if self.pps_lists else seq
        # raster weight matrices
        self.wm4 = [[0] * 16 for _ in range(6)]
        self.wm8 = [[0] * 64 for _ in range(2)]
        for i in range(6):
            for k in range(16):
                self.wm4[i][ZZ4[k]] = self.weights[0][i][k]
        for i in range(2):
            for k in range(64):
                self.wm8[i][ZZ8[k]] = self.weights[1][i][k]

    def _write_lists(self, b: BitWriter, lists):
        for v in lists:
            b.bit(0 if v is None else 1)
            if v == "default":  # a first delta that makes nextScale 0: useDefaultScalingMatrixFlag
                b.se(-8)
            elif v is not None:
                last = 8
                for x in v:
                    b.se((x - last + 128) % 256 - 128)
                    last = x

    def reorder_depth(self) -> int:
        pics = self.s.pictures
        depth = 0
        for i, p in enumerate(pics):
            seg_start = max(k for k in range(i + 1) if pics[k].idr)
            before = [q for q in pics[seg_start:i] if q.display > p.display]
            depth = max(depth, len(before))
        return depth

    def sps(self) -> bytes:
        s = self.s
        b = BitWriter()
        profile = 110 if s.bit_depth != 8 else s.profile
        b.u(8, profile)
        b.u(8, 0x40 if profile == 66 else 0)
        b.u(8, 30)
        b.ue(0)
        if profile in (100, 110, 122, 244):
            b.ue(1)
            b.ue(s.bit_depth - 8)
            b.ue(s.bit_depth - 8)
            b.bit(0)
            b.bit(1 if self.sps_lists else 0)
            if self.sps_lists:
                self._write_lists(b, self.sps_lists)
        b.ue(self.log2_fn - 4)
        b.ue(s.poc_type)
        if s.poc_type == 0:
            b.ue(self.log2_lsb - 4)
        elif s.poc_type == 1:
            b.bit(0)  # delta_pic_order_always_zero_flag
            b.se(self.offset_non_ref)
            b.se(0)
            b.ue(len(self.poc_cycle))
            for o in self.poc_cycle:
                b.se(o)
        b.ue(s.max_refs)
        b.bit(0)
        b.ue(self.mbw - 1)
        b.ue(self.mbh - 1)
        b.bit(1 if s.frame_mbs_only else 0)
        if not s.frame_mbs_only:
            b.bit(0)  # mb_adaptive_frame_field_flag
        b.bit(1 if s.direct_8x8_inference else 0)
        cw, ch = 16 * self.mbw, 16 * self.mbh
        crop = (0, (cw - s.width) // 2, s.crop_top // 2, (ch - s.height - s.crop_top) // 2)
        if any(crop):
            b.bit(1)
            for c in crop:
                b.ue(c)
        else:
            b.bit(0)
        b.bit(1)  # vui_parameters_present_flag
        b.bit(0)  # aspect ratio
        b.bit(0)  # overscan
        b.bit(1)  # video signal type
        b.u(3, 5)
        b.bit(1 if s.full_range else 0)
        b.bit(1)
        b.u(8, s.matrix)
        b.u(8, s.matrix)
        b.u(8, s.matrix)
        b.bit(0)  # chroma location
        b.bit(1)
        b.u(32, 1)
        b.u(32, 2 * FPS)
        b.bit(1)
        b.bit(0)
        b.bit(0)
        b.bit(0)  # pic_struct_present_flag
        b.bit(1 if s.restriction else 0)  # bitstream_restriction_flag
        if s.restriction:
            b.bit(1)
            b.ue(0)
            b.ue(0)
            b.ue(16)
            b.ue(16)
            b.ue(self.reorder_depth())
            b.ue(s.max_refs)
        b.trailing()
        return h264.nal(7, b.data())

    def pps(self) -> bytes:
        s = self.s
        b = BitWriter()
        b.ue(0)
        b.ue(0)
        b.bit(1 if s.cabac else 0)
        b.bit(0)  # bottom_field_pic_order_in_frame_present_flag
        b.ue(0)
        b.ue(s.refs_active[0] - 1)
        b.ue(s.refs_active[1] - 1)
        b.bit(1 if s.weighted_pred else 0)
        b.u(2, s.weighted_bipred)
        self.pic_init_qp = 26
        b.se(0)
        b.se(0)
        self.cqp = (self.rng.int(-4, 4), self.rng.int(-4, 4)) if s.profile == 100 else (0, 0)
        if s.profile != 100:
            self.cqp = (self.cqp[0], self.cqp[0])
        b.se(self.cqp[0])
        b.bit(1)  # deblocking_filter_control_present_flag
        b.bit(1 if s.constrained_intra else 0)
        b.bit(0)
        if s.profile == 100:
            b.bit(1 if s.transform8x8 else 0)
            b.bit(1 if self.pps_lists else 0)
            if self.pps_lists:
                self._write_lists(b, self.pps_lists)
            b.se(self.cqp[1])
        b.trailing()
        return h264.nal(8, b.data())

    # ---- the reference pictures (mirrors of the decoder's) ----
    def _shorts_longs(self, cur, frame_num):
        shorts = [p for p in self.dpb if p is not cur and p.short]
        for p in shorts:
            p.fnw = p.frame_num - (1 << self.log2_fn) if p.frame_num > frame_num else p.frame_num
        longs = sorted([p for p in self.dpb if p is not cur and p.long], key=lambda p: p.long_idx)
        return shorts, longs

    def _lists(self, kind, cur, frame_num, num, mods):
        shorts, longs = self._shorts_longs(cur, frame_num)
        init = [[], []]
        if kind == "P":
            init[0] = sorted(shorts, key=lambda p: -p.fnw) + longs
        elif kind == "B":
            before = sorted([p for p in shorts if p.poc < cur.poc], key=lambda p: -p.poc)
            after = sorted([p for p in shorts if p.poc > cur.poc], key=lambda p: p.poc)
            init[0] = before + after + longs
            init[1] = after + before + longs
            if len(init[1]) > 1 and init[1] == init[0]:
                init[1][0], init[1][1] = init[1][1], init[1][0]
        out = []
        max_fn = 1 << self.log2_fn
        for l in range(2):
            lst = (init[l] + [None] * num[l])[:num[l]]
            pred, idx = frame_num, 0
            for idc, val in mods[l]:
                if idc < 2:
                    diff = val + 1
                    nw = pred - diff if idc == 0 else pred + diff
                    nw %= max_fn
                    pred = nw
                    pn = nw - max_fn if nw > frame_num else nw
                    pic = [p for p in shorts if p.fnw == pn][0]
                else:
                    pic = [p for p in longs if p.long_idx == val][0]
                lst.insert(idx, pic)
                idx += 1
                for k in range(idx, len(lst)):
                    if lst[k] is pic:
                        del lst[k]
                        break
                lst = lst[:num[l]]
            out.append(lst)
        return out

    def _random_mods(self, kind, cur, frame_num, num):
        """A few ref_pic_list_modification operations naming existing pictures."""
        shorts, longs = self._shorts_longs(cur, frame_num)
        mods = [[], []]
        max_fn = 1 << self.log2_fn
        for l in range(2 if kind == "B" else 1):
            pred = frame_num
            for _ in range(self.rng.int(0, min(num[l], 3))):
                pic = self.rng.choice(shorts + longs)
                if pic.short:
                    target = pic.fnw % max_fn  # its picNumNoWrap
                    idc = self.rng.int(0, 1)
                    d = ((pred - target) if idc == 0 else (target - pred)) % max_fn or max_fn
                    mods[l].append((idc, d - 1))
                    pred = target
                else:
                    mods[l].append((2, pic.long_idx))
        return mods

    def _mark(self, cur: _Pic, plan: PicPlan, mmco_ops):
        if not plan.ref:
            return
        if plan.idr:
            for p in self.dpb:
                if p is not cur:
                    p.short = p.long = False
            if plan.long_term_reference:
                cur.long, cur.long_idx, self.max_long_idx = True, 0, 0
            else:
                cur.short, self.max_long_idx = True, -1
            return
        current_long = False
        if mmco_ops is not None:
            shorts, _ = self._shorts_longs(cur, cur.frame_num)
            for op in mmco_ops:
                if op[0] == 1:
                    pn = cur.frame_num - (op[1] + 1)
                    [p for p in shorts if p.fnw == pn and p.short][0].short = False
                elif op[0] == 2:
                    for p in self.dpb:
                        if p is not cur and p.long and p.long_idx == op[1]:
                            p.long = False
                elif op[0] == 3:
                    pn = cur.frame_num - (op[1] + 1)
                    pic = [p for p in shorts if p.fnw == pn and p.short][0]
                    for p in self.dpb:
                        if p.long and p.long_idx == op[2]:
                            p.long = False
                    pic.short, pic.long, pic.long_idx = False, True, op[2]
                elif op[0] == 4:
                    self.max_long_idx = op[1] - 1
                    for p in self.dpb:
                        if p is not cur and p.long and p.long_idx > self.max_long_idx:
                            p.long = False
                elif op[0] == 5:
                    for p in self.dpb:
                        if p is not cur:
                            p.short = p.long = False
                    self.max_long_idx = -1
                elif op[0] == 6:
                    for p in self.dpb:
                        if p is not cur and p.long and p.long_idx == op[2]:
                            p.long = False
                    cur.long, cur.long_idx, current_long = True, op[2], True
        else:
            refs = [p for p in self.dpb if p is not cur and (p.short or p.long)]
            shorts = [p for p in refs if p.short]
            if len(refs) >= max(self.s.max_refs, 1) and shorts:
                for p in shorts:
                    p.fnw = p.frame_num - (1 << self.log2_fn) if p.frame_num > cur.frame_num else p.frame_num
                min(shorts, key=lambda p: p.fnw).short = False
        if not current_long:
            cur.short = True

    def _random_mmco(self, cur: _Pic):
        """Memory management operations naming existing pictures, that keep the
        references within max_num_ref_frames; None for the sliding window."""
        r = self.rng
        if not r.chance(0.7):
            return None
        shorts, longs = self._shorts_longs(cur, cur.frame_num)
        ops = []
        live_s = list(shorts)
        live_l = {p.long_idx: p for p in longs}  # long-term index -> picture, as the operations go
        max_idx = self.max_long_idx
        for _ in range(r.int(1, 3)):
            k = r.choice([1, 2, 3, 4, 6, 6, 3, 5] if not ops else [1, 2, 3, 4])
            if k == 1 and live_s:
                p = r.choice(live_s)
                ops.append((1, cur.frame_num - p.fnw - 1, 0))
                live_s.remove(p)
            elif k == 2 and live_l:
                idx = r.choice(sorted(live_l))
                ops.append((2, idx, 0))
                del live_l[idx]
            elif k == 3 and live_s and max_idx >= 0:
                p = r.choice(live_s)
                idx = r.int(0, max_idx)
                ops.append((3, cur.frame_num - p.fnw - 1, idx))
                live_s.remove(p)
                live_l[idx] = p
            elif k == 4:
                m = r.int(0, 3)
                ops.append((4, m, 0))
                max_idx = m - 1
                live_l = {i: p for i, p in live_l.items() if i <= max_idx}
            elif k == 6 and max_idx >= 0 and not any(o[0] == 6 for o in ops):
                idx = r.int(0, max_idx)
                ops.append((6, 0, idx))
                live_l.pop(idx, None)
            elif k == 5 and not ops:
                return [(5, 0, 0)]
        # room for the current picture
        while len(live_s) + len(live_l) + 1 > self.s.max_refs:
            if live_s:
                p = min(live_s, key=lambda q: q.fnw)
                ops.append((1, cur.frame_num - p.fnw - 1, 0))
                live_s.remove(p)
            else:
                idx = min(live_l)
                ops.append((2, idx, 0))
                del live_l[idx]
        return ops

    # ---- writing a stream ----
    def stream(self) -> Tuple[bytes, bytes, List[bytes], List[PicPlan]]:
        s = self.s
        sps, pps = self.sps(), self.pps()
        samples = []
        prev_ref_fn = 0
        idr_id = 0
        poc_base = 0
        fn_offset = 0
        prev_fn = 0
        self.after_mmco5 = False
        for plan in s.pictures:
            pic = _Pic(self.next_id, self.nmb, self.w4, self.h4)
            self.next_id += 1
            if plan.idr:
                frame_num = 0
                fn_offset = 0
            else:
                frame_num = (prev_ref_fn + 1) % (1 << self.log2_fn)
                if prev_fn > frame_num:
                    fn_offset += 1 << self.log2_fn
            pic.frame_num = frame_num
            if plan.idr:
                poc_base = plan.display
            pic.poc = 2 * (plan.display - poc_base) if s.poc_type != 2 else (
                0 if plan.idr else 2 * (fn_offset + frame_num) - (0 if plan.ref else 1))
            mmco = self._random_mmco(pic) if plan.mmco and plan.ref else None
            nal_type = 5 if plan.idr else 1
            units = []
            nslices = self.rng.int(*s.slices)
            bounds = sorted(self.rng.int(1, self.nmb - 1) for _ in range(nslices - 1)) if self.nmb > 1 else []
            starts = [0] + [x for i, x in enumerate(bounds) if i == 0 or x != bounds[i - 1]]
            ends = starts[1:] + [self.nmb]
            self.pic_state = self._new_state()
            self.cur = pic
            for si, (a, e) in enumerate(zip(starts, ends)):
                units.append(self._slice(plan, pic, nal_type, si, a, e, frame_num, idr_id, mmco, fn_offset))
            pic.intra = self.pic_state["flags"] & F_INTRA != 0
            self._mark(pic, plan, mmco)
            if mmco and any(o[0] == 5 for o in mmco):
                # the picture's order count becomes 0; later ones count from it
                poc_base = plan.display
                pic.poc = 0
                pic.frame_num = 0
                fn_offset = 0
                frame_num = 0
            self.dpb = [p for p in self.dpb if p.short or p.long]
            self.dpb.append(pic) if (pic.short or pic.long) else None
            if plan.ref:
                prev_ref_fn = frame_num
            prev_fn = frame_num
            if plan.idr:
                idr_id += 1
            if any(len(u) >= 1 << (8 * s.length_size) for u in units):
                raise ValueError(f"a NAL unit of {max(map(len, units))} bytes does not fit {s.length_size}-byte lengths")
            samples.append(b"".join(len(u).to_bytes(s.length_size, "big") + u for u in units))
        return sps, pps, samples, s.pictures

    def _new_state(self):
        n = self.nmb
        return {
            "slice": np.full(n, -1, np.int64), "flags": np.zeros(n, np.int64), "cbp": np.zeros(n, np.int64),
            "chroma": np.zeros(n, np.int64), "direct8": np.zeros(n, np.int64),
            "nz": np.zeros((self.h4, self.w4), np.int64), "nzc": np.zeros((2, n * 4), np.int64),
            "ipred": np.full((self.h4, self.w4), 2, np.int64), "mvd": np.zeros((2, self.h4, self.w4, 2), np.int64),
        }

    # ---- slice header ----
    def _slice(self, plan, pic, nal_type, si, first, end, frame_num, idr_id, mmco, fn_offset) -> bytes:
        s, r = self.s, self.rng
        b = BitWriter()
        st = {"I": 2, "P": 0, "B": 1}[plan.kind]
        b.ue(first)
        b.ue(st + (5 if r.chance(0.5) else 0))
        b.ue(0)
        b.u(self.log2_fn, frame_num)
        if plan.idr:
            b.ue(idr_id % 4)
        if s.poc_type == 0:
            b.u(self.log2_lsb, pic.poc % (1 << self.log2_lsb))
        elif s.poc_type == 1:
            b.se(pic.poc - self._expected_poc(plan, frame_num, fn_offset))
        num = [0, 0]
        mods = [[], []]
        if plan.kind in "PB":
            avail = len([p for p in self.dpb if p.short or p.long])
            want = [r.int(1, s.refs_active[0]), r.int(1, s.refs_active[1]) if plan.kind == "B" else 0]
            if plan.kind == "B" and not s.direct_spatial:
                want[0] = avail  # temporal direct: every reference in list 0
            num = [min(want[0], avail), min(want[1], avail)]
        if plan.kind == "B":
            b.bit(1 if s.direct_spatial else 0)
        if plan.kind in "PB":
            override = num[0] != s.refs_active[0] or (plan.kind == "B" and num[1] != s.refs_active[1])
            b.bit(1 if override else 0)
            if override:
                b.ue(num[0] - 1)
                if plan.kind == "B":
                    b.ue(num[1] - 1)
            if s.list_mods and r.chance(0.6):
                mods = self._random_mods(plan.kind, pic, frame_num, num)
            for l in range(2 if plan.kind == "B" else 1):
                b.bit(1 if mods[l] else 0)
                if mods[l]:
                    for idc, v in mods[l]:
                        b.ue(idc)
                        b.ue(v)
                    b.ue(3)
        self.lists = self._lists(plan.kind, pic, frame_num, num, mods) if plan.kind in "PB" else [[], []]
        self.num = num
        self.kind = plan.kind
        if (s.weighted_pred and plan.kind == "P") or (s.weighted_bipred == 1 and plan.kind == "B"):
            self._pred_weights(b, num, plan.kind)
        if plan.ref:
            if plan.idr:
                b.bit(0)
                b.bit(1 if plan.long_term_reference else 0)
            elif mmco is not None:
                b.bit(1)
                for op in mmco:
                    b.ue(op[0])
                    if op[0] in (1, 3):
                        b.ue(op[1])
                    if op[0] == 2:
                        b.ue(op[1])
                    if op[0] in (3, 6):
                        b.ue(op[2])
                    if op[0] == 4:
                        b.ue(op[1])
                b.ue(0)
            else:
                b.bit(0)
        init_idc = 0
        if s.cabac and plan.kind != "I":
            init_idc = r.int(0, 2)
            b.ue(init_idc)
        qp = r.int(*s.qp)
        b.se(qp - self.pic_init_qp)
        idc = r.choice(s.deblock)
        b.ue(idc)
        if idc != 1:
            a_, b_ = (r.int(-6, 6), r.int(-6, 6)) if s.deblock_offsets else (0, 0)
            b.se(a_)
            b.se(b_)
        self.slice_num = si
        self._slice_data(b, plan, first, end, qp, init_idc)
        return bytes([((3 if plan.ref else 0) << 5) | nal_type]) + h264.emulation_prevention(b.data())

    def _expected_poc(self, plan, frame_num, fn_offset) -> int:
        n = len(self.poc_cycle)
        abs_fn = fn_offset + frame_num if n else 0
        if not plan.ref and abs_fn > 0:
            abs_fn -= 1
        exp = 0
        if abs_fn > 0:
            cyc, inc = (abs_fn - 1) // n, (abs_fn - 1) % n
            exp = cyc * sum(self.poc_cycle) + sum(self.poc_cycle[:inc + 1])
        if not plan.ref:
            exp += self.offset_non_ref
        return exp

    def _pred_weights(self, b: BitWriter, num, kind):
        """Explicit weights whose weighted sums stay within 16 bits: FFmpeg's SIMD
        weighting saturates 16-bit sums (denominators up to 2^6, |weight| <= 48)."""
        r = self.rng
        ld, cd = r.int(0, 6), r.int(0, 6)
        b.ue(ld)
        b.ue(cd)

        def weight(d):
            return max(-48, min(48, (1 << d) + r.int(-(1 << d) // 2 - 3, (1 << d) // 2 + 3)))
        for l in range(2 if kind == "B" else 1):
            for i in range(num[l]):
                if r.chance(0.7):
                    b.bit(1)
                    b.se(weight(ld))
                    b.se(r.int(-20, 20))
                else:
                    b.bit(0)
                if r.chance(0.6):
                    b.bit(1)
                    for _ in range(2):
                        b.se(weight(cd))
                        b.se(r.int(-20, 20))
                else:
                    b.bit(0)

    # ---- neighbours (mirrors of the decoder's) ----
    def mb_at(self, x4, y4):
        if x4 < 0 or y4 < 0 or x4 >= self.w4 or y4 >= self.h4:
            return -1
        mb = (y4 >> 2) * self.mbw + (x4 >> 2)
        return mb if self.pic_state["slice"][mb] == self.slice_num else -1

    def avail4(self, x4, y4):
        mb = self.mb_at(x4, y4)
        if mb < 0:
            return False
        if mb != self.cur_mb:
            return True
        return (self.mask >> ((y4 & 3) * 4 + (x4 & 3))) & 1 == 1

    def intra_avail(self, x4, y4):
        if not self.avail4(x4, y4):
            return False
        return not self.s.constrained_intra or bool(self.pic_state["flags"][self.mb_at(x4, y4)] & F_INTRA)

    def mb_left(self):
        return self.mb_at(4 * self.mbx - 1, 4 * self.mby) if self.mbx > 0 else -1

    def mb_top(self):
        return self.mb_at(4 * self.mbx, 4 * self.mby - 1) if self.mby > 0 else -1

    # ---- slice data ----
    def _slice_data(self, b: BitWriter, plan, first, end, qp, init_idc):
        s = self.s
        self.b = b
        self.qp = qp
        self.last_dqp = False
        self.enc = None
        if s.cabac:
            while not b.aligned():
                b.bit(1)
            self.enc = CabacEncoder(b, self.contexts)
            self.enc.init_contexts(self.init_tables[0 if plan.kind == "I" else 1 + init_idc], qp)
        run = 0
        for mb in range(first, end):
            self._begin(mb)
            skip = plan.kind != "I" and self.rng.chance(s.skip) and self._skip_ok()
            if s.cabac:
                if plan.kind != "I":
                    st = self.pic_state
                    a, t = self.mb_left(), self.mb_top()
                    inc = (a >= 0 and not st["flags"][a] & F_SKIP) + (t >= 0 and not st["flags"][t] & F_SKIP)
                    self.enc.decision((11 if plan.kind == "P" else 24) + inc, 1 if skip else 0)
                if skip:
                    self._skip()
                else:
                    self._mb()
                self.enc.terminate(1 if mb == end - 1 else 0)
            else:
                if skip:
                    self._skip()
                    run += 1
                    continue
                if plan.kind != "I":
                    b.ue(run)
                    run = 0
                self._mb()
        if s.cabac:
            while not b.aligned():
                b.bit(0)
        else:
            if run:
                b.ue(run)
            b.trailing()

    def _begin(self, mb):
        st = self.pic_state
        self.cur_mb, self.mbx, self.mby = mb, mb % self.mbw, mb // self.mbw
        self.mask = 0
        st["slice"][mb] = self.slice_num
        st["flags"][mb] = st["cbp"][mb] = st["chroma"][mb] = st["direct8"][mb] = 0

    def _mark_done(self, px, py, w, h):
        for y in range(py // 4, (py + h) // 4):
            for x in range(px // 4, (px + w) // 4):
                self.mask |= 1 << (y * 4 + x)

    def _set_ref(self, px, py, w, h, l, ref):
        pid = self.lists[l][ref].id if ref >= 0 else -1
        y0, x0 = 4 * self.mby + py // 4, 4 * self.mbx + px // 4
        self.cur.ref[l, y0:y0 + h // 4, x0:x0 + w // 4] = ref
        self.cur.rpic[l, y0:y0 + h // 4, x0:x0 + w // 4] = pid

    # ---- direct prediction's references (no motion vectors) ----
    def _colocated(self, bx, by):
        col = self.lists[1][0]
        if col.intra[self.cur_mb]:
            return -1, -1
        y, x = 4 * self.mby + by, 4 * self.mbx + bx
        l = 0 if col.ref[0, y, x] >= 0 else 1
        return int(col.ref[l, y, x]), int(col.rpic[l, y, x])

    def _direct_refs(self, which: int, check: bool = False) -> bool:
        """Set the references of the 8x8 blocks in `which`; with `check` only say whether
        temporal direct can map every co-located reference into list 0."""
        if self.s.direct_spatial:
            if check:
                return True
            x4, y4 = 4 * self.mbx, 4 * self.mby
            refs = []
            for l in range(2):
                def nref(x, y):
                    if not self.avail4(x, y):
                        return None
                    return int(self.cur.ref[l, y, x])
                A, B, C = nref(x4 - 1, y4), nref(x4, y4 - 1), nref(x4 + 4, y4 - 1)
                if C is None:
                    C = nref(x4 - 1, y4 - 1)
                A, B, C = (v if v is not None else -1 for v in (A, B, C))

                def mp(a, b):
                    return min(a, b) if a >= 0 and b >= 0 else max(a, b)
                refs.append(mp(A, mp(B, C)))
            if refs[0] < 0 and refs[1] < 0:
                refs = [0, 0]
            for b8 in range(4):
                if which >> b8 & 1:
                    for l in range(2):
                        self._set_ref(8 * (b8 & 1), 8 * (b8 >> 1), 8, 8, l, refs[l])
                    self._mark_done(8 * (b8 & 1), 8 * (b8 >> 1), 8, 8)
            return True
        infer = self.s.direct_8x8_inference
        for b8 in range(4):
            if not which >> b8 & 1:
                continue
            for sb in range(4):
                bx, by = 2 * (b8 & 1) + (sb & 1), 2 * (b8 >> 1) + (sb >> 1)
                cref, cid = self._colocated(3 * (b8 & 1), 3 * (b8 >> 1)) if infer else self._colocated(bx, by)
                r0 = 0
                if cref >= 0:
                    ids = [p.id for p in self.lists[0]]
                    if cid not in ids:
                        if check:
                            return False
                        raise AssertionError("unmappable co-located reference")
                    r0 = ids.index(cid)
                if not check:
                    self._set_ref(4 * bx, 4 * by, 4, 4, 0, r0)
                    self._set_ref(4 * bx, 4 * by, 4, 4, 1, 0)
            if not check:
                self._mark_done(8 * (b8 & 1), 8 * (b8 >> 1), 8, 8)
        return True

    def _skip_ok(self) -> bool:
        return self.kind != "B" or self._direct_refs(15, check=True)

    def _skip(self):
        st = self.pic_state
        st["flags"][self.cur_mb] = F_SKIP | (F_DIRECT16 if self.kind == "B" else 0)
        if self.kind == "B":
            st["direct8"][self.cur_mb] = 15
            self._direct_refs(15)
        else:
            self._set_ref(0, 0, 16, 16, 0, 0)
        self.last_dqp = False

    # ---- syntax elements ----
    def w_mb_type_i(self, t, in_i_slice, base):
        e = self.enc
        if e is None:
            return
        st = self.pic_state
        if in_i_slice:
            a, tp = self.mb_left(), self.mb_top()
            inc = (a >= 0 and not st["flags"][a] & (F_I4 | F_I8)) + (tp >= 0 and not st["flags"][tp] & (F_I4 | F_I8))
            e.decision(3 + inc, 0 if t == 0 else 1)
        else:
            e.decision(base, 0 if t == 0 else 1)
        if t == 0:
            return
        e.terminate(1 if t == 25 else 0)
        if t == 25:
            return
        s_ = 6 if in_i_slice else base + 1
        k = t - 1
        e.decision(s_, 1 if k >= 12 else 0)
        chroma = (k // 4) % 3
        e.decision(s_ + 1, 1 if chroma else 0)
        if chroma:
            e.decision(s_ + 2 if in_i_slice else s_ + 1, 1 if chroma == 2 else 0)
        pred = k % 4
        e.decision(s_ + 3 if in_i_slice else s_ + 2, pred >> 1)
        e.decision(s_ + 4 if in_i_slice else s_ + 2, pred & 1)

    def w_mb_type(self, kind: str, v: int):
        """v: I type (0..25) when kind is I, else the P or B type; intra in P/B as kind 'I'."""
        b, e = self.b, self.enc
        sk = self.kind
        if e is None:
            if sk == "I":
                b.ue(v)
            elif sk == "P":
                b.ue(v if kind == "P" else 5 + v)
            else:
                b.ue(v if kind == "B" else 23 + v)
            self.codes.add(("mb_type", sk, kind, v))
            return
        if sk == "I":
            return self.w_mb_type_i(v, True, 3)
        if sk == "P":
            if kind == "I":
                e.decision(14, 1)
                return self.w_mb_type_i(v, False, 17)
            e.decision(14, 0)
            if v in (0, 3):
                e.decision(15, 0)
                e.decision(16, 1 if v == 3 else 0)
            else:
                e.decision(15, 1)
                e.decision(17, 1 if v == 1 else 0)
            return
        st = self.pic_state
        a, t = self.mb_left(), self.mb_top()
        inc = (a >= 0 and not st["flags"][a] & F_DIRECT16) + (t >= 0 and not st["flags"][t] & F_DIRECT16)
        if kind == "B" and v == 0:
            e.decision(27 + inc, 0)
            return
        e.decision(27 + inc, 1)
        if kind == "B" and v in (1, 2):
            e.decision(30, 0)
            e.decision(32, v - 1)
            return
        e.decision(30, 1)
        if kind == "I":
            bits = 13
        elif v <= 10:
            bits = v - 3
        elif v == 11:
            bits = 14
        elif v == 22:
            bits = 15
        else:
            bits = None
        if bits is not None:
            e.decision(31, bits >> 3 & 1)
            e.decision(32, bits >> 2 & 1)
            e.decision(32, bits >> 1 & 1)
            e.decision(32, bits & 1)
            if kind == "I":
                self.w_mb_type_i(v, False, 32)
            return
        five = v + 4
        e.decision(31, five >> 4 & 1)
        e.decision(32, five >> 3 & 1)
        e.decision(32, five >> 2 & 1)
        e.decision(32, five >> 1 & 1)
        e.decision(32, five & 1)

    def w_sub_type(self, v):
        b, e = self.b, self.enc
        if e is None:
            b.ue(v)
            self.codes.add(("sub_mb_type", self.kind, v))
            return
        if self.kind == "P":
            if v == 0:
                e.decision(21, 1)
                return
            e.decision(21, 0)
            if v == 1:
                e.decision(22, 0)
                return
            e.decision(22, 1)
            e.decision(23, 1 if v == 2 else 0)
            return
        if v == 0:
            e.decision(36, 0)
            return
        e.decision(36, 1)
        if v in (1, 2):
            e.decision(37, 0)
            e.decision(39, v - 1)
            return
        e.decision(37, 1)
        if v >= 11:
            e.decision(38, 1)
            e.decision(39, 1)
            e.decision(39, v - 11)
            return
        if v >= 7:
            e.decision(38, 1)
            e.decision(39, 0)
            k = v - 7
        else:
            e.decision(38, 0)
            k = v - 3
        e.decision(39, k >> 1)
        e.decision(39, k & 1)

    def _is_direct4(self, x4, y4, mb):
        st = self.pic_state
        return bool(st["flags"][mb] & F_DIRECT16) or bool(st["direct8"][mb] >> (((y4 & 3) >> 1) * 2 + ((x4 & 3) >> 1)) & 1)

    def w_ref(self, l, px, py, v):
        n = self.num[l]
        if self.enc is None:
            if n - 1 == 1:
                self.b.bit(1 - v)
            else:
                self.b.ue(v)
            return
        x4, y4 = 4 * self.mbx + px // 4, 4 * self.mby + py // 4
        st = self.pic_state
        inc = 0
        for k in range(2):
            nx, ny = (x4, y4 - 1) if k else (x4 - 1, y4)
            mb = self.mb_at(nx, ny)
            if mb < 0 or st["flags"][mb] & (F_INTRA | F_SKIP):
                continue
            if self.kind == "B" and self._is_direct4(nx, ny, mb):
                continue
            if self.cur.ref[l, ny, nx] > 0:
                inc += 2 if k else 1
        for _ in range(v):
            self.enc.decision(54 + inc, 1)
            inc = 4 if inc < 4 else 5
        self.enc.decision(54 + inc, 0)

    def w_mvd(self, l, comp, px, py, v):
        if self.enc is None:
            self.b.se(v)
            return
        x4, y4 = 4 * self.mbx + px // 4, 4 * self.mby + py // 4
        mvd = self.pic_state["mvd"]
        s_ = 0
        if self.mb_at(x4 - 1, y4) >= 0:
            s_ += mvd[l, y4, x4 - 1, comp]
        if self.mb_at(x4, y4 - 1) >= 0:
            s_ += mvd[l, y4 - 1, x4, comp]
        base = 47 if comp else 40
        e = self.enc
        a = abs(v)
        e.decision(base + (0 if s_ < 3 else (1 if s_ <= 32 else 2)), 1 if a else 0)
        if not a:
            return
        ctx = base + 3
        k = 1
        while k < min(a, 9):
            e.decision(ctx, 1)
            if k < 4:
                ctx += 1
            k += 1
        if a < 9:
            e.decision(ctx, 0)
        else:
            e.eg(a - 9, 3)
        e.bypass(1 if v < 0 else 0)

    def w_cbp(self, cbp, intra_nxn):
        if self.enc is None:
            table = CBP_INTRA if intra_nxn else CBP_INTER
            k = table.index(cbp)
            self.b.ue(k)
            self.codes.add(("cbp", 0 if intra_nxn else 1, k))
            return
        st = self.pic_state
        a, t = self.mb_left(), self.mb_top()
        for b8 in range(4):
            if b8 & 1:
                ca = not (cbp >> (b8 - 1)) & 1
            else:
                ca = a >= 0 and not st["flags"][a] & F_PCM and not (st["cbp"][a] >> (b8 + 1)) & 1
            if b8 & 2:
                cb = not (cbp >> (b8 - 2)) & 1
            else:
                cb = t >= 0 and not st["flags"][t] & F_PCM and not (st["cbp"][t] >> (b8 + 2)) & 1
            self.enc.decision(73 + int(bool(ca)) + 2 * int(bool(cb)), (cbp >> b8) & 1)
        ca = (st["cbp"][a] >> 4) & 3 if a >= 0 else 0
        cb = (st["cbp"][t] >> 4) & 3 if t >= 0 else 0
        cc = (cbp >> 4) & 3
        self.enc.decision(77 + (ca != 0) + 2 * (cb != 0), 1 if cc else 0)
        if cc:
            self.enc.decision(77 + 4 + (ca == 2) + 2 * (cb == 2), 1 if cc == 2 else 0)

    def w_t8(self, v):
        if self.enc is None:
            self.b.bit(v)
            return
        st = self.pic_state
        a, t = self.mb_left(), self.mb_top()
        inc = (a >= 0 and bool(st["flags"][a] & F_T8)) + (t >= 0 and bool(st["flags"][t] & F_T8))
        self.enc.decision(399 + inc, v)

    def w_qp_delta(self, v):
        if self.enc is None:
            self.b.se(v)
        else:
            k = 2 * v - 1 if v > 0 else -2 * v
            ctx = 60 + (1 if self.last_dqp else 0)
            for _ in range(k):
                self.enc.decision(ctx, 1)
                ctx = 62 if ctx < 62 else 63
            self.enc.decision(ctx, 0)
        self.last_dqp = v != 0

    def w_chroma_mode(self, v):
        if self.enc is None:
            self.b.ue(v)
            return
        st = self.pic_state
        a, t = self.mb_left(), self.mb_top()
        inc = int(a >= 0 and st["chroma"][a] != 0) + int(t >= 0 and st["chroma"][t] != 0)
        self.enc.decision(64 + inc, 1 if v else 0)
        for k in range(1, 3):
            if v < k:
                break
            self.enc.decision(67, 1 if v > k else 0)

    def w_intra_mode(self, pred, mode):
        if self.enc is None:
            if mode == pred:
                self.b.bit(1)
            else:
                self.b.bit(0)
                self.b.u(3, mode if mode < pred else mode - 1)
            return
        if mode == pred:
            self.enc.decision(68, 1)
        else:
            self.enc.decision(68, 0)
            rem = mode if mode < pred else mode - 1
            for k in range(3):
                self.enc.decision(69, rem >> k & 1)

    def pred_intra_mode(self, x4, y4):
        st = self.pic_state
        a, b = self.mb_at(x4 - 1, y4), self.mb_at(x4, y4 - 1)
        ci = self.s.constrained_intra
        if a < 0 or b < 0 or (ci and not st["flags"][a] & F_INTRA) or (ci and not st["flags"][b] & F_INTRA):
            return 2
        ma = int(st["ipred"][y4, x4 - 1]) if st["flags"][a] & (F_I4 | F_I8) else 2
        mb = int(st["ipred"][y4 - 1, x4]) if st["flags"][b] & (F_I4 | F_I8) else 2
        return min(ma, mb)

    # ---- residual blocks ----
    def _record_cavlc(self, coeffs, nc, max_coeff):
        nz = [i for i, c in enumerate(coeffs) if c]
        tc = len(nz)
        table = -1 if nc < 0 else h264.token_table(nc)
        rev = [coeffs[i] for i in reversed(nz)]
        t1 = 0
        while t1 < 3 and t1 < tc and abs(rev[t1]) == 1:
            t1 += 1
        self.codes.add(("coeff_token", table, tc, t1))
        if not tc:
            return
        tz = nz[-1] + 1 - tc
        if tc < max_coeff:
            self.codes.add(("total_zeros", 4 if max_coeff == 4 else 16, tc, tz))
        left = tz
        for k in range(tc - 1):
            if left == 0:
                break
            run = nz[tc - 1 - k] - nz[tc - 2 - k] - 1
            self.codes.add(("run_before", min(left, 7), run))
            left -= run

    def w_residual(self, coeffs, max_coeff, cat, nc=None, cbf_inc=None) -> int:
        """coeffs in scan order; nc for CAVLC; cbf_inc (None: no coded_block_flag) for CABAC."""
        if self.enc is None:
            bits = h264.residual_block(coeffs, nc, max_coeff)
            assert bits is not None
            self.b.bits(bits)
            self._record_cavlc(coeffs, nc, max_coeff)
            return sum(1 for c in coeffs if c)
        e = self.enc
        nzpos = [i for i, c in enumerate(coeffs) if c]
        cbf_off, sig_off, abs_off = (0, 4, 8, 12, 16), (0, 15, 29, 44, 47), (0, 10, 20, 30, 39)
        if cat != 5:
            e.decision(85 + cbf_off[cat] + cbf_inc, 1 if nzpos else 0)
            if not nzpos:
                return 0
        sig_base = 402 if cat == 5 else 105 + sig_off[cat]
        last_base = 417 if cat == 5 else 166 + sig_off[cat]
        abs_base = 426 if cat == 5 else 227 + abs_off[cat]
        last = nzpos[-1]
        for i in range(max_coeff - 1):
            sig = 1 if coeffs[i] else 0
            e.decision(sig_base + (SIG8[i] if cat == 5 else (min(i, 2) if cat == 3 else i)), sig)
            if sig:
                e.decision(last_base + (LAST8[i] if cat == 5 else (min(i, 2) if cat == 3 else i)), 1 if i == last else 0)
                if i == last:
                    break
        gt1 = eq1 = 0
        for pos in reversed(nzpos):
            a = abs(coeffs[pos])
            v = a - 1
            inc0 = 0 if gt1 else min(4, 1 + eq1)
            if v == 0:
                e.decision(abs_base + inc0, 0)
            else:
                e.decision(abs_base + inc0, 1)
                incn = 5 + min(4 - (1 if cat == 3 else 0), gt1)
                for _ in range(1, min(v, 14)):
                    e.decision(abs_base + incn, 1)
                if v < 14:
                    e.decision(abs_base + incn, 0)
                else:
                    e.eg(v - 14, 0)
            e.bypass(1 if coeffs[pos] < 0 else 0)
            if a == 1:
                eq1 += 1
            else:
                gt1 += 1
        return len(nzpos)

    def cbf_inc(self, ma, fa, mb, fb):
        st = self.pic_state
        intra = bool(st["flags"][self.cur_mb] & F_INTRA)
        ca = int(intra) if ma < 0 else (1 if st["flags"][ma] & F_PCM else int(fa))
        cb = int(intra) if mb < 0 else (1 if st["flags"][mb] & F_PCM else int(fb))
        return ca + 2 * cb

    def nc_luma(self, x4, y4):
        nz = self.pic_state["nz"]
        a, b = self.mb_at(x4 - 1, y4), self.mb_at(x4, y4 - 1)
        na = nz[y4, x4 - 1] if a >= 0 else 0
        nb = nz[y4 - 1, x4] if b >= 0 else 0
        if a >= 0 and b >= 0:
            return int((na + nb + 1) >> 1)
        return int(na if a >= 0 else (nb if b >= 0 else 0))

    def chroma_mb(self, cx, cy):
        return -1 if cx < 0 or cy < 0 else self.mb_at(2 * cx, 2 * cy)

    def nzc_at(self, c, cx, cy):
        return int(self.pic_state["nzc"][c, ((cy >> 1) * self.mbw + (cx >> 1)) * 4 + (cy & 1) * 2 + (cx & 1)])

    def nc_chroma(self, c, cx, cy):
        a, b = self.chroma_mb(cx - 1, cy), self.chroma_mb(cx, cy - 1)
        na = self.nzc_at(c, cx - 1, cy) if a >= 0 else 0
        nb = self.nzc_at(c, cx, cy - 1) if b >= 0 else 0
        if a >= 0 and b >= 0:
            return (na + nb + 1) >> 1
        return na if a >= 0 else (nb if b >= 0 else 0)

    def luma_block(self, coeffs, max_coeff, cat, x4, y4):
        if self.enc is None:
            return self.w_residual(coeffs, max_coeff, cat, nc=self.nc_luma(x4, y4))
        nz = self.pic_state["nz"]
        a, b = self.mb_at(x4 - 1, y4), self.mb_at(x4, y4 - 1)
        inc = self.cbf_inc(a, a >= 0 and nz[y4, x4 - 1] > 0, b, b >= 0 and nz[y4 - 1, x4] > 0)
        return self.w_residual(coeffs, max_coeff, cat, cbf_inc=inc)

    # ---- random levels within the 16-bit bounds ----
    def _levels(self, n: int, must: bool = False) -> List[int]:
        """Random levels of a block of n coefficients in scan order: sparse, dense, every
        position, the high frequencies, the two ends, or every position at 2 or more."""
        r = self.rng
        mode = "sparse" if self.s.sparse else r.weighted(
            [("sparse", 3), ("dense", 2), ("full", 1), ("tail", 1), ("ends", 1), ("big", 0.5)])
        out = [0] * n
        if mode == "ends":
            for pos in (0, n - 1) if n > 1 else (0,):
                out[pos] = r.choice((-1, 1))
            if n > 2 and r.chance(0.5):
                out[r.int(1, n - 2)] = r.choice((-2, 2, 1, -1))
        else:
            k = {"sparse": r.int(0, min(n, 4)), "dense": r.int(max(1, n // 2), n), "tail": r.int(1, n),
                 "full": n, "big": n}[mode]
            positions = list(range(n))
            for pos in sorted(positions.pop(r.int(0, len(positions) - 1)) for _ in range(k)):
                if mode == "big":
                    mag = r.int(2, 20)
                elif self.s.sparse:
                    mag = 1
                else:
                    mag = r.weighted([(1, 6), (2, 2), (r.int(3, 8), 1.5), (r.int(9, 40), 0.6 * self.s.level_scale),
                                      (r.int(41, 300), 0.15 * self.s.level_scale)])
                out[pos] = mag if r.chance(0.5) else -mag
        if must and not any(out):
            out[r.int(0, n - 1)] = r.choice((-1, 1))
        return out

    def _target_levels(self, n: int, table: int) -> Optional[List[int]]:
        """CAVLC levels aimed at a coeff_token of `table` (and a total_zeros) no block of the
        stream has reached yet; None when every one is reached."""
        r = self.rng
        missing = [(tc, t1) for tc in range(n + 1) for t1 in range(min(tc, 3) + 1)
                   if ("coeff_token", table, tc, t1) not in self.codes]
        if not missing:
            return None
        tc, t1 = r.choice(missing)
        out = [0] * n
        if tc == 0:
            return out
        kind = 4 if n == 4 else 16
        tzs = [tz for tz in range(n - tc + 1) if ("total_zeros", kind, tc, tz) not in self.codes] if tc < n else [0]
        tz = r.choice(tzs) if tzs else r.int(0, n - tc)
        last = tc + tz - 1
        below = list(range(last))
        positions = sorted(below.pop(r.int(0, len(below) - 1)) for _ in range(tc - 1)) + [last]
        for k, pos in enumerate(reversed(positions)):  # highest frequency first
            if k < t1:
                mag = 1
            elif k == t1 and t1 < 3:
                mag = r.int(2, 3)
            else:
                mag = r.int(1, 3)
            out[pos] = mag if r.chance(0.5) else -mag
        return out

    def _block_levels(self, n: int, nc: Optional[int]) -> List[int]:
        """Levels of a block: for CAVLC (nc given) half the time aimed at a code not reached yet."""
        if nc is not None and self.enc is None and not self.s.sparse and self.rng.chance(0.5):
            got = self._target_levels(n, -1 if nc < 0 else h264.token_table(nc))
            if got is not None:
                return got
        return self._levels(n)

    def _fit4(self, coeffs_scan, start, qp, wlist, dc=None):
        """Shrink levels (scan order, from `start` of the zig-zag) until the block's scaled
        coefficients and transform stay within 16 bits."""
        w = self.wm4[wlist]
        while True:
            d = [0] * 16
            for k, c in enumerate(coeffs_scan):
                pos = ZZ4[start + k]
                d[pos] = _deq4(c, qp, w[pos], pos >> 2, pos & 3)
            if dc is not None:
                d[0] = dc
            if _idct4_fits(d):
                return coeffs_scan
            coeffs_scan = [c // 2 if abs(c) > 1 else (0 if self.rng.chance(0.5) else c) for c in coeffs_scan]

    def _fit8(self, coeffs_scan, qp, wlist, must):
        w = self.wm8[wlist]
        while True:
            d = [0] * 64
            for k, c in enumerate(coeffs_scan):
                pos = ZZ8[k]
                i, j = pos >> 3, pos & 7
                ls = w[pos] * _v8(qp % 6, i, j)
                d[pos] = (c * ls) << (qp // 6 - 6) if qp >= 36 else (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
            if _idct8_fits(d):
                if must and not any(coeffs_scan):
                    coeffs_scan = [0] * 64
                    coeffs_scan[0] = 1
                    continue
                return coeffs_scan
            coeffs_scan = [c // 2 if abs(c) > 1 else (0 if self.rng.chance(0.5) else c) for c in coeffs_scan]

    def _chroma_qp(self, qp, c):
        q = min(51, max(0, qp + self.cqp[c]))
        return q if q < 30 else h264.QPC[q - 30]

    # ---- macroblocks ----
    def _mb(self):
        r, s = self.rng, self.s
        st = self.pic_state
        mb = self.cur_mb
        k = self.kind
        choices = []
        if k == "I" or r.chance(INTRA_IN_INTER):
            kinds = [("I4", 3), ("I16", 3), ("PCM", s.pcm * 20)]
            if s.transform8x8:
                kinds.append(("I8", 3))
            ik = r.weighted(kinds)
            return self._intra_mb(ik, k != "I")
        if k == "P":
            choices = [(0, 3), (1, 2), (2, 2), (3, 2)]
            if not s.cabac:
                choices.append((4, 1))
            v = r.weighted(choices)
            return self._inter_mb("P", v)
        choices = [(0, 2), (22, 3)] + [(t, 1) for t in range(1, 22)]
        while True:
            v = r.weighted(choices)
            if v == 0 and not self._direct_refs(15, check=True):
                continue
            return self._inter_mb("B", v)

    def _intra_mb(self, ik, in_inter):
        r, s = self.rng, self.s
        st = self.pic_state
        mb = self.cur_mb
        x4, y4 = 4 * self.mbx, 4 * self.mby
        if ik == "PCM":
            self.w_mb_type("I", 25)
            b = self.b
            while not b.aligned():  # pcm_alignment_zero_bit
                b.bit(0)
            for _ in range(384):
                b.u(8, r.int(0, 255))
            st["flags"][mb] = F_INTRA | F_PCM
            st["cbp"][mb] = 0x2F | 0x700
            st["nz"][y4:y4 + 4, x4:x4 + 4] = 16
            st["nzc"][:, mb * 4:mb * 4 + 4] = 16
            self.last_dqp = False
            if self.enc is not None:
                self.enc.start()
            return
        A, B, D = self.intra_avail(x4 - 1, y4), self.intra_avail(x4, y4 - 1), self.intra_avail(x4 - 1, y4 - 1)
        if ik == "I16":
            modes = [2] + ([0] if B else []) + ([1] if A else []) + ([3] if A and B and D else [])
            mode = r.choice(modes)
            cl = r.weighted([(0, 1), (15, 1)])
            cc = r.int(0, 2)
            t = 1 + mode + 4 * cc + (12 if cl else 0)
            self.w_mb_type("I", t)
            st["flags"][mb] = F_INTRA | F_I16
            self._chroma_mode_choice(A, B, D)
            cbp = cl | (cc << 4)
            st["cbp"][mb] = cbp
            self._qp_and_residual(cbp, False, intra=True, i16=True)
            return
        t8 = ik == "I8"
        self.w_mb_type("I", 0)
        if s.transform8x8:
            self.w_t8(1 if t8 else 0)
        st["flags"][mb] = F_INTRA | (F_I8 | F_T8 if t8 else F_I4)
        # the modes, chosen among those the neighbours allow; the block order as decoded
        order = range(4) if t8 else range(16)
        for k in order:
            bx = 2 * (k & 1) if t8 else BLK_X[k]
            by = 2 * (k >> 1) if t8 else BLK_Y[k]
            size = 2 if t8 else 1
            ax, ay = x4 + bx, y4 + by
            a_ = self.intra_avail(ax - 1, ay)
            b_ = self.intra_avail(ax, ay - 1)
            d_ = self.intra_avail(ax - 1, ay - 1)
            modes = [2]
            if b_:
                modes += [0, 3, 7]
            if a_:
                modes += [1, 8]
            if a_ and b_ and d_:
                modes += [4, 5, 6]
            mode = r.choice(modes)
            pred = self.pred_intra_mode(ax, ay)
            self.w_intra_mode(pred, mode)
            st["ipred"][ay:ay + size, ax:ax + size] = mode
            self._mark_done(4 * bx, 4 * by, 4 * size, 4 * size)
        self.mask = 0
        self._chroma_mode_choice(A, B, D)
        cbp = self._cbp(True)
        self.w_cbp(cbp, True)
        st["cbp"][mb] = cbp
        self._qp_and_residual(cbp, t8, intra=True, i16=False)

    def _cbp(self, intra: bool) -> int:
        r = self.rng
        table = CBP_INTRA if intra else CBP_INTER
        missing = [k for k in range(48) if ("cbp", 0 if intra else 1, k) not in self.codes]
        if self.enc is None and missing and r.chance(0.9):
            return table[r.choice(missing)]
        return r.int(0, 47) if r.chance(0.85) else 0

    def _chroma_mode_choice(self, A, B, D):
        modes = [0] + ([1] if A else []) + ([2] if B else []) + ([3] if A and B and D else [])
        m = self.rng.choice(modes)
        self.w_chroma_mode(m)
        self.pic_state["chroma"][self.cur_mb] = m

    def _mvd(self):
        r = self.rng
        if r.chance(self.s.big_mvd):
            return r.choice((-1, 1)) * r.int(9, 200)
        return r.weighted([(0, 3), (r.int(-3, 3), 4), (r.int(-12, 12), 2)])

    def _inter_mb(self, kind, v):
        r, s = self.rng, self.s
        st = self.pic_state
        mb = self.cur_mb
        self.w_mb_type(kind, v)
        shape = None
        pred = [0, 0, 0, 0]
        sub_shape = [0, 0, 0, 0]
        ref0 = False
        if kind == "B" and v == 0:
            st["flags"][mb] = F_DIRECT16
            st["direct8"][mb] = 15
            shape = 4
        elif (kind == "B" and v == 22) or (kind == "P" and v >= 3):
            shape = 3
            ref0 = kind == "P" and v == 4
            subs = []
            for k in range(4):
                while True:
                    if kind == "P":
                        t = r.int(0, 3)
                        break
                    t = r.weighted([(0, 3)] + [(q, 1) for q in range(1, 13)])
                    if t == 0 and not self._direct_refs(1 << k, check=True):
                        continue
                    break
                subs.append(t)
                self.w_sub_type(t)
            for k, t in enumerate(subs):
                if kind == "P":
                    sub_shape[k], pred[k] = t, 1
                else:
                    sub_shape[k] = 0 if B_SUB[t][0] == 4 else B_SUB[t][0]
                    pred[k] = 4 if B_SUB[t][0] == 4 else B_SUB[t][1]
                    if pred[k] == 4:
                        st["direct8"][mb] |= 1 << k
        elif kind == "B":
            shape, pred[0], pred[1] = B_TYPES[v]
        else:
            shape, pred[0], pred[1] = v, 1, 1
        geoms = {0: [(0, 0, 16, 16)], 1: [(0, 0, 16, 8), (0, 8, 16, 8)], 2: [(0, 0, 8, 16), (8, 0, 8, 16)],
                 3: [(0, 0, 8, 8), (8, 0, 8, 8), (0, 8, 8, 8), (8, 8, 8, 8)], 4: []}[shape]
        refs = [[-1] * 4, [-1] * 4]
        for l in range(2):
            for k, (x, y, w, h) in enumerate(geoms):
                if pred[k] == 4 or not (pred[k] >> l) & 1:
                    continue
                ref = 0
                if self.num[l] > 1 and not ref0:
                    ref = r.int(0, self.num[l] - 1)
                    self.w_ref(l, x, y, ref)
                refs[l][k] = ref
                self._set_ref(x, y, w, h, l, ref)
        for l in range(2):
            for k, (x, y, w, h) in enumerate(geoms):
                if pred[k] == 4 or not (pred[k] >> l) & 1:
                    continue
                subs = SUB_GEOM[sub_shape[k]] if shape == 3 else ((0, 0, w, h),)
                for (sx, sy, sw, sh) in subs:
                    px, py = x + sx, y + sy
                    dx, dy = self._mvd(), self._mvd()
                    self.w_mvd(l, 0, px, py, dx)
                    self.w_mvd(l, 1, px, py, dy)
                    y0, x0 = 4 * self.mby + py // 4, 4 * self.mbx + px // 4
                    self.pic_state["mvd"][l, y0:y0 + sh // 4, x0:x0 + sw // 4] = (min(abs(dx), 127), min(abs(dy), 127))
        # the references of the direct blocks and of the lists a partition does not use
        for k, (x, y, w, h) in enumerate(geoms):
            if pred[k] == 4:
                self._direct_refs(1 << k)
            else:
                for l in range(2):
                    if not (pred[k] >> l) & 1:
                        self._set_ref(x, y, w, h, l, -1)
                self._mark_done(x, y, w, h)
        if shape == 4:
            self._direct_refs(15)
        cbp = self._cbp(False)
        self.w_cbp(cbp, False)
        st["cbp"][mb] = cbp
        t8 = False
        if cbp & 15 and s.transform8x8:
            ok = True
            if shape == 3:
                ok = all((pred[k] == 4 and s.direct_8x8_inference) or (pred[k] != 4 and sub_shape[k] == 0)
                         for k in range(4))
            if shape == 4 and not s.direct_8x8_inference:
                ok = False
            if ok:
                t8 = r.chance(0.5)
                self.w_t8(1 if t8 else 0)
        if t8:
            st["flags"][mb] |= F_T8
        self._qp_and_residual(cbp, t8, intra=False, i16=False)

    def _qp_and_residual(self, cbp, t8, intra, i16):
        r, s = self.rng, self.s
        st = self.pic_state
        mb = self.cur_mb
        if cbp or i16:
            dq = 0
            if r.chance(0.5):
                dq = r.weighted([(r.int(-2, 2), 6), (r.int(-8, 8), 2), (r.int(-26, 25), 0.3)])
                lo, hi = s.qp
                nq = (self.qp + dq + 52) % 52
                if not lo - 6 <= nq <= hi + 6 and not r.chance(0.1):
                    dq = 0
            self.w_qp_delta(dq)
            self.qp = (self.qp + dq + 52) % 52
        else:
            self.last_dqp = False
        qp = self.qp
        x4, y4 = 4 * self.mbx, 4 * self.mby
        wl = 0 if intra else 3
        if i16:
            # the DC: bounded through its Hadamard and scaling
            while True:
                dc = self._block_levels(16, self.nc_luma(x4, y4))
                c = [0] * 16
                for k in range(16):
                    c[ZZ4[k]] = dc[k]
                f = _hadamard4(c)
                ls = self.wm4[0][0] * h264.V[qp % 6][0]
                dcy = [(v * ls) << (qp // 6 - 6) if qp >= 36 else (v * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
                       for v in f]
                if all(abs(v) <= 8000 for v in f) and all(abs(v) <= 4000 for v in dcy):
                    break
            dc_of = {4 * BLK_Y[blk] + BLK_X[blk]: blk for blk in range(16)}
            dc_blk = [0] * 16
            for k in range(16):
                dc_blk[dc_of[k]] = dcy[k]
            if self.enc is None:
                self.w_residual(dc, 16, 0, nc=self.nc_luma(x4, y4))
            else:
                a, t = self.mb_left(), self.mb_top()
                inc = self.cbf_inc(a, a >= 0 and (st["cbp"][a] >> 8) & 1, t, t >= 0 and (st["cbp"][t] >> 8) & 1)
                if self.w_residual(dc, 16, 0, cbf_inc=inc):
                    st["cbp"][mb] |= 0x100
        for b8 in range(4):
            coded = (cbp >> b8) & 1
            if not coded:
                continue
            bx0, by0 = 2 * (b8 & 1), 2 * (b8 >> 1)
            if t8:
                lv = self._fit8(self._levels(64, must=self.enc is not None), qp, 0 if intra else 1,
                                must=self.enc is not None)
                if self.enc is None:
                    total = 0
                    for sb in range(4):
                        sub = [lv[4 * k + sb] for k in range(16)]
                        n = self.w_residual(sub, 16, 2, nc=self.nc_luma(x4 + bx0 + (sb & 1), y4 + by0 + (sb >> 1)))
                        st["nz"][y4 + by0 + (sb >> 1), x4 + bx0 + (sb & 1)] = n
                else:
                    n = self.w_residual(lv, 64, 5)
                    st["nz"][y4 + by0:y4 + by0 + 2, x4 + bx0:x4 + bx0 + 2] = n
                continue
            for sb in range(4):
                blk = 4 * b8 + sb
                bx, by = x4 + BLK_X[blk], y4 + BLK_Y[blk]
                nc = self.nc_luma(bx, by)
                if i16:
                    lv = self._fit4(self._block_levels(15, nc), 1, qp, 0, dc=dc_blk[blk])
                    n = self.luma_block(lv, 15, 1, bx, by)
                else:
                    lv = self._fit4(self._block_levels(16, nc), 0, qp, wl)
                    n = self.luma_block(lv, 16, 2, bx, by)
                st["nz"][by, bx] = n
        cc = (cbp >> 4) & 3
        dc_c = [[0] * 4, [0] * 4]
        if cc:
            for c in range(2):
                qpc = self._chroma_qp(qp, c)
                wlc = (1 if intra else 4) + c
                while True:
                    dc = self._block_levels(4, -1)
                    f = [dc[0] + dc[1] + dc[2] + dc[3], dc[0] - dc[1] + dc[2] - dc[3], dc[0] + dc[1] - dc[2] - dc[3],
                         dc[0] - dc[1] - dc[2] + dc[3]]
                    ls = self.wm4[wlc][0] * h264.V[qpc % 6][0]
                    dc_c[c] = [((v * ls) << (qpc // 6)) >> 5 for v in f]
                    if all(abs(v) <= 4000 for v in dc_c[c]):
                        break
                if self.enc is None:
                    self.w_residual(dc, 4, 3, nc=-1)
                else:
                    a, t = self.mb_left(), self.mb_top()
                    inc = self.cbf_inc(a, a >= 0 and (st["cbp"][a] >> (9 + c)) & 1, t,
                                       t >= 0 and (st["cbp"][t] >> (9 + c)) & 1)
                    if self.w_residual(dc, 4, 3, cbf_inc=inc):
                        st["cbp"][mb] |= 0x200 << c
        if cc == 2:
            for c in range(2):
                qpc = self._chroma_qp(qp, c)
                wlc = (1 if intra else 4) + c
                for blk in range(4):
                    cx, cy = 2 * self.mbx + (blk & 1), 2 * self.mby + (blk >> 1)
                    lv = self._fit4(self._block_levels(15, self.nc_chroma(c, cx, cy)), 1, qpc, wlc, dc=dc_c[c][blk])
                    if self.enc is None:
                        n = self.w_residual(lv, 15, 4, nc=self.nc_chroma(c, cx, cy))
                    else:
                        a, t = self.chroma_mb(cx - 1, cy), self.chroma_mb(cx, cy - 1)
                        inc = self.cbf_inc(a, a >= 0 and self.nzc_at(c, cx - 1, cy) > 0, t,
                                           t >= 0 and self.nzc_at(c, cx, cy - 1) > 0)
                        n = self.w_residual(lv, 15, 4, cbf_inc=inc)
                    st["nzc"][c, mb * 4 + blk] = n


def _hadamard4(c: List[int]) -> List[int]:
    t = [0] * 16
    for i in range(4):
        r = c[4 * i:4 * i + 4]
        t[4 * i:4 * i + 4] = [r[0] + r[1] + r[2] + r[3], r[0] + r[1] - r[2] - r[3], r[0] - r[1] - r[2] + r[3],
                              r[0] - r[1] + r[2] - r[3]]
    f = [0] * 16
    for j in range(4):
        a, b, c_, e = t[j], t[4 + j], t[8 + j], t[12 + j]
        f[j], f[4 + j], f[8 + j], f[12 + j] = a + b + c_ + e, a + b - c_ - e, a - b - c_ + e, a - b + c_ - e
    return f


# ---------------------------------------------------------------------------
# The container (written here, with options the product's muxer does not use)
# ---------------------------------------------------------------------------

TIMESCALE = 12800
FPS = 25


def _avcc(sps: Sequence[bytes], pps: Sequence[bytes], length_size: int, profile_sps: bytes) -> bytes:
    out = bytes([1, profile_sps[1], profile_sps[2], profile_sps[3], 0xFC | (length_size - 1), 0xE0 | len(sps)])
    for u in sps:
        out += struct.pack(">H", len(u)) + u
    out += bytes([len(pps)])
    for u in pps:
        out += struct.pack(">H", len(u)) + u
    return box(b"avcC", out)


def _unused_parameter_sets(sps: bytes, pps: bytes) -> Tuple[List[bytes], List[bytes]]:
    """An SPS of id 1 (the stream's, renumbered) and a PPS of id 1 that refers to it."""
    b = BitWriter()
    b.ue(1)
    b.ue(1)
    b.bits("1")  # CABAC
    b.bits("0")
    b.ue(0)
    b.ue(0)
    b.ue(0)
    b.bits("000")
    b.se(0)
    b.se(0)
    b.se(0)
    b.bits("100")
    b.trailing()
    rbsp = h264.remove_emulation_prevention(sps[1:])
    bits = format(int.from_bytes(rbsp, "big"), f"0{8 * len(rbsp)}b")
    # seq_parameter_set_id is the ue(v) after the 24 bits of profile, constraints and level: 0 ("1") -> 1 ("010")
    assert bits[24] == "1"
    bits = bits[:24] + "010" + bits[25:]
    bits = bits[:bits.rindex("1")]
    w = BitWriter()
    w.bits(bits)
    w.trailing()
    return [h264.nal(7, w.data())], [h264.nal(8, b.data())]


def write_mp4(path: str, spec: Spec, sps: bytes, pps: bytes, samples: List[bytes], plans: List[PicPlan],
              reorder: int) -> None:
    """The samples (decoding order) in an mp4 with the spec's container options: ctts
    and an edit list where frames are reordered or `edit_start` skips frames, avc3
    with the parameter sets in band, stco or co64, `chunk` samples a chunk, moov
    first or last."""
    T = len(samples)
    tick = TIMESCALE // FPS
    # global output positions: each IDR period follows the previous one
    display, base, seg = [], 0, 0
    for p in plans:
        if p.idr:
            base = seg
        display.append(base + p.display)
        seg = max(seg, base + p.display + 1)
    shift = 0 if spec.ctts_v1 else reorder * tick
    dts = [i * tick for i in range(T)]
    pts = [d * tick + shift for d in display]
    offsets = [p - d for p, d in zip(pts, dts)]
    if spec.sample_entry == "avc3":  # parameter sets in band, before each IDR picture
        n = spec.length_size
        samples = [(len(sps).to_bytes(n, "big") + sps + len(pps).to_bytes(n, "big") + pps + s) if p.idr else s
                   for s, p in zip(samples, plans)]
    chunks = [samples[i:i + spec.chunk] for i in range(0, T, spec.chunk)]
    width, height = spec.width, spec.height

    def moov(chunk_offsets: List[int]) -> bytes:
        in_band = spec.sample_entry == "avc3"
        extra = _unused_parameter_sets(sps, pps) if spec.extra_parameter_sets else ([], [])
        avcc = _avcc(([] if in_band else [sps]) + extra[0], ([] if in_band else [pps]) + extra[1], spec.length_size,
                     sps)
        entry = box(spec.sample_entry.encode(), bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHII", width, height, 0x480000, 0x480000), bytes(4), struct.pack(">H", 1),
                    bytes(32), struct.pack(">Hh", 0x18, -1), avcc)
        stts = full_box(b"stts", 0, 0, struct.pack(">3I", 1, T, tick))
        tables = stts
        if any(offsets):
            runs = []
            for o in offsets:
                if runs and runs[-1][1] == o:
                    runs[-1][0] += 1
                else:
                    runs.append([1, o])
            tables += full_box(b"ctts", 1 if spec.ctts_v1 else 0, 0, struct.pack(">I", len(runs)),
                               *(struct.pack(">Ii", c, o) for c, o in runs))
        sync = [i + 1 for i, p in enumerate(plans) if p.idr]
        tables += full_box(b"stss", 0, 0, struct.pack(f">{len(sync) + 1}I", len(sync), *sync))
        runs = []
        for i, c in enumerate(chunks):
            if not runs or runs[-1][1] != len(c):
                runs.append((i + 1, len(c)))
        tables += full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)), *(struct.pack(">3I", a, n, 1) for a, n in runs))
        tables += full_box(b"stsz", 0, 0, struct.pack(f">{T + 2}I", 0, T, *(len(s) for s in samples)))
        if spec.co64:
            tables += full_box(b"co64", 0, 0, struct.pack(f">I{len(chunks)}Q", len(chunks), *chunk_offsets))
        else:
            tables += full_box(b"stco", 0, 0, struct.pack(f">I{len(chunks)}I", len(chunks), *chunk_offsets))
        shown = spec.edit_frames or len(set(display)) - spec.edit_start
        movie = shown * 1000 // FPS
        cos, sin = {0: (1, 0), 90: (0, 1), 180: (-1, 0), 270: (0, -1)}[spec.rotation]
        tkhd = full_box(b"tkhd", 0, 3, struct.pack(">5I", 0, 0, 1, 0, movie), bytes(8), struct.pack(">hhhH", 0, 0, 0, 0),
                        struct.pack(">9i", cos << 16, sin << 16, 0, -sin << 16, cos << 16, 0, 0, 0, 0x40000000),
                        struct.pack(">II", width << 16, height << 16))
        edts = b""
        if shift or spec.edit_start or spec.edit_frames:
            edts = box(b"edts", full_box(b"elst", 0, 0, struct.pack(">IIIHH", 1, movie, shift + spec.edit_start * tick,
                                                                   1, 0)))
        mdhd = full_box(b"mdhd", 0, 0, struct.pack(">4I", 0, 0, TIMESCALE, T * tick), struct.pack(">HH", 0x55C4, 0))
        hdlr = full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", bytes(12), b"VideoHandler\0")
        dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), full_box(b"url ", 0, 1)))
        minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)), dinf,
                   box(b"stbl", full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry), tables))
        trak = box(b"trak", tkhd, edts, box(b"mdia", mdhd, hdlr, minf))
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(">4I", 0, 0, 1000, movie), struct.pack(">IH", 0x10000, 0x100),
                        bytes(10), struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000), bytes(24),
                        struct.pack(">I", 2))
        return box(b"moov", mvhd, trak)

    ftyp = box(b"ftyp", spec.brand, struct.pack(">I", 512), b"isomiso2avc1mp41" if spec.brand == b"isom" else b"qt  ")
    payload = b"".join(b"".join(c) for c in chunks)
    mdat_head = 16 if spec.co64 else 8

    def layout(mdat_at: int) -> List[int]:
        at, out = mdat_at + mdat_head, []
        for c in chunks:
            out.append(at)
            at += sum(len(s) for s in c)
        return out

    mdat = (struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 16 + len(payload)) if spec.co64
            else struct.pack(">I", 8 + len(payload)) + b"mdat") + payload
    if spec.moov_last:
        data = ftyp + mdat + moov(layout(len(ftyp)))
    else:
        size = len(moov(layout(0)))
        data = ftyp + moov(layout(len(ftyp) + size)) + mdat
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------

FIXTURES: Dict[str, Spec] = {
    "i_cavlc_scaling": Spec(96, 64, ip_plan(10, idr_every=4), profile=100, transform8x8=True, scaling="both",
                            pcm=0.05, qp=(0, 40), slices=(1, 2)),
    "p_cavlc_partitions": Spec(96, 64, ip_plan(8), profile=77, max_refs=4, refs_active=(4, 1), big_mvd=0.15,
                               skip=0.25, qp=(14, 30), level_scale=2.0),
    "p_weighted": Spec(80, 48, ip_plan(6), profile=100, weighted_pred=True, refs_active=(3, 1), max_refs=3,
                       constrained_intra=True, transform8x8=True),
    "deblock_slices": Spec(96, 64, ip_plan(5), profile=77, slices=(2, 4), deblock=(0, 2, 1, 0, 2),
                           deblock_offsets=True, qp=(26, 51), refs_active=(2, 1), max_refs=2),
    "cabac_i": Spec(64, 64, ip_plan(4, idr_every=2), cabac=True, profile=100, transform8x8=True, scaling="sps",
                    pcm=0.05, qp=(0, 45), slices=(1, 2), level_scale=3.0),
    "cabac_p": Spec(90, 62, ip_plan(8), cabac=True, profile=100, transform8x8=True, refs_active=(4, 1),
                    max_refs=4, crop_top=2, skip=0.25, qp=(10, 40), big_mvd=0.1, level_scale=2.0),
    "cabac_b_spatial": Spec(80, 64, b_plan(3, 3, pyramid=True), cabac=True, profile=100, transform8x8=True,
                            weighted_bipred=2, direct_spatial=True, refs_active=(3, 2), max_refs=4,
                            edit_start=1, qp=(16, 36), big_mvd=0.1),
    "cabac_b_temporal": Spec(64, 48, b_plan(3, 2, pyramid=False), cabac=True, profile=100, transform8x8=True,
                             weighted_bipred=1, direct_spatial=False, direct_8x8_inference=False,
                             refs_active=(2, 2), max_refs=4, qp=(16, 36)),
    "long_term_mmco": Spec(64, 48, ip_plan(14, mmco=True, long_first=True), profile=77, max_refs=4,
                           refs_active=(4, 1), list_mods=True),
    "poc_type_0": Spec(64, 48, b_plan(2, 2, pyramid=False), profile=77, poc_type=0, refs_active=(2, 1)),
    "poc_type_1": Spec(64, 48, b_plan(2, 3, pyramid=True), profile=77, poc_type=1, refs_active=(2, 2),
                       direct_spatial=False),
    "poc_type_2": Spec(64, 48, ip_plan(6, non_ref_every=3), profile=66, poc_type=2, refs_active=(1, 1)),
    "vui_bt709_full": Spec(64, 48, ip_plan(3), profile=100, full_range=True, matrix=1),
    "vui_bt709_limited": Spec(64, 48, ip_plan(3), profile=100, matrix=1),
    "avc3_short_lengths": Spec(48, 32, ip_plan(4), cabac=True, profile=77, sample_entry="avc3", length_size=2,
                               moov_last=True, co64=True, chunk=3),
}


# chip_smoke.py's stream: 512^2, CABAC, I P B B with implicit weights, and the sha256 of its
# luma planes as FFmpeg decodes them (tests/test_torch_h264_decode.py holds the constant to FFmpeg)
DIGEST_SPEC = Spec(512, 512, b_plan(1, 2, pyramid=False), cabac=True, profile=100, transform8x8=True,
                   weighted_bipred=2, refs_active=(2, 1), max_refs=3, qp=(26, 34), pcm=0.0, big_mvd=0.02)
DIGEST_SEED = 512
DIGEST_LUMA_SHA256 = "31c58967ce526555cbf971fecfe96af67223875b4d3fbc832e0ff3d046b34624"


def luma_digest(planes) -> str:
    """sha256 of the luma planes, one after another."""
    import hashlib

    h = hashlib.sha256()
    for y in planes:
        h.update(np.ascontiguousarray(y, np.uint8).tobytes())
    return h.hexdigest()


@dataclass
class Written:
    path: str
    frames: int  # in the file's output (what cv2 yields)
    contexts: frozenset
    codes: frozenset
    cabac: bool


def write_stream(spec: Spec, path: str, seed: int = 0) -> Written:
    w = _Writer(spec, seed)
    sps, pps, samples, plans = w.stream()
    reorder = w.reorder_depth()
    write_mp4(path, spec, sps, pps, samples, plans, reorder)
    return Written(path, spec.edit_frames or len(samples) - spec.edit_start, frozenset(w.contexts),
                   frozenset(w.codes), spec.cabac)


def write_fixture(name: str, path: str, seed: int = 0) -> Written:
    return write_stream(FIXTURES[name], path, seed)


# ---------------------------------------------------------------------------
# The referee: FFmpeg's decoder inside cv2, in a subprocess
# ---------------------------------------------------------------------------

_REFEREE = r"""
import sys
import cv2
import numpy as np

path, out = sys.argv[1], sys.argv[2]
planes = []
for raw in (True, False):
    cap = cv2.VideoCapture(path)
    if raw:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img.copy())
    cap.release()
    planes.append(frames)
np.savez(out, y=np.array(planes[0]), bgr=np.array(planes[1]))
"""


@dataclass
class Referee:
    y: np.ndarray  # [T, H, W] FFmpeg's luma planes
    bgr: np.ndarray  # [T, H, W, 3] cv2's BGR
    problems: List[str]  # FFmpeg's errors and warnings


def ffmpeg_decode(path: str, timeout: float = 120) -> Referee:
    """cv2.VideoCapture's frames of `path` (luma planes, then BGR), with every line that
    FFmpeg logged at the error or warning level (OPENCV_FFMPEG_DEBUG lets its log through)."""
    out = str(path) + ".referee.npz"
    env = dict(os.environ, OPENCV_FFMPEG_DEBUG="1")
    run = subprocess.run([sys.executable, "-c", _REFEREE, str(path), out], capture_output=True, text=True,
                         timeout=timeout, env=env)
    if run.returncode:
        raise RuntimeError(f"the referee failed on {path}: {run.stderr[-2000:]}")
    problems = []
    for line in (run.stdout + run.stderr).splitlines():
        if line.startswith("[OPENCV:FFMPEG:"):
            level = int(line.split(":")[2].split("]")[0])
            if level <= 24:
                problems.append(line)
    got = np.load(out)
    os.unlink(out)
    return Referee(got["y"], got["bgr"], problems)


def main(argv=None):
    out_dir = (argv or sys.argv[1:] or ["h264_fixtures"])[0]
    os.makedirs(out_dir, exist_ok=True)
    for name in FIXTURES:
        w = write_fixture(name, os.path.join(out_dir, f"{name}.mp4"))
        ref = ffmpeg_decode(w.path)
        print(json.dumps({"name": name, "frames": w.frames, "ffmpeg_frames": len(ref.y), "problems": ref.problems[:5]}))


if __name__ == "__main__":
    main()
