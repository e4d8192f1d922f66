"""The pieces of the H.264 kernel's design (csrc/h264_intra.cu) held to the
plain encoder (data/h264.py) on the CPU:

- `cavlc_bits`, the length-only CAVLC that the kernel's chain counts to
  decide the I_PCM escape, equals len(residual_block(...)) (and is None
  where it is) on seeded blocks of every class: each coeff_token table of
  nC, the chroma DC, 15 and 16 coefficients, levels past the escape;
- the core transform is exactly linear: forward4x4(src) - forward4x4(pred)
  equals forward4x4(src - pred) for DC and Horizontal predictions, whose
  transforms are the DC term alone and the first coefficient column alone
  (what the chain subtracts from the pre-pass's coefficients);
- the kernel's emulation-prevention rule (0x03 before a byte <= 3 that
  follows an even run of two or more zero bytes) equals
  `emulation_prevention`'s scan on byte strings dense in zero runs;
- `frame_slices` (the plain version of the kernel's framed units) then the
  wrapper's compaction and per-frame split equal `access_units`, on random
  slices dense in zero runs and on testing.emulation_prevention_frames
  (the frames chip_smoke.py frames on the card), whose slices need three
  emulation-prevention bytes.
"""

import numpy as np
import pytest
import torch

from genefaceplusplus_tpu_torch.data import h264
from genefaceplusplus_tpu_torch.ops import h264_encode
from genefaceplusplus_tpu_torch.testing import EP_QP, emulation_prevention_frames

# (nC, max_coeff, level scale): nC 0-1, 2-3, 4-7 and >= 8 pick coeff_token's
# four tables, -1 the chroma DC's; a scale of 5,000 puts levels past the
# escape (level_prefix > 15 in the Baseline profile)
CAVLC_CLASSES = {
    "nc0_ac15": (0, 15, 3), "nc1_dc16": (1, 16, 12), "nc2_ac15": (2, 15, 2), "nc3_dc16": (3, 16, 40),
    "nc5_ac15": (5, 15, 6), "nc7_dc16": (7, 16, 1), "nc8_ac15": (8, 15, 30), "nc16_dc16": (16, 16, 200),
    "chroma_dc4": (-1, 4, 9), "nc0_escape": (0, 15, 5000), "nc9_escape": (9, 16, 9000),
}


@pytest.mark.parametrize("case", list(CAVLC_CLASSES))
def test_cavlc_bits_counts_residual_block(case):
    nc, max_coeff, scale = CAVLC_CLASSES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    nones = 0
    for _ in range(300):
        density = rs.rand()
        coeffs = [int(rs.randint(-scale, scale + 1)) if rs.rand() < density else 0 for _ in range(max_coeff)]
        if rs.rand() < 0.3:  # trailing ones
            coeffs = [int(np.sign(c)) if abs(c) > 1 and rs.rand() < 0.7 else c for c in coeffs]
        bits = h264.residual_block(coeffs, nc, max_coeff)
        assert h264.cavlc_bits(coeffs, nc, max_coeff) == (None if bits is None else len(bits)), coeffs
        nones += bits is None
    assert (nones > 0) == (scale > 4096)


@pytest.mark.parametrize("mode", ["dc", "horizontal", "dc128"])
def test_transform_is_linear_in_the_prediction(mode):
    rs = np.random.RandomState({"dc": 1, "horizontal": 2, "dc128": 3}[mode])
    src = torch.from_numpy(rs.randint(0, 256, (500, 4, 4)).astype(np.int32))
    if mode == "horizontal":  # each row i the left neighbour's sample of that row
        left = torch.from_numpy(rs.randint(0, 256, (500, 4)).astype(np.int32))
        pred = left[:, :, None].expand(500, 4, 4)
    else:
        p = torch.full((500,), 128, dtype=torch.int32) if mode == "dc128" else \
            torch.from_numpy(rs.randint(0, 256, 500).astype(np.int32))
        pred = p[:, None, None].expand(500, 4, 4)
    fp = h264.forward4x4(pred)
    assert torch.equal(h264.forward4x4(src) - fp, h264.forward4x4(src - pred))
    if mode == "horizontal":  # the first column only: 4 x the 1-D transform of the left samples
        a, b, c, d = left.unbind(-1)
        assert torch.equal(fp[..., 0], 4 * torch.stack(h264._fwd1(a, b, c, d), -1))
        assert not fp[..., 1:].any()
    else:  # the DC term only: 16 x the prediction
        assert torch.equal(fp[:, 0, 0], 16 * pred[:, 0, 0])
        assert not fp.reshape(500, 16)[:, 1:].any()


def _kernel_rule(rbsp: bytes) -> bytes:
    """The kernel's emulation prevention, byte by byte: 0x03 before a byte
    <= 3 whose run of preceding zero bytes is even and at least two."""
    out, last = bytearray(), -1  # the last non-zero byte's index (-1: the NAL header byte)
    for j, b in enumerate(rbsp):
        zeros = j - last - 1
        if b <= 3 and zeros >= 2 and zeros % 2 == 0:
            out.append(3)
        out.append(b)
        if b:
            last = j
    return bytes(out)


def _zero_dense(rs, n: int) -> bytes:
    """n bytes, mostly zero runs and small values, the last one non-zero
    (an RBSP ends in its stop bit)."""
    b = rs.choice([0, 0, 0, 0, 1, 2, 3, 4, 0x80, 0xFF], n).astype(np.uint8)
    b[-1] = rs.randint(1, 256)
    return b.tobytes()


def test_emulation_prevention_rule():
    rs = np.random.RandomState(7)
    inserted = 0
    for n in list(range(1, 40)) + [200] * 40:
        rbsp = _zero_dense(rs, n)
        assert _kernel_rule(rbsp) == h264.emulation_prevention(rbsp), rbsp.hex()
        inserted += len(_kernel_rule(rbsp)) - n
    assert inserted > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_framing_and_compaction_equal_access_units(seed):
    rs = np.random.RandomState(seed)
    frames, slices, width = 3, 4, 64
    nbytes = rs.randint(1, h264.row_bytes(width) + 1, frames * slices)
    rows = np.zeros((frames * slices, h264.row_bytes(width)), np.uint8)
    for s, n in enumerate(nbytes):
        rows[s, :n] = np.frombuffer(_zero_dense(rs, int(n)), np.uint8)
    rows, bits = torch.from_numpy(rows), torch.from_numpy((8 * nbytes).astype(np.int32))
    units, lengths = h264.frame_slices(rows, bits)
    assert units.shape == (frames * slices, h264.unit_bytes(width)) and h264.unit_bytes(width) % 16 == 0
    want = h264.access_units(rows, bits, frames)
    assert h264_encode.split_access_units(h264_encode.copy_units(units, lengths), frames) == want
    assert int(lengths.sum()) > int(nbytes.sum()) + 5 * frames * slices  # emulation prevention inserted bytes


def test_framing_of_the_chip_smoke_frames():
    frames = torch.from_numpy(emulation_prevention_frames())
    enc = h264.encode_plain(frames, 0, EP_QP)
    want = h264.access_units(enc.rows, enc.bits, 2)
    units, lengths = h264_encode.h264_intra(frames, 0, EP_QP)  # the CPU route: encode_plain + frame_slices
    assert h264_encode.split_access_units(h264_encode.copy_units(units, lengths), 2) == want
    rbsp_bytes = int(((enc.bits + 7) // 8).sum())
    assert sum(map(len, want)) - rbsp_bytes - 5 * enc.bits.numel() == 3
    with pytest.raises(ValueError, match="whole units"):
        h264_encode.split_access_units(b"".join(want)[:-1], 2)
