"""The port's H.264 intra encoder (data/h264.py, the plain version of
csrc/h264_intra.cu) against FFmpeg's decoder, which cv2 carries here:

- every frame of every stream decodes, at its size and 25 fps, and
  FFmpeg's luma plane (cv2 with CAP_PROP_CONVERT_RGB off) equals
  `decode_own`'s exactly; the luma recomputed from cv2's BGR stays within
  30 dB PSNR of it (a wrong CAVLC table derails the stream by far more);
- `decode_own` equals the encoder's reconstruction exactly (Y, Cb, Cr);
- 64x48, 200x136 (cropped), 256^2 from data/synthetic_face.py, QP 0 to 51,
  and flat-and-noisy frames at QP 4 whose noisy macroblocks take the I_PCM
  escape (lossless) beside coded ones;
- the kernel's tables as compiled (csrc/h264_intra.cu's arrays) equal the
  plain version's; `decode_own` raises naming what lies outside the subset.

cv2 is imported only here, with pytest.importorskip; the port imports none.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genefaceplusplus_tpu_torch.data import h264
from genefaceplusplus_tpu_torch.data.mp4 import Mp4Muxer, read_mp4_track
from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
from genefaceplusplus_tpu_torch.ops import h264_encode

BGR_LUMA_MIN_PSNR = 30.0  # dB, luma from cv2's BGR (its own chroma upsampling) vs the decoded Y plane


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def face_frames(n: int, size: int, seed: int) -> np.ndarray:
    ds = synthetic_face(num_frames=n, size=size, seed=seed)
    return np.stack([s["gt_img"] for s in ds["train_samples"] + ds["val_samples"]])[:n]


def write_mp4(path, frames: np.ndarray, qp: int = h264.QP):
    """frames through encode_plain and the muxer; returns the encoder's output."""
    B, H, W, _ = frames.shape
    enc = h264.encode_plain(torch.from_numpy(np.ascontiguousarray(frames)), 0, qp)
    mux = Mp4Muxer(str(path))
    mux.open(H, W, *h264.sps_pps(H, W))
    for au in h264.access_units(enc.rows, enc.bits, B):
        mux.append(au)
    mux.close()
    return enc


def cv2_frames(path, raw: bool):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    if raw:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)  # FFmpeg's yuv420p frame: its luma plane
    fps, out = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img.copy())
    cap.release()
    return fps, out


def flat_and_noisy(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Noise in the even macroblock columns, flat grey in the odd ones: each
    flat macroblock is predicted from a noisy (I_PCM) left neighbour."""
    rs = np.random.RandomState(seed)
    frames = np.full((n, h, w, 3), 90, np.uint8)
    noisy = (np.arange(w) // 16) % 2 == 0
    frames[:, :, noisy] = rs.randint(0, 256, (n, h, int(noisy.sum()), 3))
    return frames


CASES = {
    "face_64x48": lambda: (face_frames(3, 64, 1)[:, :48], h264.QP),
    "face_200x136_cropped": lambda: (face_frames(3, 200, 2)[:, 30:166], h264.QP),
    "face_256": lambda: (face_frames(3, 256, 3), h264.QP),
    "face_qp0": lambda: (face_frames(2, 64, 4), 0),
    "face_qp51": lambda: (face_frames(2, 64, 5)[:, :, :48], 51),
    "flat_noisy_pcm": lambda: (flat_and_noisy(3, 48, 96, 6), 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ffmpeg_decodes_every_frame_as_decode_own(tmp_path, case):
    frames, qp = CASES[case]()
    T, H, W, _ = frames.shape
    path = tmp_path / "v.mp4"
    enc = write_mp4(path, frames, qp)
    track = read_mp4_track(str(path))
    assert (track.height, track.width, track.fps, len(track.samples)) == (H, W, 25.0, T)
    own = [h264.decode_own(s, track.sps, track.pps) for s in track.samples]
    for i, d in enumerate(own):  # the decoder rebuilds the encoder's reconstruction
        np.testing.assert_array_equal(d.y, enc.recon[0][i, :H, :W].numpy())
        np.testing.assert_array_equal(d.cb, enc.recon[1][i, :H // 2, :W // 2].numpy())
        np.testing.assert_array_equal(d.cr, enc.recon[2][i, :H // 2, :W // 2].numpy())
    fps, raw = cv2_frames(path, raw=True)
    assert fps == 25.0 and len(raw) == T
    for r, d in zip(raw, own):
        np.testing.assert_array_equal(r, d.y)  # FFmpeg's luma plane, exactly
    _, bgr = cv2_frames(path, raw=False)
    assert len(bgr) == T and all(f.shape == (H, W, 3) for f in bgr)
    for f, d in zip(bgr, own):
        assert psnr(h264.luma(f[..., ::-1]), d.y) >= BGR_LUMA_MIN_PSNR
    pcm = np.stack([d.pcm for d in own])
    if case == "flat_noisy_pcm":  # the noisy macroblocks take the escape (lossless), the flat ones are coded
        assert pcm[:, :, 0::2].all() and not pcm[:, :, 1::2].any()
        np.testing.assert_array_equal(np.stack([d.y for d in own])[:, :, :16], h264.luma(frames)[:, :, :16])
    else:
        assert not pcm.any()


def test_luma_psnr_on_synthetic_faces():
    """At the default QP the port's luma stands >= 40 dB from the source's
    on synthetic_face frames (the bound test_torch_mp4.py holds JAX to)."""
    frames = face_frames(2, 256, 7)
    enc = h264.encode_plain(torch.from_numpy(frames))
    for i in range(2):
        assert psnr(enc.recon[0][i].numpy(), h264.luma(frames[i])) >= 40.0


def test_idr_pic_id_alternates_and_first_index_counts():
    frames = torch.from_numpy(face_frames(2, 32, 8))
    a = h264.encode_plain(frames, 0)
    b = h264.encode_plain(frames[1:], 1)
    # frame 1 of a clip starting at 0 is the same picture as frame 0 of a chunk starting at 1
    mbh = 2
    assert torch.equal(a.rows[mbh:], b.rows) and torch.equal(a.bits[mbh:], b.bits)
    assert not torch.equal(a.rows[:mbh], a.rows[mbh:])  # idr_pic_id 0 then 1 (and the pictures differ)
    assert a.rows.shape == (2 * mbh, h264.row_bytes(32)) and (a.bits % 8 == 0).all()
    units, lengths = h264_encode.h264_intra(frames, 0)  # the CPU route: the plain versions, the kernel's layout
    want_units, want_lengths = h264.frame_slices(a.rows, a.bits)
    assert torch.equal(units, want_units) and torch.equal(lengths, want_lengths)
    assert units.shape == (2 * mbh, h264.unit_bytes(32))
    assert h264_encode.encode_access_units(frames, 0) == h264.access_units(a.rows, a.bits, 2)


def _cu_array(src: str, name: str) -> list:
    """A constant array of the CUDA source, flattened with its zero padding."""
    m = re.search(r"__constant__ \w+ " + name + r"((?:\[\d+\])+) = (\{.*?\});", src, re.S)
    dims = [int(x) for x in re.findall(r"\d+", m.group(1))]
    nested = ast.literal_eval(m.group(2).replace("{", "[").replace("}", "]"))

    def flat(v, dims):
        if len(dims) == 1:
            return list(v) + [0] * (dims[0] - len(v))
        return [x for sub in list(v) + [[]] * (dims[0] - len(v)) for x in flat(sub, dims[1:])]

    return flat(nested, dims)


def test_kernel_tables_equal_the_plain_versions():
    """What `_library` compares when the kernel loads, read here from the source."""
    src = Path(h264_encode.SOURCE).read_text()
    names = ("TOKEN_LEN", "TOKEN_BITS", "DC_TOKEN_LEN", "DC_TOKEN_BITS", "TZ_LEN", "TZ_BITS", "DC_TZ_LEN",
             "DC_TZ_BITS", "RUN_LEN", "RUN_BITS", "MF", "V", "QPC", "ZIGZAG", "BLK_X", "BLK_Y")
    assert [x for n in names for x in _cu_array(src, n)] == h264_encode.kernel_tables()


def test_codes_levels_and_framing():
    assert [h264.ue(v) for v in range(4)] == ["1", "010", "011", "00100"]
    assert [h264.se(v) for v in (0, 1, -1, 2)] == ["1", "010", "011", "00100"]
    assert [h264.level_idc(h, w) for h, w in ((48, 64), (512, 512), (512, 1536), (1080, 1920))] == [10, 30, 31, 40]
    raw = b"\x00\x00\x00\x00\x00\x01\x00\x00\x03\x07\x00\x00"
    ep = h264.emulation_prevention(raw)
    assert ep == b"\x00\x00\x03\x00\x00\x03\x00\x01\x00\x00\x03\x03\x07\x00\x00"
    assert h264.remove_emulation_prevention(ep) == raw
    b = h264._Bits(bytes([0b00111010]))
    assert (b.ue(), b.se()) == (6, 1)
    with pytest.raises(ValueError, match="even"):
        h264.padded_size(47, 64)


def _au(header_bits: str, body_bits: str = "") -> bytes:
    unit = h264.nal(h264.NAL_IDR, h264._rbsp(header_bits + body_bits))
    return len(unit).to_bytes(4, "big") + unit


def test_decode_own_raises_outside_the_subset():
    sps, pps = h264.sps_pps(16, 16)
    with pytest.raises(NotImplementedError, match="profile_idc 77"):
        h264.parse_sps(sps[:1] + bytes([77]) + sps[2:])
    cabac = h264.nal(h264.NAL_PPS, h264._rbsp(h264.ue(0) + h264.ue(0) + "1" + "0" * 20))
    with pytest.raises(NotImplementedError, match="CABAC"):
        h264.check_pps(cabac)
    head = h264.ue(0) + "{}" + h264.ue(0) + "0000" + h264.ue(0) + "00" + h264.se(0) + "{}"
    with pytest.raises(NotImplementedError, match="P, B"):
        h264.decode_own(_au(head.format(h264.ue(5), h264.ue(1))), sps, pps)
    with pytest.raises(NotImplementedError, match="deblocking"):
        h264.decode_own(_au(head.format(h264.ue(7), h264.ue(0))), sps, pps)
    with pytest.raises(NotImplementedError, match="Intra 4x4"):
        h264.decode_own(_au(head.format(h264.ue(7), h264.ue(1)), h264.ue(0)), sps, pps)
    with pytest.raises(NotImplementedError, match="vertical/plane"):
        h264.decode_own(_au(head.format(h264.ue(7), h264.ue(1)), h264.ue(1) + h264.ue(0) + "1" + "1"), sps, pps)
    unit = h264.nal(1, b"\x88")
    with pytest.raises(NotImplementedError, match="non-IDR"):
        h264.decode_own(len(unit).to_bytes(4, "big") + unit, sps, pps)
