"""The port's H.264 decoder (`csrc/h264_decode.cpp`, bound by
`data/h264_decode.py`, read through `data/mp4.py:read_mp4_frames`) against
FFmpeg's decoder, which cv2 carries here and which JAX's data preparation
reads mp4 with:

- every stream of `tools/h264_streams.py:FIXTURES` (seeded random syntax:
  CAVLC and CABAC; I, P and B slices; every partition, skip and direct
  mode; weighted prediction; long-term references; POC types 0-2; custom
  scaling matrices; deblocking over several slices; a cropped odd size;
  BT.709 VUIs, full and limited range; avc3 with 2-byte lengths): FFmpeg
  logs no error, warning or concealment, the frames come in cv2's count
  and order, each luma plane equals FFmpeg's exactly, and RGB (`to_rgb`)
  lies within RGB_MAX and RGB_MEAN of cv2's BGR;
- the fixtures together reach every CABAC context and every CAVLC code that
  progressive 8-bit 4:2:0 frames use;
- the port's own mp4s (tests/test_torch_h264.py's CASES): all three planes
  equal `decode_own`'s and the encoder's reconstruction, RGB equal;
- the decoder's CABAC initialisation values equal those in cv2's
  libavcodec; chip_smoke.py's luma digest is FFmpeg's;
- interlace, 10 bits, data partitioning, slice groups, SP/SI slices,
  redundant pictures and a gap in frame_num raise NotImplementedError naming
  them; truncated data raises ValueError naming the sample and macroblock;
  the decoder holds no more pictures than its picture buffer.

cv2 runs in a subprocess (`ffmpeg_decode`), the port imports none of it.
"""

import dataclasses
import glob
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from genefaceplusplus_tpu_torch.data import h264  # noqa: E402
from genefaceplusplus_tpu_torch.data.h264_decode import H264Decoder, cabac_init_table, to_rgb  # noqa: E402
from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_frames, read_mp4_track, read_video_track, track_samples  # noqa: E402
from genefaceplusplus_tpu_torch.tools import h264_streams as hs  # noqa: E402

# cv2's BGR (swscale) against the port's fixed-point conversion, per frame; measured max 3, mean <= 1.10
RGB_MAX, RGB_MEAN = 3, 1.2
# swscale's note on a full-range (yuvj420p) frame: about the conversion, not the decode
SWSCALE_NOTE = "deprecated pixel format used"

_spec = importlib.util.spec_from_file_location("h264_encoder_cases", Path(__file__).with_name("test_torch_h264.py"))
_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cases)
CASES, write_own_mp4 = _cases.CASES, _cases.write_mp4


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    root = tmp_path_factory.mktemp("h264_fixtures")
    return {name: (w, hs.ffmpeg_decode(w.path))
            for name, w in ((n, hs.write_fixture(n, str(root / f"{n}.mp4"))) for n in hs.FIXTURES)}


def decode_problems(ref) -> list:
    return [p for p in ref.problems if SWSCALE_NOTE not in p]


@pytest.mark.parametrize("name", list(hs.FIXTURES))
def test_fixture_decodes_as_ffmpeg(streams, name, tmp_path):
    spec = hs.FIXTURES[name]
    w, ref = streams[name]
    assert decode_problems(ref) == []
    frames = list(read_mp4_frames(w.path))
    assert len(frames) == len(ref.y) == w.frames
    luma = ref.y
    if spec.full_range or spec.matrix != 6:
        # cv2's raw frame of a full-range or BT.709 stream is its BGR's grey; the VUI does not change the
        # decoding, so FFmpeg's luma planes come from the same stream with a limited-range BT.601 VUI
        twin = hs.write_stream(dataclasses.replace(spec, full_range=False, matrix=6), str(tmp_path / "twin.mp4"))
        twin_ref = hs.ffmpeg_decode(twin.path)
        assert twin_ref.problems == []
        luma = twin_ref.y
    assert len(luma) == len(frames)
    for i, (f, y) in enumerate(zip(frames, luma)):
        assert f.y.shape == (spec.height, spec.width), i
        np.testing.assert_array_equal(f.y, y, err_msg=f"frame {i}")
    for i, (f, bgr) in enumerate(zip(frames, ref.bgr)):
        d = np.abs(to_rgb(f).astype(np.int32) - bgr[..., ::-1].astype(np.int32))
        assert d.max() <= RGB_MAX and d.mean() <= RGB_MEAN, (i, d.max(), d.mean())


def test_fixtures_reach_every_cabac_context_and_cavlc_code(streams):
    contexts = set().union(*(w.contexts for w, _ in streams.values() if w.cabac))
    assert contexts == hs.FRAME_CONTEXTS, sorted(hs.FRAME_CONTEXTS ^ contexts)
    codes = set().union(*(w.codes for w, _ in streams.values() if not w.cabac))
    assert hs.cavlc_code_set() <= codes, sorted(hs.cavlc_code_set() - codes)[:20]


@pytest.mark.parametrize("case", list(CASES))
def test_own_mp4_decodes_as_decode_own(tmp_path, case):
    frames, qp = CASES[case]()
    T, H, W, _ = frames.shape
    path = str(tmp_path / "v.mp4")
    enc = write_own_mp4(path, frames, qp)
    track = read_mp4_track(path)
    got = list(read_mp4_frames(path))
    assert len(got) == len(track.samples) == T
    for i, (g, s) in enumerate(zip(got, track.samples)):
        own = h264.decode_own(s, track.sps, track.pps)
        for plane, mine, rec in ((own.y, g.y, enc.recon[0][i, :H, :W]), (own.cb, g.cb, enc.recon[1][i, :H // 2, :W // 2]),
                                 (own.cr, g.cr, enc.recon[2][i, :H // 2, :W // 2])):
            np.testing.assert_array_equal(mine, plane)
            np.testing.assert_array_equal(mine, rec.numpy())
        np.testing.assert_array_equal(to_rgb(g), own.rgb)


def test_cabac_init_values_equal_libavcodecs():
    """The 4 x 460 (m, n) pairs of Tables 9-12 to 9-33 as compiled, against
    those FFmpeg's decoder (cv2's libavcodec) carries: its int8 tables for
    cabac_init_idc 0-2 and I slices, 1024 contexts each, one after another."""
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python*.libs", "libavcodec*"))
    assert libs, "cv2's libavcodec"
    data = Path(libs[0]).read_bytes()
    ours = cabac_init_table()
    first = ours[0, :11].astype(np.int8).tobytes()  # the I table's (and every table's) first 11 contexts
    at = data.find(first)
    assert at >= 0
    tables = np.frombuffer(data, np.int8, 4 * 1024 * 2, at).reshape(4, 1024, 2)
    np.testing.assert_array_equal(ours[1:], tables[:3, :460])  # cabac_init_idc 0, 1, 2
    np.testing.assert_array_equal(ours[0], tables[3, :460])  # I slices


def test_chip_smoke_digest_is_ffmpegs(tmp_path):
    """chip_smoke.py holds the card machine, which has no cv2, to this constant."""
    w = hs.write_stream(hs.DIGEST_SPEC, str(tmp_path / "digest.mp4"), hs.DIGEST_SEED)
    ref = hs.ffmpeg_decode(w.path)
    assert ref.problems == [] and len(ref.y) == 4
    assert hs.luma_digest(ref.y) == hs.DIGEST_LUMA_SHA256
    assert hs.luma_digest(f.y for f in read_mp4_frames(w.path)) == hs.DIGEST_LUMA_SHA256


def test_interlaced_stream_raises(tmp_path):
    w = hs.write_stream(hs.Spec(48, 32, hs.ip_plan(2), frame_mbs_only=False), str(tmp_path / "i.mp4"))
    with pytest.raises(NotImplementedError, match="interlaced video"):
        list(read_mp4_frames(w.path))


def test_10_bit_stream_raises(tmp_path):
    w = hs.write_stream(hs.Spec(48, 32, hs.ip_plan(2), bit_depth=10), str(tmp_path / "t.mp4"))
    with pytest.raises(NotImplementedError, match="bit depth of 10"):
        list(read_mp4_frames(w.path))


def test_truncated_sample_raises_naming_sample_and_macroblock(streams):
    w, _ = streams["cabac_p"]
    track = read_video_track(w.path)
    samples = list(track_samples(track))
    dec = H264Decoder(track.length_size)
    for unit in track.parameter_sets:
        dec.parameter_set(unit)
    dec.decode(samples[0])
    cut = samples[1][:len(samples[1]) // 2]
    n = len(cut) - 4
    cut = n.to_bytes(4, "big") + cut[4:]  # a whole NAL unit whose slice data ends early
    with pytest.raises(ValueError, match=r"sample 1: .*macroblock \d+"):
        dec.decode(cut)


def test_truncated_file_raises(streams, tmp_path):
    w, _ = streams["p_cavlc_partitions"]
    data = Path(w.path).read_bytes()
    cut = tmp_path / "cut.mp4"
    cut.write_bytes(data[:len(data) * 2 // 3])
    with pytest.raises(ValueError, match="truncated"):
        list(read_mp4_frames(str(cut)))


def test_decoder_holds_no_more_than_its_picture_buffer(streams):
    """Frames stream out: the pictures held never pass max_num_ref_frames
    plus the reordering depth plus the one being decoded."""
    for name in ("cabac_b_spatial", "long_term_mmco", "cabac_b_temporal"):
        w, _ = streams[name]
        spec = hs.FIXTURES[name]
        track = read_video_track(w.path)
        dec = H264Decoder(track.length_size)
        for unit in track.parameter_sets:
            dec.parameter_set(unit)
        writer = hs._Writer(spec, 0)
        bound = spec.max_refs + writer.reorder_depth() + 1
        out = 0
        for sample in track_samples(track):
            out += len(dec.decode(sample))
            assert dec.held() <= bound, (name, dec.held(), bound)
        out += len(dec.flush())
        assert out == len(track.samples)
        dec.close()


def _rbsp_nal(nal_type: int, fill) -> bytes:
    b = hs.BitWriter()
    fill(b)
    b.trailing()
    return h264.nal(nal_type, b.data())


def _pps(b, slice_groups=0, redundant=0):
    b.ue(0)
    b.ue(0)
    b.bits("00")
    b.ue(slice_groups)
    if slice_groups:
        b.ue(0)  # slice_group_map_type 0
        for _ in range(slice_groups + 1):
            b.ue(0)
    b.ue(0)
    b.ue(0)
    b.bits("000")
    b.se(0)
    b.se(0)
    b.se(0)
    b.bits("10" + str(redundant))


def _slice_header(b, slice_type, redundant_cnt=None):
    b.ue(0)
    b.ue(slice_type)
    b.ue(0)
    b.u(6, 0)  # frame_num (log2_max_frame_num 6)
    b.ue(0)  # idr_pic_id
    b.u(8, 0)  # pic_order_cnt_lsb
    if redundant_cnt is not None:
        b.ue(redundant_cnt)


OUTSIDE = {
    "data partitioning": lambda: [h264.nal(2, b"\x80")],
    "slice groups": lambda: [_rbsp_nal(8, lambda b: _pps(b, slice_groups=1))],
    "SP and SI slices": lambda: [_rbsp_nal(8, _pps), _rbsp_nal(5, lambda b: _slice_header(b, 3))],
    "redundant pictures": lambda: [_rbsp_nal(8, lambda b: _pps(b, redundant=1)),
                                   _rbsp_nal(5, lambda b: _slice_header(b, 7, redundant_cnt=1))],
}


@pytest.mark.parametrize("feature", list(OUTSIDE))
def test_outside_the_scope_raises_naming_it(feature):
    dec = H264Decoder(4)
    dec.parameter_set(hs._Writer(hs.Spec(48, 32, hs.ip_plan(1)), 0).sps())
    units = OUTSIDE[feature]()
    with pytest.raises(NotImplementedError, match=feature):
        for u in units:
            dec.decode(len(u).to_bytes(4, "big") + u)


def test_frame_num_gap_raises(streams):
    w, _ = streams["p_cavlc_partitions"]
    track = read_video_track(w.path)
    samples = list(track_samples(track))
    dec = H264Decoder(track.length_size)
    for unit in track.parameter_sets:
        dec.parameter_set(unit)
    dec.decode(samples[0])
    with pytest.raises(NotImplementedError, match="gap in frame_num"):
        dec.decode(samples[2])  # a lost picture
