"""`data/mp4.py`'s reader of the video track against FFmpeg's mov demuxer
(cv2, which JAX's data preparation reads with), on one seeded CABAC B
stream (B-pyramid, so ctts) from `tools/h264_streams.py` written with each
container option: moov last, co64, several samples a chunk, NAL lengths of
1, 2 or 4 bytes, avc3 with in-band parameter sets, edit lists that skip
frames at the start and at the end, signed ctts (version 1), two SPS/PPS in
avcC, a QuickTime file, a track header turned 90, 180 or 270 degrees (as
phones write portrait video; cv2 turns the frames). For each: the frames
come in cv2's count, order and orientation with FFmpeg's luma planes, and
FFmpeg logs no error.

Refusals: a fragmented file names `moof`; HEVC, VP9 and AV1 sample entries,
and cv2's own mp4v file (MPEG-4 Part 2, JAX's writer's fallback here), name
their codec; `read_mp4_track` names what is not the writer's. `read_video`
tells an AVI from an mp4 by its first bytes, not its name.
"""

import dataclasses
import shutil
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_frames, read_mp4_track, read_video_track  # noqa: E402
from genefaceplusplus_tpu_torch.data.video import StreamingVideoWriter, read_video  # noqa: E402
from genefaceplusplus_tpu_torch.tools import h264_streams as hs  # noqa: E402

BASE = hs.Spec(48, 32, hs.b_plan(2, 3, pyramid=True), cabac=True, profile=100, refs_active=(2, 2), max_refs=4,
               qp=(30, 44), pcm=0)
VARIANTS = {
    "moov_first": {},
    "moov_last": dict(moov_last=True),
    "co64": dict(co64=True),
    "chunks_of_3": dict(chunk=3),
    "chunks_of_4_co64": dict(chunk=4, co64=True),
    "lengths_1": dict(length_size=1, qp=(40, 51), slices=(4, 6), sparse=True),
    "lengths_2": dict(length_size=2),
    "avc3_in_band": dict(sample_entry="avc3"),
    "avc3_lengths_2_moov_last": dict(sample_entry="avc3", length_size=2, moov_last=True),
    "edit_skips_start": dict(edit_start=2),
    "edit_ends_early": dict(edit_frames=5),
    "edit_both": dict(edit_start=1, edit_frames=4),
    "ctts_version_1": dict(ctts_v1=True),
    "two_parameter_sets": dict(extra_parameter_sets=True),
    "quicktime": dict(brand=b"qt  "),
    "no_reorder_bound": dict(restriction=False),  # no VUI max_num_reorder_frames: the level's buffer
    "rotated_90": dict(rotation=90),
    "rotated_180": dict(rotation=180),
    "rotated_270": dict(rotation=270),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_container_reads_as_ffmpeg(tmp_path, variant):
    kw = VARIANTS[variant]
    path = str(tmp_path / ("v.mov" if "brand" in kw else "v.mp4"))
    w = hs.write_stream(dataclasses.replace(BASE, **kw), path, seed=3)
    ref = hs.ffmpeg_decode(path)
    assert ref.problems == []
    frames = list(read_mp4_frames(path))
    assert len(frames) == len(ref.y) == w.frames
    for f, y in zip(frames, ref.y):
        np.testing.assert_array_equal(f.y, y)
    track = read_video_track(path)
    assert track.fps == 25.0 and track.length_size == kw.get("length_size", 4)
    assert track.codec == kw.get("sample_entry", "avc1").encode() and track.rotation == kw.get("rotation", 0)


def _patched(src: str, dst: str, old: bytes, new: bytes) -> str:
    data = open(src, "rb").read()
    assert data.count(old) == 1
    open(dst, "wb").write(data.replace(old, new))
    return dst


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mp4") / "s.mp4")
    hs.write_stream(BASE, path, seed=4)
    return path


@pytest.mark.parametrize("fourcc,name", [(b"hvc1", "HEVC"), (b"hev1", "HEVC"), (b"vp09", "VP9"), (b"av01", "AV1")])
def test_other_codecs_raise_naming_them(small, tmp_path, fourcc, name):
    path = _patched(small, str(tmp_path / "x.mp4"), b"avc1\x00\x00\x00\x00\x00\x00", fourcc + bytes(6))
    with pytest.raises(NotImplementedError, match=f"{name} .*{fourcc.decode()}"):
        read_video_track(path)


def test_cv2_mp4v_file_raises_naming_mpeg4_part_2(tmp_path):
    """The file JAX's writer falls back to here (genefaceplusplus_tpu/data/video.py)."""
    path = str(tmp_path / "mp4v.mp4")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 48))
    assert out.isOpened()
    for i in range(3):
        out.write(np.full((48, 64, 3), 40 * i, np.uint8))
    out.release()
    with pytest.raises(NotImplementedError, match="MPEG-4 Part 2"):
        list(read_video(path))


def test_fragmented_file_raises_naming_moof(small, tmp_path):
    path = str(tmp_path / "f.mp4")
    shutil.copy(small, path)
    with open(path, "ab") as f:
        f.write(struct.pack(">I4s", 16, b"moof") + bytes(8))
    with pytest.raises(NotImplementedError, match="moof"):
        read_video_track(path)


def test_read_mp4_track_names_what_is_not_the_writers(tmp_path):
    avc3 = str(tmp_path / "a.mp4")
    hs.write_stream(dataclasses.replace(BASE, sample_entry="avc3"), avc3, seed=4)
    with pytest.raises(ValueError, match="avc3 entry with 0 SPS, 0 PPS"):
        read_mp4_track(avc3)
    with pytest.raises(ValueError, match="no 'moov' box"):
        bad = tmp_path / "b.mp4"
        bad.write_bytes(struct.pack(">I4s", 16, b"ftyp") + b"isom" + bytes(4))
        read_mp4_track(str(bad))


def test_read_video_sniffs_the_container(small, tmp_path):
    frames = np.random.RandomState(0).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    avi = str(tmp_path / "named.mp4")  # an AVI under an mp4's name
    w = StreamingVideoWriter(avi, fps=25)
    for f in frames:
        w.append(f)
    w.close()
    np.testing.assert_array_equal(np.stack(list(read_video(avi))), frames)
    mp4_as_avi = str(tmp_path / "named.avi")
    shutil.copy(small, mp4_as_avi)
    assert len(list(read_video(mp4_as_avi))) == len(list(read_mp4_frames(small)))
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00" * 32)
    with pytest.raises(ValueError, match="neither a RIFF AVI nor an mp4"):
        list(read_video(str(junk)))
