"""The port's AVI 2.0 (OpenDML) writer and reader (`data/video.py`), on the
CPU, with tiny frames and RIFF segments of a few kB.

- Round trips: frames and samples come back bit for bit through
  `read_avi`, and `avi_bytes` equals the file's size, for every segment
  size, frame size and sample count.
- A structural walk of each file, independent of the reader: every RIFF's
  size field tiles the file, the first is `AVI ` and the others `AVIX`,
  each within the segment size; every `idx1`, `ix##` and `indx` entry points
  at a chunk of the right fourcc and size, and each index covers its
  stream's chunks; `dmlh` and the video `strh.dwLength` equal T, the audio
  one the sample count, `avih.dwTotalFrames` the first RIFF's frames.
- The super-index capacity and the segment size's lower limit raise, and
  leave no file.
- `infer_once` on a small CPU `GeneFaceInfer` past a small segment size.
- cv2's reader, in a subprocess (OpenCV 5.0.0's FFmpeg reader aborts in
  malloc on bottom-up files; ROADMAP queue C), on a top-down copy."""

import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from genefaceplusplus_tpu_torch.data import video
from genefaceplusplus_tpu_torch.data.audio import pcm16
from genefaceplusplus_tpu_torch.testing import tiny_infer

CASES = [  # segment bytes, frames, height, width, samples
    (12_000, 40, 6, 7, 3000),  # rows padded to 4 bytes; audio ends before the frames
    (6_000, 30, 8, 8, 0),  # no audio stream
    (20_000, 25, 5, 5, 640 * 25 + 13),  # audio past the last frame
    (10_000, 40, 4, 4, 1),  # one sample
    (14_000, 20, 16, 16, 640 * 20),
    (12_000, 3, 4, 4, 4000),  # the tail's audio alone in the last segment
    (video.AVI_MAX_BYTES, 5, 6, 7, 3000),  # one RIFF
]


def _frames(T, h, w, n, seed=0):
    rs = np.random.RandomState(seed + T)
    return rs.randint(0, 256, (T, h, w, 3)).astype(np.uint8), (rs.randn(n) * 0.7).astype(np.float32)


def _write(path, frames, wav, segment_bytes):
    writer = video.StreamingVideoWriter(str(path), audio=wav, segment_bytes=segment_bytes)
    for f in frames:
        writer.append(f)
    return writer.close()


def _chunks(data, lo, hi):
    out = []
    while lo < hi:
        ck, n = struct.unpack_from("<4sI", data, lo)
        out.append((ck, lo, n))
        lo += 8 + n + (n & 1)
    assert lo == hi, "chunks do not tile their parent"
    return out


def _list(data, kids, kind):
    found = [(at, n) for ck, at, n in kids if ck == b"LIST" and data[at + 8:at + 12] == kind]
    assert len(found) == 1, kind
    return found[0]


def walk(path, segment_bytes, T, n_samples):
    """Check the file's structure (module docstring); returns its number of
    RIFF segments."""
    with open(path, "rb") as f:
        data = f.read()
    riffs = _chunks(data, 0, len(data))  # each RIFF's size field: the RIFFs tile the file
    assert [ck for ck, _, _ in riffs] == [b"RIFF"] * len(riffs)
    assert [data[at + 8:at + 12] for _, at, _ in riffs] == [b"AVI "] + [b"AVIX"] * (len(riffs) - 1)
    assert all(8 + n <= segment_bytes for _, _, n in riffs)
    streams = 2 if n_samples else 1
    ckids = [b"00db", b"01wb"][:streams]
    movis = []  # per RIFF: (the 'movi' fourcc's offset, {ckid: [data offsets]}, {ix##: offset})
    for _, at, n in riffs:
        kids = _chunks(data, at + 12, at + 8 + n)
        m_at, m_n = _list(data, kids, b"movi")
        inside = _chunks(data, m_at + 12, m_at + 8 + m_n)
        movis.append((m_at + 8, {c: [a + 8 for ck, a, _ in inside if ck == c] for c in ckids},
                      {ck: a for ck, a, _ in inside if ck.startswith(b"ix")}))
        assert {ck for ck, _, _ in inside} <= set(ckids) | {b"ix00", b"ix01"}
        assert [ck for ck, _, _ in kids] == ([b"LIST", b"LIST", b"idx1"] if at == 0 else [b"LIST"])
        if at == 0:
            first_kids = kids

    # the standard indexes: each entry points at its data; each covers its stream's chunks in its movi
    for base_movi, by_ckid, ixs in movis:
        for s, ckid in enumerate(ckids):
            if not by_ckid[ckid]:
                assert b"ix%02d" % s not in ixs
                continue
            ix = ixs[b"ix%02d" % s]
            cb, longs, sub, kind, used, cid, base, _ = struct.unpack_from("<IHBBI4sQI", data, ix + 4)
            assert (longs, sub, kind, cid, cb) == (2, 0, 1, ckid, 24 + 8 * used)
            pointed = []
            for k in range(used):
                off, size = struct.unpack_from("<II", data, ix + 32 + 8 * k)
                assert size < 1 << 31  # keyframes
                assert struct.unpack_from("<4sI", data, base + off - 8) == (ckid, size)
                pointed.append(base + off)
            assert pointed == by_ckid[ckid]

    # idx1: the first RIFF's chunks, offsets from the 'movi' fourcc to each chunk's header
    _, idx1_at, idx1_n = first_kids[2]
    movi0, by_ckid, _ = movis[0]
    entries = [struct.unpack_from("<4sIII", data, idx1_at + 8 + 16 * j) for j in range(idx1_n // 16)]
    assert sorted(movi0 + off + 8 for _, _, off, _ in entries) == sorted(sum(by_ckid.values(), []))
    for ckid, flags, off, size in entries:
        assert flags == 0x10 and struct.unpack_from("<4sI", data, movi0 + off) == (ckid, size)

    # the headers: indx super-indexes, lengths, dmlh, avih
    hdrl_at, hdrl_n = _list(data, first_kids, b"hdrl")
    hdrl = _chunks(data, hdrl_at + 12, hdrl_at + 8 + hdrl_n)
    assert struct.unpack_from("<I", data, hdrl[0][1] + 8 + 16)[0] == len(movis[0][1][b"00db"])  # avih
    strls = [(a, n) for ck, a, n in hdrl if ck == b"LIST" and data[a + 8:a + 12] == b"strl"]
    assert len(strls) == streams
    for s, (a, n) in enumerate(strls):
        parts = {ck: at for ck, at, _ in _chunks(data, a + 12, a + 8 + n)}
        assert set(parts) == {b"strh", b"strf", b"indx"}
        assert struct.unpack_from("<I", data, parts[b"strh"] + 8 + 32)[0] == (T if s == 0 else n_samples)
        longs, sub, kind, used, cid = struct.unpack_from("<HBBI4s", data, parts[b"indx"] + 8)
        assert (longs, sub, kind, cid) == (4, 0, 0, ckids[s])
        with_chunks = [m for m in movis if m[1][ckids[s]]]
        assert used == len(with_chunks) <= video.SUPER_INDEX_ENTRIES
        total = 0
        for j, (_, by_ckid, ixs) in enumerate(with_chunks):
            qw, size, duration = struct.unpack_from("<QII", data, parts[b"indx"] + 8 + 24 + 16 * j)
            assert qw == ixs[b"ix%02d" % s] and data[qw:qw + 4] == b"ix%02d" % s
            assert size == 8 + struct.unpack_from("<I", data, qw + 4)[0]
            sizes = [struct.unpack_from("<I", data, at - 4)[0] for at in by_ckid[ckids[s]]]
            assert duration == (len(sizes) if s == 0 else sum(sizes) // 2)
            total += duration
        assert total == (T if s == 0 else n_samples)
    odml_at, _ = _list(data, hdrl, b"odml")
    assert data[odml_at + 12:odml_at + 16] == b"dmlh"
    assert struct.unpack_from("<I", data, odml_at + 20)[0] == T
    return len(riffs)


@pytest.mark.parametrize("segment_bytes,T,h,w,n", CASES)
def test_multi_segment_round_trip(tmp_path, segment_bytes, T, h, w, n):
    frames, wav = _frames(T, h, w, n)
    path = _write(tmp_path / "v.avi", frames, wav, segment_bytes)
    got, pcm = video.read_avi(path)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(pcm, pcm16(wav))
    assert os.path.getsize(path) == video.avi_bytes(T, h, w, n, segment_bytes=segment_bytes)
    segments = walk(path, segment_bytes, T, n)
    assert segments > 1 or segment_bytes == video.AVI_MAX_BYTES
    assert os.listdir(tmp_path) == ["v.avi"]


def test_the_reader_refuses_an_index_that_points_elsewhere(tmp_path):
    frames, wav = _frames(10, 4, 4, 3000)
    path = _write(tmp_path / "v.avi", frames, wav, 10_000)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    at = data.index(b"ix00", data.index(b"AVIX"))
    struct.pack_into("<I", data, at + 32, struct.unpack_from("<I", data, at + 32)[0] + 2)  # the entry's offset
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="does not point at"):
        video.read_avi(path)


def test_segment_too_small_raises_and_leaves_no_file(tmp_path):
    frames, wav = _frames(2, 16, 16, 0)
    with pytest.raises(ValueError, match="does not fit"):
        _write(tmp_path / "v.avi", frames, wav, 5000)  # the headers alone take 4.7 kB
    with pytest.raises(ValueError, match="does not fit"):
        video.avi_bytes(2, 16, 16, segment_bytes=5000)
    assert os.listdir(tmp_path) == []


def test_super_index_capacity(tmp_path, monkeypatch):
    """A clip needing more segments than the super-indexes hold raises
    before its first chunk past them, and leaves no file; at 1 GiB segments
    the capacity is 348,927 frames of 512^2 with their audio."""
    seg = 12_000
    monkeypatch.setattr(video, "SUPER_INDEX_ENTRIES", 3)
    T = 1
    while T < 100:
        try:
            video.avi_bytes(T + 1, 12, 12, 640 * (T + 1), segment_bytes=seg)
        except ValueError:
            break
        T += 1
    frames, wav = _frames(T + 1, 12, 12, 640 * (T + 1))
    path = _write(tmp_path / "ok.avi", frames[:T], wav[:640 * T], seg)
    assert walk(path, seg, T, 640 * T) == 3
    with pytest.raises(ValueError, match="capacity"):
        _write(tmp_path / "long.avi", frames, wav, seg)
    assert os.listdir(tmp_path) == ["ok.avi"]
    monkeypatch.undo()
    assert video.avi_bytes(348_927, 512, 512, 348_927 * 640) > 255 * video.AVI_MAX_BYTES
    with pytest.raises(ValueError, match="capacity"):
        video.avi_bytes(348_928, 512, 512, 348_928 * 640)


def _request(tmp_path, T50=48):
    """A features request of T50 HuBERT rows (T50 / 2 frames): its inp and
    its waveform."""
    from genefaceplusplus_tpu_torch.inference.pipeline import default_inp

    rs = np.random.RandomState(5)
    wav = (rs.randn(T50 * 320 + 700) * 0.2).astype(np.float32)
    feats = {"hubert": rs.randn(T50, 64).astype(np.float32),
             "f0": (np.abs(rs.randn(T50)) * 100 + 80).astype(np.float32), "wav16k": wav}
    np.save(str(tmp_path / "f.npy"), feats, allow_pickle=True)
    return default_inp(drv_aud_features=str(tmp_path / "f.npy"), temperature=0.0), wav


def _small_segments(monkeypatch, segment_bytes):
    import functools

    from genefaceplusplus_tpu_torch.inference import pipeline

    monkeypatch.setattr(pipeline, "StreamingVideoWriter",
                        functools.partial(video.StreamingVideoWriter, segment_bytes=segment_bytes))


def test_infer_once_past_a_small_segment_size(tmp_path, monkeypatch):
    infer = tiny_infer()
    T50 = 48
    inp, wav = _request(tmp_path, T50)
    rendered = []
    forward = infer.forward_secc2video
    monkeypatch.setattr(infer, "forward_secc2video", lambda *a: (rendered.append(f) or f for f in forward(*a)))
    _small_segments(monkeypatch, 12_000)
    path = infer.infer_once(dict(inp, out_name=str(tmp_path / "long.avi")))
    assert path == str(tmp_path / "long.avi")
    frames, pcm = video.read_avi(path)
    T = T50 // 2
    assert frames.shape == (T, 16, 16, 3) and len(rendered) == T
    np.testing.assert_array_equal(frames, np.stack(rendered))
    np.testing.assert_array_equal(pcm, pcm16(wav))
    assert os.path.getsize(path) == video.avi_bytes(T, 16, 16, len(wav), segment_bytes=12_000)
    assert walk(path, 12_000, T, len(wav)) >= 3


def test_infer_once_past_the_capacity_raises_before_rendering(tmp_path, monkeypatch):
    """A clip that needs more RIFF segments than the super-indexes hold
    raises before its first frame is rendered, and leaves no file."""
    infer = tiny_infer()
    inp, _ = _request(tmp_path)  # 24 frames of 16^2 need at least 4 segments of 12 kB
    monkeypatch.setattr(video, "SUPER_INDEX_ENTRIES", 3)
    monkeypatch.setattr(infer, "launch_secc2video", lambda *a, **k: pytest.fail("rendered"))
    _small_segments(monkeypatch, 12_000)
    with pytest.raises(ValueError, match="capacity"):
        infer.infer_once(dict(inp, out_name=str(tmp_path / "long.avi")))
    assert os.listdir(tmp_path) == ["f.npy"]


_CV2_READ = textwrap.dedent("""
    import sys
    import cv2
    import numpy as np
    cap = cv2.VideoCapture(sys.argv[1])
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    np.save(sys.argv[2], np.stack(frames))
""")


def test_cv2_reads_a_top_down_copy(tmp_path):
    """cv2 (its FFmpeg reader) follows the AVIX segments: a copy with the
    rows stored top-down (negative biHeight) reads back as the frames."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        pytest.skip("cv2 is not importable")
    T, h, w, n, seg = 30, 8, 12, 640 * 30, 14_000
    frames, wav = _frames(T, h, w, n, seed=3)
    path = _write(tmp_path / "v.avi", frames, wav, seg)
    assert walk(path, seg, T, n) > 1
    with open(path, "rb") as f:
        data = bytearray(f.read())
    strf = data.index(b"strf")
    struct.pack_into("<i", data, strf + 16, -h)
    stride = (w * 3 + 3) // 4 * 4
    at = 0
    while True:
        at = data.find(b"00db" + struct.pack("<I", stride * h), at)
        if at < 0:
            break
        rows = np.frombuffer(bytes(data[at + 8:at + 8 + stride * h]), np.uint8).reshape(h, stride)
        data[at + 8:at + 8 + stride * h] = rows[::-1].tobytes()
        at += 8 + stride * h
    top_down = str(tmp_path / "top_down.avi")
    with open(top_down, "wb") as f:
        f.write(data)
    out = str(tmp_path / "cv2.npy")
    run = subprocess.run([sys.executable, "-c", _CV2_READ, top_down, out], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    np.testing.assert_array_equal(np.load(out), frames)
