"""Video output without a codec: an uncompressed RIFF AVI of any length, in
pure Python (the JAX package writes mp4 through imageio or cv2 and muxes the
audio with ffmpeg, `genefaceplusplus_tpu/data/video.py`; the port needs none
of them).

The file is AVI 2.0 (OpenDML 1.02):

- `RIFF AVI `: a `hdrl` list (the main header; a video stream of 24-bit
  frames stored bottom-up in BGR, rows padded to 4 bytes; an audio stream of
  16 kHz mono 16-bit PCM; each stream's `indx` super-index; an `odml` list
  whose `dmlh` holds the total frame count), a `movi` list in which each
  frame's chunk (`00db`) is followed by its 1/fps of audio (`01wb`; audio
  past the last frame follows in one chunk), and the legacy `idx1` index;
- then as many `RIFF AVIX` segments as the clip needs, each one `movi` list.

Each `movi` list ends with one standard index for each stream that has
chunks in it (`ix00` video, `ix01` audio); each stream's super-index points
at its standard indexes. Every RIFF, the first included, stays within the
writer's `segment_bytes` (default `AVI_MAX_BYTES`, 1 GiB), so an AVI 1.0
reader reads the first RIFF alone: `idx1` and `avih.dwTotalFrames` count
its chunks, while `strh.dwLength` and `dmlh` count the whole stream.

The writer streams and does not know a clip's length, so each super-index
is reserved at `SUPER_INDEX_ENTRIES` (256) segments, as a `JUNK` chunk that
`close` fills. At 1 GiB segments that holds 256 GiB: 348,927 frames of 512^2
with their audio, 3 h 52 min at 25 fps. A longer clip raises before its
first chunk past the capacity is written.

Frames and samples are stored as they are: `read_avi` gives them back bit
for bit. `avi_bytes` gives a file's size before it is rendered.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.audio import SAMPLE_RATE, pcm16

AVI_MAX_BYTES = 1 << 30  # the default segment size; AVI 1.0 readers stop at the first RIFF's 1 GiB
SUPER_INDEX_ENTRIES = 256
_CKIDS, _IXIDS = (b"00db", b"01wb"), (b"ix00", b"ix01")
_INDX_BYTES = 8 + 24 + 16 * SUPER_INDEX_ENTRIES
_DMLH_BYTES = 248  # dwTotalFrames and 61 reserved DWORDs
_VIDEO_STRL_BYTES = 12 + (8 + 56) + (8 + 40) + _INDX_BYTES
_AUDIO_STRL_BYTES = 12 + (8 + 56) + (8 + 18) + _INDX_BYTES
_ODML_BYTES = 12 + 8 + _DMLH_BYTES
_AVIX_OPEN_BYTES = 24  # 'RIFF' size 'AVIX' 'LIST' size 'movi'
_AVIF_HASINDEX, _AVIF_ISINTERLEAVED, _AVIIF_KEYFRAME = 0x10, 0x100, 0x10


def avi_path(out_name: str) -> str:
    """The path the writer uses for `out_name`: itself for `.avi`, and
    `<stem>.avi` for `.mp4` (an mp4 needs a codec)."""
    stem, ext = os.path.splitext(out_name)
    if ext.lower() in (".avi", ".mp4"):
        return stem + ".avi"
    raise ValueError(f"{out_name!r}: the port writes uncompressed AVI; name the output .avi or .mp4")


def _frame_bytes(height: int, width: int) -> int:
    return (width * 3 + 3) // 4 * 4 * height


def _chunk(n: int) -> int:
    return 8 + n + (n & 1)


def _hdrl_bytes(streams: int) -> int:
    return 12 + (8 + 56) + _VIDEO_STRL_BYTES + (_AUDIO_STRL_BYTES if streams == 2 else 0) + _ODML_BYTES


def _span(i: int, n_samples: int, fps: int, rate: int) -> Tuple[int, int]:
    """The samples written after frame i: its 1/fps of the audio."""
    return min(i * rate // fps, n_samples), min((i + 1) * rate // fps, n_samples)


def _chunk_sizes(n_frames: int, frame: int, n_samples: int, fps: int, rate: int) -> Iterator[Tuple[int, int]]:
    """(stream, data bytes) of each chunk, in the writer's order: each frame,
    then its audio where it has any, then the audio past the last frame."""
    for i in range(n_frames):
        yield 0, frame
        lo, hi = _span(i, n_samples, fps, rate)
        if hi > lo:
            yield 1, 2 * (hi - lo)
    tail = _span(n_frames, n_samples, fps, rate)[0]
    if n_samples > tail:
        yield 1, 2 * (n_samples - tail)


class _Riff:
    """The byte count of one RIFF segment, the rule that the writer and
    `avi_bytes` share: a chunk joins the segment if the segment, closed after
    it (its standard indexes and, in the first RIFF, `idx1`), stays within
    the segment size."""

    def __init__(self, size: int, first: bool, streams: int):
        self.size, self.first, self.counts = size, first, [0] * streams

    def closing(self, counts: Optional[List[int]] = None) -> int:
        counts = self.counts if counts is None else counts
        return sum(32 + 8 * c for c in counts if c) + (8 + 16 * sum(counts) if self.first else 0)

    def fits(self, stream: int, n: int, limit: int) -> bool:
        counts = list(self.counts)
        counts[stream] += 1
        return self.size + _chunk(n) + self.closing(counts) <= limit

    def add(self, stream: int, n: int):
        self.size += _chunk(n)
        self.counts[stream] += 1

    def closed(self) -> int:
        return self.size + self.closing()


def _place(riff: _Riff, n_riffs: int, stream: int, n: int, limit: int) -> Optional[_Riff]:
    """None where a chunk of `n` bytes joins `riff` (the `n_riffs`-th
    segment); else the `AVIX` segment it opens. Raises where no segment can
    hold it, or where the super-indexes are full."""
    if riff.fits(stream, n, limit):
        return None
    new = _Riff(_AVIX_OPEN_BYTES, False, len(riff.counts))
    if not any(riff.counts) or not new.fits(stream, n, limit):
        raise ValueError(f"a {n}-byte chunk does not fit in a RIFF segment of {limit} bytes")
    if n_riffs == SUPER_INDEX_ENTRIES:
        raise ValueError(f"the clip needs more than {SUPER_INDEX_ENTRIES} RIFF segments of {limit} bytes, "
                         "the capacity of the AVI's super-indexes; render a shorter clip")
    return new


def avi_bytes(n_frames: int, height: int, width: int, n_samples: int = 0, fps: int = 25,
              rate: int = SAMPLE_RATE, segment_bytes: int = AVI_MAX_BYTES) -> int:
    """The size of the AVI that the writer makes of these frames and samples."""
    streams = 2 if n_samples else 1
    riff, n_riffs, total = _Riff(12 + _hdrl_bytes(streams) + 12, True, streams), 1, 0
    for stream, n in _chunk_sizes(n_frames, _frame_bytes(height, width), n_samples, fps, rate):
        new = _place(riff, n_riffs, stream, n, segment_bytes)
        if new is not None:
            total, riff, n_riffs = total + riff.closed(), new, n_riffs + 1
        riff.add(stream, n)
    return total + riff.closed()


class StreamingVideoWriter:
    """Writes frames as they come, with `audio` (a 16 kHz waveform in [-1,
    1], quantised by `data.audio.pcm16`) interleaved, in RIFF segments of at
    most `segment_bytes`. `append` takes [H, W, 3] uint8 RGB frames (or
    floats in [0, 1]); `close` writes the indexes and the sizes and returns
    the path. The file appears under its name only when closed."""

    def __init__(self, path: str, fps: int = 25, audio=None, rate: int = SAMPLE_RATE,
                 segment_bytes: int = AVI_MAX_BYTES):
        self.path, self.fps, self.rate, self.segment_bytes = path, int(fps), int(rate), int(segment_bytes)
        self.pcm = pcm16(audio) if audio is not None and len(audio) else np.zeros(0, np.int16)
        self.n_frames = 0
        self._f = None
        self._shape = None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _reserve_indx(self) -> int:
        at = self._f.tell()
        self._f.write(b"JUNK" + struct.pack("<I", _INDX_BYTES - 8) + bytes(_INDX_BYTES - 8))
        return at

    def _open(self, height: int, width: int):
        self._shape = (height, width)
        self._f = open(self.path + ".part", "wb")
        f, streams = self._f, 2 if len(self.pcm) else 1
        frame = _frame_bytes(height, width)
        f.write(b"RIFF\0\0\0\0AVI ")
        f.write(b"LIST" + struct.pack("<I", _hdrl_bytes(streams) - 8) + b"hdrl")
        f.write(b"avih" + struct.pack("<I", 56))
        self._total_frames_at = f.tell() + 16
        f.write(struct.pack("<14I", round(1e6 / self.fps), frame * self.fps + 2 * self.rate, 0,
                            _AVIF_HASINDEX | _AVIF_ISINTERLEAVED, 0, 0, streams, _chunk(frame),
                            width, height, 0, 0, 0, 0))
        f.write(b"LIST" + struct.pack("<I", _VIDEO_STRL_BYTES - 8) + b"strl")
        f.write(b"strh" + struct.pack("<I", 56))
        self._video_length_at = f.tell() + 32
        f.write(struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, self.fps, 0, 0,
                            frame, -1, 0, 0, 0, width, height))
        f.write(b"strf" + struct.pack("<IIiiHHIIiiII", 40, 40, width, height, 1, 24, 0, frame, 0, 0, 0, 0))
        self._indx_at = [self._reserve_indx()]
        if streams == 2:
            f.write(b"LIST" + struct.pack("<I", _AUDIO_STRL_BYTES - 8) + b"strl")
            f.write(b"strh" + struct.pack("<I", 56))
            f.write(struct.pack("<4s4sIHHIIIIIIiI4h", b"auds", b"\0\0\0\0", 0, 0, 0, 0, 1, self.rate, 0,
                                len(self.pcm), 2 * (self.rate // self.fps), -1, 2, 0, 0, 0, 0))
            f.write(b"strf" + struct.pack("<IHHIIHHH", 18, 1, 1, self.rate, 2 * self.rate, 2, 16, 0))
            self._indx_at.append(self._reserve_indx())
        f.write(b"LIST" + struct.pack("<I", _ODML_BYTES - 8) + b"odmldmlh" + struct.pack("<I", _DMLH_BYTES))
        self._dmlh_at = f.tell()
        f.write(bytes(_DMLH_BYTES))
        self._riff_at, self._movi_at = 0, f.tell() + 8  # index offsets count from the 'movi' fourcc
        f.write(b"LIST\0\0\0\0movi")
        self._riff, self._n_riffs = _Riff(f.tell(), True, streams), 1
        self._chunks = [[] for _ in range(streams)]  # (data offset, size) in this segment
        self._idx1 = []  # (ckid, offset of the chunk from 'movi', size) in the first segment
        self._super = [[] for _ in range(streams)]  # (ix## offset, its bytes, frames or samples)

    def _fail(self, msg: str):
        self._f.close()
        self._f = None
        os.remove(self.path + ".part")
        raise ValueError(f"{self.path}: {msg}")

    def _end_riff(self):
        """Write the segment's standard indexes (and, in the first, `idx1`)
        and its sizes."""
        f = self._f
        for stream, chunks in enumerate(self._chunks):
            if chunks:
                at = f.tell()
                f.write(_IXIDS[stream] + struct.pack("<IHBBI4sQI", 24 + 8 * len(chunks), 2, 0, 1, len(chunks),
                                                     _CKIDS[stream], self._movi_at, 0))
                f.write(b"".join(struct.pack("<II", off - self._movi_at, n) for off, n in chunks))
                duration = len(chunks) if stream == 0 else sum(n for _, n in chunks) // 2
                self._super[stream].append((at, 32 + 8 * len(chunks), duration))
        movi_end = f.tell()
        if self._riff.first:
            f.write(b"idx1" + struct.pack("<I", 16 * len(self._idx1)))
            f.write(b"".join(ckid + struct.pack("<III", _AVIIF_KEYFRAME, off, n) for ckid, off, n in self._idx1))
            self._first_frames = len(self._chunks[0])
        end = f.tell()
        for at, value in ((self._riff_at + 4, end - self._riff_at - 8), (self._movi_at - 4, movi_end - self._movi_at)):
            f.seek(at)
            f.write(struct.pack("<I", value))
        f.seek(end)

    def _write_chunk(self, stream: int, data: bytes):
        try:
            new = _place(self._riff, self._n_riffs, stream, len(data), self.segment_bytes)
        except ValueError as e:
            self._fail(str(e))
        f = self._f
        if new is not None:
            self._end_riff()
            self._riff_at, self._movi_at = f.tell(), f.tell() + 20
            f.write(b"RIFF\0\0\0\0AVIXLIST\0\0\0\0movi")
            self._riff, self._n_riffs = new, self._n_riffs + 1
            self._chunks = [[] for _ in self._chunks]
        if self._riff.first:
            self._idx1.append((_CKIDS[stream], f.tell() - self._movi_at, len(data)))
        f.write(_CKIDS[stream] + struct.pack("<I", len(data)))
        self._chunks[stream].append((f.tell(), len(data)))
        f.write(data)
        if len(data) & 1:
            f.write(b"\0")
        self._riff.add(stream, len(data))

    def append(self, frame: np.ndarray):
        """Write one [H, W, 3] RGB frame (uint8, or float in [0, 1]) and its
        span of the audio."""
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"a frame must be [H, W, 3], got {frame.shape}")
        if self._f is None:
            self._open(*frame.shape[:2])
        elif frame.shape[:2] != self._shape:
            raise ValueError(f"frame {self.n_frames} is {frame.shape[:2]}, the video {self._shape}")
        height, width = self._shape
        rows = np.zeros((height, (width * 3 + 3) // 4 * 4), np.uint8)
        rows[:, :width * 3] = frame[::-1, :, ::-1].reshape(height, width * 3)  # bottom-up BGR
        self._write_chunk(0, rows.tobytes())
        lo, hi = _span(self.n_frames, len(self.pcm), self.fps, self.rate)
        if hi > lo:
            self._write_chunk(1, self.pcm[lo:hi].astype("<i2").tobytes())
        self.n_frames += 1

    def close(self) -> str:
        """Write the audio past the last frame, the indexes and the sizes;
        move the file to its name and return the path."""
        if self._f is None:
            raise ValueError(f"{self.path}: no frames were written")
        f = self._f
        tail = _span(self.n_frames, len(self.pcm), self.fps, self.rate)[0]
        if len(self.pcm) > tail:
            self._write_chunk(1, self.pcm[tail:].astype("<i2").tobytes())
        self._end_riff()
        for stream, entries in enumerate(self._super):
            f.seek(self._indx_at[stream])
            f.write(b"indx" + struct.pack("<IHBBI4s3I", _INDX_BYTES - 8, 4, 0, 0, len(entries), _CKIDS[stream],
                                          0, 0, 0))
            f.write(b"".join(struct.pack("<QII", *e) for e in entries))
        for at, value in ((self._total_frames_at, self._first_frames), (self._video_length_at, self.n_frames),
                          (self._dmlh_at, self.n_frames)):
            f.seek(at)
            f.write(struct.pack("<I", value))
        f.close()
        self._f = None
        os.replace(self.path + ".part", self.path)
        return self.path


def _children(mm, lo: int, hi: int, path: str) -> Iterator[Tuple[bytes, int, int]]:
    """(fourcc, data offset, data bytes) of each chunk from `lo` to `hi`."""
    while lo + 8 <= hi:
        ck, n = struct.unpack_from("<4sI", mm, lo)
        if lo + 8 + n > hi:
            raise ValueError(f"{path}: chunk {ck!r} at {lo} ({n} bytes) runs past its parent's end {hi}")
        yield ck, lo + 8, n
        lo += _chunk(n)
    if lo != hi:
        raise ValueError(f"{path}: {hi - lo} stray bytes at {lo}")


def _indexed_chunks(mm, indx: Tuple[int, int], stream: int, kind: bytes, path: str) -> List[Tuple[int, int]]:
    """(data offset, bytes) of a stream's chunks, through its super-index and
    standard indexes; each entry is held to the chunk it points at."""
    ckid = b"%02d" % stream + (b"db" if kind == b"vids" else b"wb")
    at, n = indx
    longs, _, index_type, used, indx_ckid = struct.unpack_from("<HBBI4s", mm, at)
    if (longs, index_type, indx_ckid) != (4, 0, ckid) or 24 + 16 * used > n:
        raise ValueError(f"{path}: stream {stream}'s indx is not a super-index of {ckid!r} chunks")
    chunks = []
    for j in range(used):
        ix_at, ix_bytes, duration = struct.unpack_from("<QII", mm, at + 24 + 16 * j)
        if ix_at + 32 > len(mm):
            raise ValueError(f"{path}: super-index entry {j} of stream {stream} points past the file's end")
        ck, cb, longs, _, index_type, m, ix_ckid, base = struct.unpack_from("<4sIHBBI4sQ", mm, ix_at)
        if (ck, cb + 8, longs, index_type, ix_ckid, cb) != (b"ix%02d" % stream, ix_bytes, 2, 1, ckid, 24 + 8 * m):
            raise ValueError(f"{path}: super-index entry {j} of stream {stream} does not point at its "
                             f"standard index (at {ix_at})")
        mine = []
        for k in range(m):
            off, size = struct.unpack_from("<II", mm, ix_at + 32 + 8 * k)
            data_at, size = base + off, size & 0x7FFFFFFF
            if not 8 <= data_at <= len(mm) - size or struct.unpack_from("<4sI", mm, data_at - 8) != (ckid, size):
                raise ValueError(f"{path}: entry {k} of the standard index at {ix_at} does not point at a "
                                 f"{size}-byte {ckid!r} chunk")
            mine.append((data_at, size))
        if duration != (m if kind == b"vids" else sum(s for _, s in mine) // 2):
            raise ValueError(f"{path}: the duration of super-index entry {j} of stream {stream} is {duration}")
        chunks += mine
    return chunks


def read_avi(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [T, H, W, 3] RGB uint8, int16 PCM) of an AVI the writer wrote.

    The streams' formats come from the first RIFF's `hdrl`; every chunk is
    found through its stream's `indx` super-index and the `ix##` standard
    indexes it points at, across the `AVIX` segments. Raises ValueError where
    the file is not such an AVI, or where an index entry does not point at a
    chunk of its stream's fourcc and size."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        return _read_avi(mm, path)


def _read_avi(mm, path: str) -> Tuple[np.ndarray, np.ndarray]:
    riffs = list(_children(mm, 0, len(mm), path))
    forms = [bytes(mm[at:at + 4]) for _, at, _ in riffs]
    if not riffs or any(ck != b"RIFF" for ck, _, _ in riffs) or forms != [b"AVI "] + [b"AVIX"] * (len(riffs) - 1):
        raise ValueError(f"{path}: not a RIFF AVI (segments {forms})")
    _, at, n = riffs[0]
    hdrl = [(a, m) for ck, a, m in _children(mm, at + 4, at + n, path) if ck == b"LIST" and mm[a:a + 4] == b"hdrl"]
    if not hdrl:
        raise ValueError(f"{path}: no hdrl list")
    streams = []  # (fccType, strh dwLength, strf (offset, bytes), indx (offset, bytes))
    for ck, a, m in _children(mm, hdrl[0][0] + 4, hdrl[0][0] + hdrl[0][1], path):
        if ck == b"LIST" and mm[a:a + 4] == b"strl":
            parts = {c: (b, k) for c, b, k in _children(mm, a + 4, a + m, path)}
            if not {b"strh", b"strf", b"indx"} <= set(parts):
                raise ValueError(f"{path}: stream {len(streams)} lacks strh, strf or indx (AVI 2.0)")
            kind, length = bytes(mm[parts[b"strh"][0]:parts[b"strh"][0] + 4]), struct.unpack_from(
                "<I", mm, parts[b"strh"][0] + 32)[0]
            streams.append((kind, length, parts[b"strf"], parts[b"indx"]))
    if not streams or streams[0][0] != b"vids" or any(s[0] != b"auds" for s in streams[1:2]) or len(streams) > 2:
        raise ValueError(f"{path}: streams {[s[0] for s in streams]}, not a video stream and an optional audio one")
    _, length, (strf, _), indx = streams[0]
    _, width, height, _, bits, compression = struct.unpack_from("<IiiHHI", mm, strf)
    if bits != 24 or height <= 0 or compression != 0:
        raise ValueError(f"{path}: frames of {bits} bits, height {height}, compression {compression}: not "
                         "bottom-up uncompressed 24-bit")
    video = _indexed_chunks(mm, indx, 0, b"vids", path)
    stride = (width * 3 + 3) // 4 * 4
    if len(video) != length or any(size != stride * height for _, size in video):
        raise ValueError(f"{path}: {len(video)} frame chunks for a stream of {length}, or a chunk not of "
                         f"{stride * height} bytes")
    frames = np.empty((len(video), height, width, 3), np.uint8)
    for i, (at, _) in enumerate(video):  # no view of the map outlives its statement: the map then closes
        frames[i] = np.frombuffer(mm, np.uint8, stride * height, at).reshape(height, stride)[
            ::-1, :width * 3].reshape(height, width, 3)[:, :, ::-1]
    pcm = np.zeros(0, np.int16)
    if len(streams) == 2:
        _, length, (strf, _), indx = streams[1]
        tag, channels, _, _, _, bits = struct.unpack_from("<HHIIHH", mm, strf)
        if (tag, channels, bits) != (1, 1, 16):
            raise ValueError(f"{path}: audio format {tag}, {channels} channels, {bits} bits: not mono 16-bit PCM")
        audio = _indexed_chunks(mm, indx, 1, b"auds", path)
        pcm = np.concatenate([np.frombuffer(mm, "<i2", size // 2, at) for at, size in audio]).astype(np.int16)
        if len(pcm) != length:
            raise ValueError(f"{path}: {len(pcm)} samples for a stream of {length}")
    return frames, pcm
