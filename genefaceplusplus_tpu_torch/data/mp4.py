"""The mp4 container (ISO/IEC 14496-12 and -15) in pure Python: a
streaming writer for H.264 access units with 16 kHz mono PCM, and a reader
of H.264 video tracks.

The file is `ftyp` (isom, avc1), then one `mdat` whose 64-bit size `close`
fills in, then `moov`. In `mdat` each frame's access unit is one sample,
followed by that frame's 1/fps of the audio as one chunk (the audio past
the last frame follows in one chunk), as the AVI interleaves them. The
video `trak` holds an `avc1` sample entry with its `avcC` (the SPS and PPS,
4-byte NAL lengths) and `stts`, `stss` (every sample is a sync sample),
`stsc`, `stsz` and `co64`; the audio `trak` holds 16-bit little-endian PCM
as an `ipcm` sample entry with its `pcmC` box (ISO/IEC 23003-5): the same
samples that the AVI carries (`data/audio.py:pcm16`), where the JAX
package muxes AAC through ffmpeg.

Reading: `read_video_track` reads the H.264 video track of any ISO BMFF or
QuickTime file (a camera's, a phone's, libx264's: `moov` first or last,
`stco`/`co64`, any `stsc`, `ctts`, an edit list, `avc1`/`avc3`, NAL lengths
of 1, 2 or 4 bytes, the track header's rotation) without reading its
samples; `read_mp4_frames` decodes them on the host (`data/h264_decode.py`)
as they come, the frames that cv2 gives JAX. `read_mp4_track` gives back
the parameter sets, each frame's access unit and the PCM of the writer's
own files; `read_mp4` decodes those with `data/h264.py:decode_own`.
`mp4_bytes` bounds a file's size before it is rendered, and raises for a
clip whose durations overflow the boxes' 32-bit fields.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.audio import SAMPLE_RATE, pcm16
from genefaceplusplus_tpu_torch.data.h264 import (
    HEADER_MAX_BITS, MB_MAX_BITS, decode_own, level_idc, padded_size, parse_sps)

VIDEO_TIMESCALE = 12800  # ticks a second of the video track (512 a frame at 25 fps)
MOVIE_TIMESCALE = 1000
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_U32 = 0xFFFFFFFF


def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _span(i: int, n_samples: int, fps: int, rate: int) -> Tuple[int, int]:
    """The samples written after frame i: its 1/fps of the audio."""
    return min(i * rate // fps, n_samples), min((i + 1) * rate // fps, n_samples)


def _frame_ticks(fps: int) -> int:
    if VIDEO_TIMESCALE % fps:
        raise ValueError(f"{fps} fps does not divide the video timescale {VIDEO_TIMESCALE}")
    return VIDEO_TIMESCALE // fps


def _audio_chunks(n_frames: int, n_samples: int, fps: int, rate: int) -> List[int]:
    """The samples of each audio chunk, in the writer's order."""
    chunks = [hi - lo for lo, hi in (_span(i, n_samples, fps, rate) for i in range(n_frames)) if hi > lo]
    tail = _span(n_frames, n_samples, fps, rate)[0]
    return chunks + ([n_samples - tail] if n_samples > tail else [])


def _stsc(counts: List[int]) -> List[Tuple[int, int]]:
    """(first chunk, samples per chunk) runs."""
    runs = []
    for i, c in enumerate(counts):
        if not runs or runs[-1][1] != c:
            runs.append((i + 1, c))
    return runs


def mp4_bytes(n_frames: int, height: int, width: int, n_samples: int = 0, fps: int = 25,
              rate: int = SAMPLE_RATE) -> int:
    """The most bytes the writer's file of these frames and samples can
    take (every macroblock at its I_PCM bound). Raises ValueError where the
    clip's durations do not fit the boxes' 32-bit fields."""
    Hp, Wp = padded_size(height, width)
    if n_frames * _frame_ticks(fps) > _U32 or n_samples > _U32 or n_frames > _U32 or \
            max(n_frames / fps, n_samples / rate) * MOVIE_TIMESCALE > _U32:
        raise ValueError(f"{n_frames} frames and {n_samples} samples overflow the mp4's 32-bit durations; "
                         "render a shorter clip")
    level_idc(height, width, fps)  # raises past level 5.2
    slice_max = (HEADER_MAX_BITS + (Wp // 16) * MB_MAX_BITS + 8) // 8 * 3 // 2 + 6  # emulation prevention, NAL
    frame_max = (Hp // 16) * slice_max
    chunks = len(_audio_chunks(n_frames, n_samples, fps, rate))
    moov = 4096 + 16 * n_frames + 20 * chunks  # the boxes, and each frame's and chunk's table entries
    return 32 + 16 + n_frames * frame_max + 2 * n_samples + moov


class Mp4Muxer:
    """Writes H.264 access units (AVCC, 4-byte lengths) as they come, with
    `audio` (a 16 kHz waveform in [-1, 1], quantised by `data.audio.pcm16`)
    interleaved; `close` writes `moov` and returns the path. The file
    appears under its name only when closed."""

    def __init__(self, path: str, fps: int = 25, audio=None, rate: int = SAMPLE_RATE):
        self.path, self.fps, self.rate = path, int(fps), int(rate)
        self.pcm = pcm16(audio) if audio is not None and len(audio) else np.zeros(0, np.int16)
        self.n_frames = 0
        self._f = None
        self._sizes, self._offsets, self._audio = [], [], []  # video samples; audio (offset, samples)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def open(self, height: int, width: int, sps: bytes, pps: bytes):
        _frame_ticks(self.fps)
        self._shape, self._sps, self._pps = (height, width), sps, pps
        self._f = open(self.path + ".part", "wb")
        self._f.write(box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41"))
        self._mdat_at = self._f.tell()
        self._f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 0))

    def _write_audio(self, lo: int, hi: int):
        if hi > lo:
            self._audio.append((self._f.tell(), hi - lo))
            self._f.write(self.pcm[lo:hi].astype("<i2").tobytes())

    def append(self, sample: bytes):
        """Write one frame's access unit and its span of the audio."""
        if self._f is None:
            raise ValueError(f"{self.path}: open() the muxer with the stream's size and parameter sets first")
        self._offsets.append(self._f.tell())
        self._sizes.append(len(sample))
        self._f.write(sample)
        self._write_audio(*_span(self.n_frames, len(self.pcm), self.fps, self.rate))
        self.n_frames += 1

    def close(self) -> str:
        if self._f is None or not self.n_frames:
            raise ValueError(f"{self.path}: no frames were written")
        f = self._f
        tail = _span(self.n_frames, len(self.pcm), self.fps, self.rate)[0]
        self._write_audio(tail, len(self.pcm))
        end = f.tell()
        f.write(self._moov())
        f.seek(self._mdat_at + 8)
        f.write(struct.pack(">Q", end - self._mdat_at))
        f.close()
        self._f = None
        os.replace(self.path + ".part", self.path)
        return self.path

    def _trak(self, track_id: int, duration_ticks: int, timescale: int, handler: bytes, name: bytes,
              media_header: bytes, stsd_entry: bytes, tables: bytes, width: int = 0, height: int = 0) -> bytes:
        movie = duration_ticks * MOVIE_TIMESCALE // timescale
        tkhd = full_box(b"tkhd", 0, 3, struct.pack(">5I", 0, 0, track_id, 0, movie), bytes(8),
                        struct.pack(">hhhH", 0, 0, 0x100 if handler == b"soun" else 0, 0), _MATRIX,
                        struct.pack(">II", width << 16, height << 16))
        mdhd = full_box(b"mdhd", 0, 0, struct.pack(">4I", 0, 0, timescale, duration_ticks),
                        struct.pack(">HH", 0x55C4, 0))  # language 'und'
        hdlr = full_box(b"hdlr", 0, 0, struct.pack(">I", 0), handler, bytes(12), name + b"\0")
        dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), full_box(b"url ", 0, 1)))
        stbl = box(b"stbl", full_box(b"stsd", 0, 0, struct.pack(">I", 1), stsd_entry), tables)
        return box(b"trak", tkhd, box(b"mdia", mdhd, hdlr, box(b"minf", media_header, dinf, stbl)))

    def _moov(self) -> bytes:
        height, width = self._shape
        T, ticks = self.n_frames, _frame_ticks(self.fps)
        sps, pps = self._sps, self._pps
        avcc = box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]), struct.pack(">H", len(sps)), sps,
                   bytes([1]), struct.pack(">H", len(pps)), pps)
        avc1 = box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16), struct.pack(">HHII", width, height,
                                                                                  0x480000, 0x480000),
                   bytes(4), struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 0x18, -1), avcc)
        video_tables = (full_box(b"stts", 0, 0, struct.pack(">3I", 1, T, ticks))
                        + full_box(b"stss", 0, 0, struct.pack(f">{T + 1}I", T, *range(1, T + 1)))
                        + full_box(b"stsc", 0, 0, struct.pack(">4I", 1, 1, 1, 1))
                        + full_box(b"stsz", 0, 0, struct.pack(f">{T + 2}I", 0, T, *self._sizes))
                        + full_box(b"co64", 0, 0, struct.pack(f">I{T}Q", T, *self._offsets)))
        traks = [self._trak(1, T * ticks, VIDEO_TIMESCALE, b"vide", b"VideoHandler",
                            full_box(b"vmhd", 0, 1, bytes(8)), avc1, video_tables, width, height)]
        n = len(self.pcm)
        if self._audio:
            ipcm = box(b"ipcm", bytes(6), struct.pack(">H", 1), bytes(8), struct.pack(">HHHHI", 1, 16, 0, 0,
                                                                                       self.rate << 16),
                       full_box(b"pcmC", 0, 0, bytes([1, 16])))  # little-endian, 16 bits
            runs = _stsc([c for _, c in self._audio])
            audio_tables = (full_box(b"stts", 0, 0, struct.pack(">3I", 1, n, 1))
                            + full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)),
                                       *(struct.pack(">3I", first, c, 1) for first, c in runs))
                            + full_box(b"stsz", 0, 0, struct.pack(">II", 2, n))
                            + full_box(b"co64", 0, 0, struct.pack(f">I{len(self._audio)}Q", len(self._audio),
                                                                  *(o for o, _ in self._audio))))
            traks.append(self._trak(2, n, self.rate, b"soun", b"SoundHandler",
                                    full_box(b"smhd", 0, 0, bytes(4)), ipcm, audio_tables))
        duration = max(T * MOVIE_TIMESCALE // self.fps, n * MOVIE_TIMESCALE // self.rate)
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(">4I", 0, 0, MOVIE_TIMESCALE, duration),
                        struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                        struct.pack(">I", len(traks) + 1))
        return box(b"moov", mvhd, *traks)


# ---------------------------------------------------------------------------
# Reading: the video track of an ISO BMFF or QuickTime file (as cameras,
# phones, libx264 and the writer above write them), and the writer's audio
# ---------------------------------------------------------------------------

# sample entries of the video codecs other than H.264 that the errors name
OTHER_CODECS = {b"hvc1": "HEVC", b"hev1": "HEVC", b"mp4v": "MPEG-4 Part 2", b"vp09": "VP9", b"av01": "AV1"}


def _boxes(data: bytes, lo: int, hi: int, path: str) -> List[Tuple[bytes, int, int]]:
    """(kind, payload offset, payload end) of each box from lo to hi."""
    out = []
    while lo < hi:
        if lo + 8 > hi:
            raise ValueError(f"{path}: a truncated box header at {lo}")
        size, kind = struct.unpack_from(">I4s", data, lo)
        head = 8
        if size == 1:
            if lo + 16 > hi:
                raise ValueError(f"{path}: a truncated 64-bit box header at {lo}")
            size, head = struct.unpack_from(">Q", data, lo + 8)[0], 16
        elif size == 0:
            size = hi - lo
        if size < head or lo + size > hi:
            raise ValueError(f"{path}: box {kind!r} at {lo} ({size} bytes) runs past its parent's end {hi}")
        out.append((kind, lo + head, lo + size))
        lo += size
    return out


def _child(data: bytes, parent: Tuple[int, int], kind: bytes, path: str, required: bool = True):
    found = [(a, b) for k, a, b in _boxes(data, parent[0], parent[1], path) if k == kind]
    if len(found) > 1 or (required and not found):
        raise ValueError(f"{path}: {len(found)} {kind.decode(errors='replace')!r} boxes where one is expected")
    return found[0] if found else None


def _table(data: bytes, at: Tuple[int, int], fmt: str, entry: int, path: str) -> List[tuple]:
    n = struct.unpack_from(">I", data, at[0] + 4)[0]
    if at[0] + 8 + n * entry > at[1]:
        raise ValueError(f"{path}: a table of {n} entries runs past its box")
    return [struct.unpack_from(fmt, data, at[0] + 8 + k * entry) for k in range(n)]


def _read_moov(path: str) -> bytes:
    """The bytes of the file's one `moov` box (its header included), found
    through the top-level boxes, reading nothing else."""
    size = os.path.getsize(path)
    top, moov = [], None
    with open(path, "rb") as f:
        at = 0
        while at < size:
            f.seek(at)
            head = f.read(16)
            if len(head) < 8:
                raise ValueError(f"{path}: a truncated box header at {at}")
            n, kind = struct.unpack_from(">I4s", head)
            skip = 8
            if n == 1:
                if len(head) < 16:
                    raise ValueError(f"{path}: a truncated 64-bit box header at {at}")
                n, skip = struct.unpack_from(">Q", head, 8)[0], 16
            elif n == 0:
                n = size - at
            if n < skip or at + n > size:
                raise ValueError(f"{path}: box {kind!r} at {at} ({n} bytes) runs past the file's end {size}"
                                 " (a truncated file?)")
            top.append(kind)
            if kind == b"moof":
                raise NotImplementedError(f"{path}: a fragmented mp4 (a 'moof' box at {at}): the port reads "
                                          "files whose samples the 'moov' box indexes")
            if kind == b"moov":
                if moov is not None:
                    raise ValueError(f"{path}: two 'moov' boxes")
                f.seek(at)
                moov = f.read(n)
            at += n
    if moov is None:
        raise ValueError(f"{path}: not an mp4 or QuickTime file: no 'moov' box (top-level boxes {top})")
    return moov


def _chunk_spans(data: bytes, stbl: Tuple[int, int], path: str, file_size: int) -> List[Tuple[int, int]]:
    """(offset, bytes) of each sample of a track in decoding order, through
    stsc, stsz and stco or co64; each is held to the file."""
    sizes_box = _child(data, stbl, b"stsz", path, required=False)
    if sizes_box is None:
        if _child(data, stbl, b"stz2", path, required=False):
            raise NotImplementedError(f"{path}: compact sample sizes ('stz2')")
        raise ValueError(f"{path}: no 'stsz' box")
    fixed, count = struct.unpack_from(">II", data, sizes_box[0] + 4)
    if not fixed and sizes_box[0] + 12 + 4 * count > sizes_box[1]:
        raise ValueError(f"{path}: 'stsz' of {count} samples runs past its box")
    sizes = [fixed] * count if fixed else list(struct.unpack_from(f">{count}I", data, sizes_box[0] + 12))
    stco = _child(data, stbl, b"stco", path, required=False)
    co64 = _child(data, stbl, b"co64", path, required=False)
    if (stco is None) == (co64 is None):
        raise ValueError(f"{path}: {'both' if stco else 'neither of'} 'stco' and 'co64'")
    offsets = [o for (o,) in (_table(data, stco, ">I", 4, path) if stco else _table(data, co64, ">Q", 8, path))]
    runs = _table(data, _child(data, stbl, b"stsc", path), ">3I", 12, path)
    if offsets and (not runs or runs[0][0] != 1):
        raise ValueError(f"{path}: an 'stsc' that does not start at chunk 1")
    spans, k, r = [], 0, 0
    for c, off in enumerate(offsets):
        while r + 1 < len(runs) and runs[r + 1][0] <= c + 1:
            r += 1
        n = runs[r][1]
        if k + n > count:
            raise ValueError(f"{path}: chunk {c}'s samples run past the sample table's {count}")
        for size in sizes[k:k + n]:
            if off + size > file_size:
                raise ValueError(f"{path}: sample {len(spans)} ({size} bytes at {off}) runs past the file's end "
                                 f"{file_size} (a truncated file?)")
            spans.append((off, size))
            off += size
        k += n
    if k != count:
        raise ValueError(f"{path}: the chunks hold {k} samples, 'stsz' {count}")
    return spans


def _moov_start(moov: bytes) -> int:
    """Where the children of a `moov` box read whole (header included) start."""
    return 16 if struct.unpack_from(">I", moov)[0] == 1 else 8


def _timescale(data: bytes, header: Tuple[int, int]) -> int:
    """The timescale of an mvhd or mdhd box (version 0 or 1)."""
    scale = struct.unpack_from(">I", data, header[0] + (20 if data[header[0]] == 1 else 12))[0]
    if not scale:
        raise ValueError("a timescale of 0")
    return scale


# the 16.16 (a, b, c, d) of a track header's matrix for each clockwise rotation
_ROTATIONS = {(1, 0, 0, 1): 0, (0, 1, -1, 0): 90, (-1, 0, 0, -1): 180, (0, -1, 1, 0): 270}


def _rotation(data: bytes, tkhd: int) -> int:
    """The clockwise rotation of a tkhd's matrix, where it is one of 0, 90, 180
    or 270 degrees (what FFmpeg's display matrix and cv2 apply); 0 otherwise."""
    at = tkhd + (4 + 8 + 8 + 4 + 4 + 8 if data[tkhd] == 1 else 4 + 4 + 4 + 4 + 4 + 4) + 8 + 2 + 2 + 2 + 2
    a, b, _, c, d = struct.unpack_from(">5i", data, at)
    return _ROTATIONS.get(tuple(v // 0x10000 if v % 0x10000 == 0 else None for v in (a, b, c, d)), 0)


class VideoTrack(NamedTuple):
    path: str
    codec: bytes  # the sample entry: b"avc1" or b"avc3"
    width: int  # the sample entry's
    height: int
    fps: float
    length_size: int  # bytes of each NAL unit's length in a sample
    parameter_sets: List[bytes]  # avcC's SPS and PPS NAL units
    samples: List[Tuple[int, int]]  # (file offset, bytes) of each sample, decoding order
    shown: List[bool]  # each frame in output (composition) order: kept by the edit list
    rotation: int  # clockwise degrees (0, 90, 180, 270) of the track header's matrix, as phones write it


def _avcc(data: bytes, at: Tuple[int, int], path: str) -> Tuple[int, List[bytes]]:
    """NAL length size and parameter sets of an avcC box."""
    p = at[0]
    if at[1] - p < 7 or data[p] != 1:
        raise ValueError(f"{path}: an 'avcC' of version {data[p] if at[1] > p else None}, not 1")
    length_size = (data[p + 4] & 3) + 1
    if length_size == 3:
        raise ValueError(f"{path}: 'avcC' gives NAL unit lengths of 3 bytes")
    units, q = [], p + 5
    for count_mask in (0x1F, 0xFF):
        if q >= at[1]:
            raise ValueError(f"{path}: a truncated 'avcC'")
        n = data[q] & count_mask
        q += 1
        for _ in range(n):
            if q + 2 > at[1]:
                raise ValueError(f"{path}: a truncated 'avcC'")
            m = struct.unpack_from(">H", data, q)[0]
            if q + 2 + m > at[1]:
                raise ValueError(f"{path}: a parameter set runs past 'avcC'")
            units.append(bytes(data[q + 2:q + 2 + m]))
            q += 2 + m
    return length_size, units


def read_video_track(path: str) -> VideoTrack:
    """The H.264 video track of an mp4 or QuickTime file: its parameter
    sets, where each sample lies, and which frames its edit list shows (as
    FFmpeg's demuxer, which cv2 hands to JAX, shows them). Reads the `moov`
    box, not the samples. Raises NotImplementedError naming the box or the
    codec where the file is fragmented or the video is not H.264, and
    ValueError where the file is malformed or truncated."""
    moov = _read_moov(path)
    body = (_moov_start(moov), len(moov))
    movie_scale = _timescale(moov, _child(moov, body, b"mvhd", path))
    video = None
    for kind, a, b in _boxes(moov, *body, path):
        if kind != b"trak":
            continue
        mdia = _child(moov, (a, b), b"mdia", path)
        if moov[_child(moov, mdia, b"hdlr", path)[0] + 8:][:4] == b"vide":
            if video is not None:
                raise NotImplementedError(f"{path}: more than one video track")
            video = (a, b, mdia)
    if video is None:
        raise ValueError(f"{path}: no video track")
    a, b, mdia = video
    timescale = _timescale(moov, _child(moov, mdia, b"mdhd", path))
    rotation = _rotation(moov, _child(moov, (a, b), b"tkhd", path)[0])
    stbl = _child(moov, _child(moov, mdia, b"minf", path), b"stbl", path)
    stsd = _child(moov, stbl, b"stsd", path)
    entries = _boxes(moov, stsd[0] + 8, stsd[1], path)
    if len(entries) != 1:
        raise NotImplementedError(f"{path}: a video track of {len(entries)} sample entries "
                                  f"{[k.decode(errors='replace') for k, _, _ in entries]}")
    codec, ea, eb = entries[0]
    if codec not in (b"avc1", b"avc3"):
        name = OTHER_CODECS.get(codec, "a codec other than H.264")
        raise NotImplementedError(f"{path}: the video is {name} (sample entry {codec.decode(errors='replace')!r}); "
                                  "the port decodes H.264 ('avc1', 'avc3')")
    width, height = struct.unpack_from(">HH", moov, ea + 24)
    length_size, units = _avcc(moov, _child(moov, (ea + 78, eb), b"avcC", path), path)
    samples = _chunk_spans(moov, stbl, path, os.path.getsize(path))
    T = len(samples)
    deltas = []
    for n, d in _table(moov, _child(moov, stbl, b"stts", path), ">II", 8, path):
        deltas += [d] * n
    if len(deltas) != T:
        raise ValueError(f"{path}: 'stts' times {len(deltas)} samples, the track has {T}")
    dts = np.concatenate([[0], np.cumsum(deltas[:-1], dtype=np.int64)]) if T else np.zeros(0, np.int64)
    offsets = np.zeros(T, np.int64)
    ctts = _child(moov, stbl, b"ctts", path, required=False)
    if ctts is not None:
        got = []
        for n, o in _table(moov, ctts, ">Ii", 8, path):  # signed, as FFmpeg reads either version
            got += [o] * n
        if len(got) != T:
            raise ValueError(f"{path}: 'ctts' offsets {len(got)} samples, the track has {T}")
        offsets = np.array(got, np.int64)
    cts = dts + offsets
    start, end = None, None
    edts = _child(moov, (a, b), b"edts", path, required=False)
    if edts is not None:
        elst = _child(moov, edts, b"elst", path, required=False)
        if elst is not None:
            version = moov[elst[0]]
            fmt, size = (">qqhh", 20) if version == 1 else (">Iihh", 12)
            edits = [e for e in _table(moov, elst, fmt, size, path) if e[1] != -1]  # empty edits delay, no more
            if len(edits) > 1:
                raise NotImplementedError(f"{path}: an edit list of {len(edits)} segments")
            if edits:
                duration, start, rate, _ = edits[0]
                if rate != 1:
                    raise NotImplementedError(f"{path}: an edit at rate {rate}")
                end = start + duration * timescale // movie_scale if duration else None
    order = sorted(range(T), key=lambda i: (cts[i], i))
    shown = [(start is None or cts[i] >= start) and (end is None or cts[i] < end) for i in order]
    total = int(sum(deltas))
    fps = T * timescale / total if total else 0.0
    return VideoTrack(path, codec, width, height, fps, length_size, units, samples, shown, rotation)


def track_samples(track: VideoTrack) -> Iterator[bytes]:
    """Each sample's bytes in decoding order, read from the file as they are needed."""
    with open(track.path, "rb") as f:
        for off, size in track.samples:
            f.seek(off)
            data = f.read(size)
            if len(data) != size:
                raise ValueError(f"{track.path}: sample at {off} truncated")
            yield data


def read_mp4_frames(path: str) -> Iterator:
    """Each frame of an mp4's H.264 video as `data.h264_decode.Frame` (Y, Cb,
    Cr), in output order, those its edit list shows, turned as the track
    header's rotation says (as cv2 turns them), decoded on the host
    (`csrc/h264_decode.cpp`) as they come: the memory held is the decoder's
    picture buffer, not the clip."""
    from genefaceplusplus_tpu_torch.data.h264_decode import decode_frames

    track = read_video_track(path)
    frames = decode_frames(track_samples(track), track.parameter_sets, track.length_size, name=path)
    turns = -track.rotation // 90 % 4  # np.rot90 turns counter-clockwise
    for k, frame in enumerate(frames):
        if k < len(track.shown) and track.shown[k]:
            if turns:
                frame = frame._replace(y=np.ascontiguousarray(np.rot90(frame.y, turns)),
                                       cb=np.ascontiguousarray(np.rot90(frame.cb, turns)),
                                       cr=np.ascontiguousarray(np.rot90(frame.cr, turns)))
            yield frame


class Mp4Track(NamedTuple):
    sps: bytes
    pps: bytes
    height: int
    width: int
    fps: float
    samples: List[bytes]  # each frame's access unit (AVCC)
    pcm: np.ndarray  # int16


def _audio(moov: bytes, path: str, file_size: int) -> np.ndarray:
    pcm = np.zeros(0, np.int16)
    for kind, a, b in _boxes(moov, _moov_start(moov), len(moov), path):
        if kind != b"trak":
            continue
        mdia = _child(moov, (a, b), b"mdia", path)
        if moov[_child(moov, mdia, b"hdlr", path)[0] + 8:][:4] != b"soun":
            continue
        stbl = _child(moov, _child(moov, mdia, b"minf", path), b"stbl", path)
        stsd = _child(moov, stbl, b"stsd", path)
        entries = _boxes(moov, stsd[0] + 8, stsd[1], path)
        if len(entries) != 1 or entries[0][0] != b"ipcm":
            raise ValueError(f"{path}: the audio sample entry is {[k for k, _, _ in entries]}, not one ipcm")
        channels, bits = struct.unpack_from(">HH", moov, entries[0][1] + 16)
        pcmc = _child(moov, (entries[0][1] + 28, entries[0][2]), b"pcmC", path)
        if (channels, bits, moov[pcmc[0] + 4], moov[pcmc[0] + 5]) != (1, 16, 1, 16):
            raise ValueError(f"{path}: audio of {channels} channels, {bits} bits: not mono 16-bit little-endian PCM")
        spans = _chunk_spans(moov, stbl, path, file_size)
        with open(path, "rb") as f:
            parts = []
            for off, size in spans:
                f.seek(off)
                parts.append(f.read(size))
        pcm = np.frombuffer(b"".join(parts), "<i2").astype(np.int16)
    return pcm


def read_mp4_track(path: str) -> Mp4Track:
    """The parameter sets, frame size and rate, each frame's access unit
    and the int16 PCM of an mp4 the writer wrote (`read_video_track` and
    its ipcm audio). Raises ValueError where the file is not such an mp4."""
    track = read_video_track(path)
    sps = [u for u in track.parameter_sets if u[0] & 0x1F == 7]
    pps = [u for u in track.parameter_sets if u[0] & 0x1F == 8]
    if track.codec != b"avc1" or len(sps) != 1 or len(pps) != 1 or track.length_size != 4:
        raise ValueError(f"{path}: a {track.codec.decode()} entry with {len(sps)} SPS, {len(pps)} PPS and "
                         f"{track.length_size}-byte lengths: not the writer's one SPS, one PPS and 4-byte lengths")
    info = parse_sps(sps[0])
    pcm = _audio(_read_moov(path), path, os.path.getsize(path))
    return Mp4Track(sps[0], pps[0], info.height, info.width, track.fps, list(track_samples(track)), pcm)


def read_mp4(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [T, H, W, 3] RGB uint8, int16 PCM) of an mp4 the writer
    wrote, each frame decoded by `decode_own` (its RGB)."""
    track = read_mp4_track(path)
    frames = np.stack([decode_own(s, track.sps, track.pps).rgb for s in track.samples])
    return frames, track.pcm
