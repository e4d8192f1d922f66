"""The mp4 container (ISO/IEC 14496-12 and -15) in pure Python: a
streaming writer for H.264 access units with 16 kHz mono PCM, and a reader
for its own files.

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

`read_mp4_track` gives back the parameter sets, each frame's access unit
and the PCM; `read_mp4` decodes the frames with `data/h264.py:decode_own`.
`mp4_bytes` bounds a file's size before it is rendered, and raises for a
clip whose durations overflow the boxes' 32-bit fields.
"""

from __future__ import annotations

import os
import struct
from typing import List, NamedTuple, Tuple

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
# Reading the writer's files
# ---------------------------------------------------------------------------

def _boxes(data: bytes, lo: int, hi: int, path: str) -> List[Tuple[bytes, int, int]]:
    """(kind, payload offset, payload end) of each box from lo to hi."""
    out = []
    while lo < hi:
        if lo + 8 > hi:
            raise ValueError(f"{path}: a truncated box header at {lo}")
        size, kind = struct.unpack_from(">I4s", data, lo)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, lo + 8)[0], 16
        elif size == 0:
            size = hi - lo
        if size < head or lo + size > hi:
            raise ValueError(f"{path}: box {kind!r} at {lo} ({size} bytes) runs past its parent's end {hi}")
        out.append((kind, lo + head, lo + size))
        lo += size
    return out


def _child(data: bytes, parent: Tuple[int, int], kind: bytes, path: str) -> Tuple[int, int]:
    found = [(a, b) for k, a, b in _boxes(data, parent[0], parent[1], path) if k == kind]
    if len(found) != 1:
        raise ValueError(f"{path}: {len(found)} {kind!r} boxes where one is expected")
    return found[0]


def _table(data: bytes, at: Tuple[int, int], fmt: str, entry: int) -> List[tuple]:
    n = struct.unpack_from(">I", data, at[0] + 4)[0]
    return [struct.unpack_from(fmt, data, at[0] + 8 + k * entry) for k in range(n)]


class Mp4Track(NamedTuple):
    sps: bytes
    pps: bytes
    height: int
    width: int
    fps: float
    samples: List[bytes]  # each frame's access unit (AVCC)
    pcm: np.ndarray  # int16


def _chunk_spans(data: bytes, stbl: Tuple[int, int], path: str) -> Tuple[List[Tuple[int, int]], int]:
    """(offset, bytes) of each chunk of a track through stsc, stsz and
    co64, and the track's sample count; each chunk is held to the file."""
    sizes_box = _child(data, stbl, b"stsz", path)
    fixed, count = struct.unpack_from(">II", data, sizes_box[0] + 4)
    sizes = [fixed] * count if fixed else list(struct.unpack_from(f">{count}I", data, sizes_box[0] + 12))
    offsets = [o for (o,) in _table(data, _child(data, stbl, b"co64", path), ">Q", 8)]
    runs = _table(data, _child(data, stbl, b"stsc", path), ">3I", 12)
    if not runs or runs[0][0] != 1:
        raise ValueError(f"{path}: an stsc that does not start at chunk 1")
    spans, k, r = [], 0, 0
    for c, off in enumerate(offsets):
        while r + 1 < len(runs) and runs[r + 1][0] <= c + 1:
            r += 1
        n = sum(sizes[k:k + runs[r][1]])
        if k + runs[r][1] > count or off + n > len(data):
            raise ValueError(f"{path}: chunk {c}'s samples run past the sample table or the file")
        spans.append((off, n))
        k += runs[r][1]
    if k != count:
        raise ValueError(f"{path}: the chunks hold {k} samples, stsz {count}")
    return spans, count


def read_mp4_track(path: str) -> Mp4Track:
    """The parameter sets, frame size and rate, each frame's access unit
    and the int16 PCM of an mp4 the writer wrote. Raises ValueError where
    the file is not such an mp4."""
    with open(path, "rb") as f:
        data = f.read()
    top = _boxes(data, 0, len(data), path)
    if not top or top[0][0] != b"ftyp" or [k for k, _, _ in top].count(b"moov") != 1:
        raise ValueError(f"{path}: not an mp4 with one moov (boxes {[k for k, _, _ in top]})")
    moov = [(a, b) for k, a, b in top if k == b"moov"][0]
    video = audio = None
    for kind, a, b in _boxes(data, *moov, path):
        if kind != b"trak":
            continue
        mdia = _child(data, (a, b), b"mdia", path)
        handler = data[_child(data, mdia, b"hdlr", path)[0] + 8:][:4]
        timescale = struct.unpack_from(">I", data, _child(data, mdia, b"mdhd", path)[0] + 12)[0]
        stbl = _child(data, _child(data, mdia, b"minf", path), b"stbl", path)
        if handler == b"vide":
            video = (stbl, timescale)
        elif handler == b"soun":
            audio = stbl
    if video is None:
        raise ValueError(f"{path}: no video track")
    stbl, timescale = video
    stsd = _child(data, stbl, b"stsd", path)
    entries = _boxes(data, stsd[0] + 8, stsd[1], path)
    if len(entries) != 1 or entries[0][0] != b"avc1":
        raise ValueError(f"{path}: the video sample entry is {[k for k, _, _ in entries]}, not one avc1")
    avcc = _child(data, (entries[0][1] + 78, entries[0][2]), b"avcC", path)
    at = avcc[0] + 5
    if data[at] & 0x1F != 1 or data[avcc[0] + 4] & 3 != 3:
        raise ValueError(f"{path}: avcC holds {data[at] & 0x1F} SPS or lengths of {(data[avcc[0] + 4] & 3) + 1} bytes")
    n = struct.unpack_from(">H", data, at + 1)[0]
    sps = data[at + 3:at + 3 + n]
    at += 3 + n
    m = struct.unpack_from(">H", data, at + 1)[0]
    pps = data[at + 3:at + 3 + m]
    info = parse_sps(sps)
    stts = _table(data, _child(data, stbl, b"stts", path), ">II", 8)
    if len(stts) != 1:
        raise ValueError(f"{path}: the video's stts has {len(stts)} entries, not one constant duration")
    fps = timescale / stts[0][1]
    spans, count = _chunk_spans(data, stbl, path)
    if count != len(spans):
        raise ValueError(f"{path}: {count} video samples in {len(spans)} chunks, not one a chunk")
    samples = [data[o:o + k] for o, k in spans]
    if len(samples) != stts[0][0]:
        raise ValueError(f"{path}: {len(samples)} video samples for an stts of {stts[0][0]}")
    pcm = np.zeros(0, np.int16)
    if audio is not None:
        stsd = _child(data, audio, b"stsd", path)
        entries = _boxes(data, stsd[0] + 8, stsd[1], path)
        if len(entries) != 1 or entries[0][0] != b"ipcm":
            raise ValueError(f"{path}: the audio sample entry is {[k for k, _, _ in entries]}, not one ipcm")
        channels, bits = struct.unpack_from(">HH", data, entries[0][1] + 16)
        pcmc = _child(data, (entries[0][1] + 28, entries[0][2]), b"pcmC", path)
        if (channels, bits, data[pcmc[0] + 4], data[pcmc[0] + 5]) != (1, 16, 1, 16):
            raise ValueError(f"{path}: audio of {channels} channels, {bits} bits: not mono 16-bit little-endian PCM")
        spans, count = _chunk_spans(data, audio, path)
        if spans:
            pcm = np.concatenate([np.frombuffer(data, "<i2", k // 2, o) for o, k in spans]).astype(np.int16)
        if len(pcm) != count:
            raise ValueError(f"{path}: {len(pcm)} audio samples for an stsz of {count}")
    return Mp4Track(sps, pps, info.height, info.width, fps, samples, pcm)


def read_mp4(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [T, H, W, 3] RGB uint8, int16 PCM) of an mp4 the writer
    wrote, each frame decoded by `decode_own` (its RGB)."""
    track = read_mp4_track(path)
    frames = np.stack([decode_own(s, track.sps, track.pps).rgb for s in track.samples])
    return frames, track.pcm
