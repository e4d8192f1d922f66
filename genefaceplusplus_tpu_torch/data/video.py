"""Video output without a codec: an uncompressed RIFF AVI, in pure Python
(the JAX package writes mp4 through imageio or cv2 and muxes the audio with
ffmpeg, `genefaceplusplus_tpu/data/video.py`; the port needs none of them).

The file is AVI 1.0: a `hdrl` list (main header, a video stream of 24-bit
frames stored bottom-up in BGR, rows padded to 4 bytes, and an audio stream
of 16 kHz mono 16-bit PCM), a `movi` list in which each frame's chunk
(`00db`) is followed by its 1/fps of audio (`01wb`; audio past the last
frame follows in one chunk), and an `idx1` index. Frames and samples are
stored as they are: reading the file back gives them bit for bit. AVI 1.0
holds at most 1 GiB (1,363 frames of 512^2 with their audio): `avi_bytes` gives a
file's size before it is rendered, and the writer raises before a chunk
would pass the limit; it never truncates.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.audio import SAMPLE_RATE, pcm16

AVI_MAX_BYTES = 1 << 30
_HDRL_BYTES = 12 + (8 + 56) + (12 + 8 + 56 + 8 + 40)  # LIST hdrl, avih, the video strl
_AUDIO_STRL_BYTES = 12 + 8 + 56 + 8 + 18
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


def _span(i: int, n_samples: int, fps: int, rate: int) -> Tuple[int, int]:
    """The samples written after frame i: its 1/fps of the audio."""
    return min(i * rate // fps, n_samples), min((i + 1) * rate // fps, n_samples)


def _audio_spans(n_frames: int, n_samples: int, fps: int, rate: int) -> Iterator[Tuple[int, int]]:
    """(first, end) sample of each non-empty audio chunk: one after each
    frame, then the audio past the last frame."""
    for i in range(n_frames):
        lo, hi = _span(i, n_samples, fps, rate)
        if hi > lo:
            yield lo, hi
    tail = _span(n_frames, n_samples, fps, rate)[0]
    if n_samples > tail:
        yield tail, n_samples


def avi_bytes(n_frames: int, height: int, width: int, n_samples: int = 0, fps: int = 25,
              rate: int = SAMPLE_RATE) -> int:
    """The size of the AVI that the writer makes of these frames and samples."""
    spans = list(_audio_spans(n_frames, n_samples, fps, rate))
    movi = 12 + n_frames * _chunk(_frame_bytes(height, width)) + sum(_chunk(2 * (hi - lo)) for lo, hi in spans)
    hdrl = _HDRL_BYTES + (_AUDIO_STRL_BYTES if n_samples else 0)
    return 12 + hdrl + movi + 8 + 16 * (n_frames + len(spans))


class StreamingVideoWriter:
    """Writes frames as they come, with `audio` (a 16 kHz waveform in [-1,
    1], quantised by `data.audio.pcm16`) interleaved. `append` takes [H, W,
    3] uint8 RGB frames (or floats in [0, 1]); `close` writes the index and
    the sizes and returns the path. The file appears under its name only
    when closed."""

    def __init__(self, path: str, fps: int = 25, audio=None, rate: int = SAMPLE_RATE):
        self.path, self.fps, self.rate = path, int(fps), int(rate)
        self.pcm = pcm16(audio) if audio is not None and len(audio) else np.zeros(0, np.int16)
        self.n_frames = 0
        self.index = []  # (ckid, offset from 'movi', size)
        self._f = None
        self._shape = None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _open(self, height: int, width: int):
        self._shape = (height, width)
        self._f = open(self.path + ".part", "wb")
        f, streams = self._f, 2 if len(self.pcm) else 1
        frame = _frame_bytes(height, width)
        hdrl = _HDRL_BYTES + (_AUDIO_STRL_BYTES if streams == 2 else 0)
        f.write(b"RIFF\0\0\0\0AVI ")
        f.write(b"LIST" + struct.pack("<I", hdrl - 8) + b"hdrl")
        f.write(b"avih" + struct.pack("<I", 56))
        self._total_frames_at = f.tell() + 16
        f.write(struct.pack("<14I", round(1e6 / self.fps), frame * self.fps + 2 * self.rate, 0,
                            _AVIF_HASINDEX | _AVIF_ISINTERLEAVED, 0, 0, streams, _chunk(frame),
                            width, height, 0, 0, 0, 0))
        f.write(b"LIST" + struct.pack("<I", 4 + 8 + 56 + 8 + 40) + b"strl")
        f.write(b"strh" + struct.pack("<I", 56))
        self._video_length_at = f.tell() + 32
        f.write(struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, self.fps, 0, 0,
                            frame, -1, 0, 0, 0, width, height))
        f.write(b"strf" + struct.pack("<IIiiHHIIiiII", 40, 40, width, height, 1, 24, 0, frame, 0, 0, 0, 0))
        if streams == 2:
            f.write(b"LIST" + struct.pack("<I", 4 + 8 + 56 + 8 + 18) + b"strl")
            f.write(b"strh" + struct.pack("<I", 56))
            f.write(struct.pack("<4s4sIHHIIIIIIiI4h", b"auds", b"\0\0\0\0", 0, 0, 0, 0, 1, self.rate, 0,
                                len(self.pcm), 2 * (self.rate // self.fps), -1, 2, 0, 0, 0, 0))
            f.write(b"strf" + struct.pack("<IHHIIHHH", 18, 1, 1, self.rate, 2 * self.rate, 2, 16, 0))
        self._movi_at = f.tell() + 8  # the 'movi' fourcc, which index offsets count from
        f.write(b"LIST\0\0\0\0movi")

    def _fail(self, msg: str):
        self._f.close()
        self._f = None
        os.remove(self.path + ".part")
        raise ValueError(f"{self.path}: {msg}")

    def _write_chunk(self, ckid: bytes, data: bytes):
        f = self._f
        offset = f.tell() - self._movi_at
        pad = len(data) & 1
        if f.tell() + _chunk(len(data)) + 8 + 16 * (len(self.index) + 1) > AVI_MAX_BYTES:
            self._fail(f"frame {self.n_frames} would take the AVI past {AVI_MAX_BYTES} bytes (AVI 1.0's "
                       "limit); render a shorter clip")
        f.write(ckid + struct.pack("<I", len(data)))
        f.write(data)
        if pad:
            f.write(b"\0")
        self.index.append((ckid, offset, len(data)))

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
        self._write_chunk(b"00db", rows.tobytes())
        lo, hi = _span(self.n_frames, len(self.pcm), self.fps, self.rate)
        if hi > lo:
            self._write_chunk(b"01wb", self.pcm[lo:hi].astype("<i2").tobytes())
        self.n_frames += 1

    def close(self) -> str:
        """Write the audio past the last frame, the index and the sizes; move
        the file to its name and return the path."""
        if self._f is None:
            raise ValueError(f"{self.path}: no frames were written")
        f = self._f
        tail = _span(self.n_frames, len(self.pcm), self.fps, self.rate)[0]
        if len(self.pcm) > tail:
            self._write_chunk(b"01wb", self.pcm[tail:].astype("<i2").tobytes())
        movi_end = f.tell()
        if movi_end + 8 + 16 * len(self.index) > AVI_MAX_BYTES:
            self._fail(f"the index would take the AVI past {AVI_MAX_BYTES} bytes (AVI 1.0's limit)")
        f.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        for ckid, offset, size in self.index:
            f.write(ckid + struct.pack("<III", _AVIIF_KEYFRAME, offset, size))
        end = f.tell()
        for at, value in ((4, end - 8), (self._movi_at - 4, movi_end - self._movi_at),
                          (self._total_frames_at, self.n_frames), (self._video_length_at, self.n_frames)):
            f.seek(at)
            f.write(struct.pack("<I", value))
        f.close()
        self._f = None
        os.replace(self.path + ".part", self.path)
        return self.path
