"""Streaming: frames from a long or live 16 kHz waveform, chunk by chunk
(port of `genefaceplusplus_tpu/inference/serving.py`: `stream_infer`, its
reconnect cursor, `FramePusher` and `ClientGone`).

- Audio streams in chunks of `chunk_seconds`. Each chunk's mel and F0 are
  computed here; its HuBERT features are the matching rows of
  `inp['hubert_full']` (the port computes no HuBERT). Each chunk runs the
  audio-to-motion once (`forward_audio2secc`, with the postnet refiner on
  the chunk's own F0 where one is loaded) and renders its frames, so
  frames come out with a chunk's latency, not a clip's.
- One-chunk pipeline: chunk k's frames are rendered into uint8 tensors on
  the card (`GeneFaceInfer.launch_secc2video`) and stay there, uncopied,
  until chunk k+1's render has been launched; then they are copied and
  yielded (`drain_frames`).
- The cursor advances by the audio a chunk consumed (its frames), so frames
  and audio never drift, and `inp['resume_from_frame'] = k` restarts a
  stream at frame k's audio and pose.

JAX's `ShardedFrameRenderer` and its `mesh` argument shard a frame's rays
over several chips; the port serves on one card and has neither.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np

from genefaceplusplus_tpu_torch.data import audio as audio_lib
from genefaceplusplus_tpu_torch.inference.metrics import METRICS
from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
from genefaceplusplus_tpu_torch.utils.smoothing import mirror_index


def stream_infer(infer, wav16k: np.ndarray, inp: Optional[Dict] = None,
                 chunk_seconds: float = 2.0) -> Iterator[np.ndarray]:
    """Yield uint8 frames of `infer` (a `GeneFaceInfer` with an a2m) driven
    by `wav16k` as each chunk of audio is rendered.

    Reconnect: a client that lost its connection after k frames asks again
    with `inp['resume_from_frame'] = k`; the stream restarts at frame k's
    audio position and pose (both functions of the absolute frame index),
    so a resume at a chunk boundary gives the uninterrupted stream's frames
    (given the same a2m draws: at temperature 0 there are none)."""
    inp = default_inp(**(inp or {}))
    if "hubert_full" not in inp:
        raise RuntimeError("the port computes no HuBERT features: pass inp['hubert_full'], the request's "
                           "features [2T, C] at 50 Hz")
    sr = audio_lib.SAMPLE_RATE
    hop_frames = int(chunk_seconds * 25)  # motion frames per chunk
    chunk_samples = hop_frames * 2 * audio_lib.HOP_SIZE  # 50 Hz features

    total = len(wav16k)
    frame_offset = int(inp.get("resume_from_frame", 0) or 0)
    pos = frame_offset * 2 * audio_lib.HOP_SIZE  # samples already streamed
    pending = None
    while pos < total:
        chunk = wav16k[pos:pos + chunk_samples]
        if len(chunk) < sr // 5:  # a tail under 0.2 s is dropped
            break
        chunk_padded, mel = audio_lib.extract_mel(chunk.astype(np.float32))
        f0 = audio_lib.extract_f0(chunk_padded, mel_len=len(mel))
        start = frame_offset * 2
        hubert = inp["hubert_full"][start:start + len(f0)]

        t8 = len(hubert) // 8 * 8  # the a2m takes a multiple of 8 feature frames
        if t8 == 0:
            break  # a tail shorter than one motion block
        batch = {
            "hubert": hubert[:t8],
            "f0": f0[:t8],
            "wav16k": chunk_padded[:t8 * audio_lib.HOP_SIZE],
            "T": t8 // 2,
        }
        # the pose schedule continues across chunks
        ds = infer.dataset
        idxs = [mirror_index(frame_offset + i, len(ds)) for i in range(batch["T"])]
        batch["pose_idx"] = np.asarray(idxs)
        batch["poses"] = np.stack([ds.frame_pose(i) for i in idxs])
        batch["eulers"] = np.asarray(ds.ds["euler"])[idxs]
        batch["transs"] = np.asarray(ds.ds["trans"])[idxs]

        batch = infer.forward_audio2secc(batch, inp)
        launched = infer.launch_secc2video(batch, inp)  # stays on the device
        if pending is not None:
            yield from infer.drain_frames(pending)
        pending = launched
        frame_offset += batch["T"]
        # advance by the samples consumed, not the nominal chunk: the
        # multiple-of-8 truncation would otherwise drift audio and poses apart
        pos += batch["T"] * 2 * audio_lib.HOP_SIZE
    if pending is not None:
        yield from infer.drain_frames(pending)


class ClientGone(OSError):
    """The push socket died mid-stream: abort rendering early."""


class FramePusher:
    """A bounded queue between the render loop and a (possibly slow) client
    socket.

    - The render loop enqueues frames and never blocks on the network; a
      sender thread writes to the socket at the client's pace.
    - When the queue is full the oldest frame is dropped (a live stream
      stays realtime rather than complete) and counted in the metrics.
    - When the socket dies, the next `push()` raises `ClientGone`, so the
      render loop stops instead of rendering for nobody."""

    def __init__(self, send_fn, maxsize: int = 16, metrics=None):
        self._send = send_fn
        self._metrics = METRICS if metrics is None else metrics
        self._q = queue.Queue(maxsize=max(1, int(maxsize)))
        self._dead: Optional[BaseException] = None
        self.dropped = 0
        self.sent = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                t0 = time.perf_counter()
                self._send(item)
                self._metrics.frame_pushed((time.perf_counter() - t0) * 1e3)
                self.sent += 1
            except BaseException as e:  # socket gone / encoder error
                self._dead = e
                # drain, so producers never block on a dead sender
                while True:
                    leftover = self._q.get()
                    if leftover is None:
                        return
                    self._metrics.frame_dropped()

    def push(self, payload) -> None:
        """Enqueue one frame. Never blocks: on a full queue the oldest
        queued frame is discarded first. Raises ClientGone if the sender
        already died."""
        if self._dead is not None:
            raise ClientGone(str(self._dead))
        while True:
            try:
                self._q.put_nowait(payload)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                    self._metrics.frame_dropped()
                except queue.Empty:
                    pass  # the sender took it between the two calls; retry

    def close(self, timeout: float = 30.0) -> None:
        """Flush the queue and stop the sender thread."""
        self._q.put(None)
        self._thread.join(timeout=timeout)
