"""The port's mp4 (data/mp4.py + data/video.py:Mp4Writer) against JAX's
video writer and FFmpeg's demuxer and decoder (cv2):

- the writer's samples, sizes and PCM read back exactly (`read_mp4_track`),
  with audio shorter than, as long as and longer than the frames, and
  `mp4_bytes` bounds the file;
- on the same seeded synthetic_face frames and audio, JAX's
  StreamingVideoWriter + mux_audio (cv2 mp4v here, the wav left beside it
  without ffmpeg) and the port's writer give cv2 the same frame count, size
  and fps; the port's PCM equals JAX's wav sample for sample; the port's
  luma PSNR against the source is at least JAX's own and >= 40 dB; the
  port's file is at most a fifth of the AVI of the same frames.

cv2 is imported only here, with pytest.importorskip.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from genefaceplusplus_tpu.data import audio as j_audio
from genefaceplusplus_tpu.data import video as j_video
from genefaceplusplus_tpu_torch.data import h264
from genefaceplusplus_tpu_torch.data.audio import pcm16
from genefaceplusplus_tpu_torch.data.mp4 import mp4_bytes, read_mp4, read_mp4_track
from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
from genefaceplusplus_tpu_torch.data.video import Mp4Writer, StreamingVideoWriter, video_writer
from genefaceplusplus_tpu_torch.utils import device as device_mod

MIN_LUMA_PSNR = 40.0  # dB, the port's decoded luma vs the source's, at the default QP


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def cv2_read(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(str(path))
    fps, frames = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img[..., ::-1].copy())
    cap.release()
    return fps, frames


@pytest.mark.parametrize("n_samples", [0, 5 * 640 - 17, 7 * 640, 7 * 640 + 1234])
def test_round_trip(tmp_path, n_samples):
    rs = np.random.RandomState(n_samples % 97)
    frames = rs.randint(0, 256, (7, 32, 48, 3)).astype(np.uint8)
    wav = (rs.randn(n_samples) * 0.5).astype(np.float32)
    writer = Mp4Writer(str(tmp_path / "v.mp4"), audio=wav, device="cpu")
    writer.append_chunk(torch.from_numpy(frames[:3]))  # chunks of 3 and 2 frames, then 2 host frames
    writer.append_chunk(torch.from_numpy(frames[3:5]))
    for f in frames[5:]:
        writer.append(f)
    path = writer.close()
    assert sorted(os.listdir(tmp_path)) == ["v.mp4"]
    track = read_mp4_track(path)
    enc = h264.encode_plain(torch.from_numpy(frames))
    assert track.samples == h264.access_units(enc.rows, enc.bits, 7)  # the chunks' first_index count on
    assert (track.height, track.width, track.fps) == (32, 48, 25.0)
    np.testing.assert_array_equal(track.pcm, pcm16(wav))
    got, pcm = read_mp4(path)
    np.testing.assert_array_equal(got, np.stack([h264.decode_own(s, track.sps, track.pps).rgb for s in track.samples]))
    assert os.path.getsize(path) <= mp4_bytes(7, 32, 48, n_samples)
    fps, decoded = cv2_read(path)
    assert fps == 25.0 and len(decoded) == 7


def test_names_chunks_and_limits(tmp_path):
    assert isinstance(video_writer(str(tmp_path / "a.MP4"), device="cpu"), Mp4Writer)
    assert isinstance(video_writer(str(tmp_path / "a.avi")), StreamingVideoWriter)
    writer = Mp4Writer(str(tmp_path / "c.mp4"), device="cpu")
    writer.append_chunk(torch.zeros((2, 16, 16, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="the video"):
        writer.append_chunk(torch.zeros((1, 32, 16, 3), dtype=torch.uint8))
    assert writer.close() == str(tmp_path / "c.mp4")
    assert len(read_mp4_track(str(tmp_path / "c.mp4")).samples) == 2
    with pytest.raises(ValueError, match="no frames"):
        Mp4Writer(str(tmp_path / "d.mp4"), device="cpu").close()
    with pytest.raises(ValueError, match="32-bit"):
        mp4_bytes(2 ** 32 // 512 + 1, 16, 16)
    with pytest.raises(ValueError, match="32-bit"):
        mp4_bytes(10, 16, 16, 2 ** 32)
    with pytest.raises(ValueError, match="even"):
        mp4_bytes(10, 15, 16)
    # a 512^2 frame at its I_PCM bound, and 4 s of audio: the bound holds the clip's size
    assert 100 * 384 * 1024 < mp4_bytes(100, 512, 512, 64000) < 100 * 384 * 1024 * 3 // 2 + 2 ** 20


def test_writer_device_defaults_to_the_card(tmp_path, monkeypatch):
    """With no device named the writers resolve it as `resolve_device(None)`
    does: the card, or the port's "no CUDA device" error; never the CPU."""
    if torch.cuda.is_available():
        want = device_mod.resolve_device(None)
        assert Mp4Writer(str(tmp_path / "a.mp4")).device == want
        assert video_writer(str(tmp_path / "b.mp4")).device == want
    else:
        for make in (lambda: Mp4Writer(str(tmp_path / "a.mp4")), lambda: video_writer(str(tmp_path / "b.mp4"))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: True)  # as on a machine with a card
    assert Mp4Writer(str(tmp_path / "c.mp4")).device == device_mod.resolve_device(None) == torch.device("cuda")
    assert video_writer(str(tmp_path / "d.mp4")).device == torch.device("cuda")
    assert isinstance(video_writer(str(tmp_path / "e.avi")), StreamingVideoWriter)  # the AVI encodes nothing
    assert os.listdir(tmp_path) == []  # no file until the first chunk


def test_writes_as_jax_does(tmp_path):
    """JAX's writer and the port's on the same frames and audio."""
    ds = synthetic_face(num_frames=6, size=64, seed=11)
    frames = np.stack([s["gt_img"] for s in ds["train_samples"] + ds["val_samples"]])[:6]
    wav = (0.4 * np.sin(np.arange(6 * 640 + 300) * 0.05) + 0.01 * np.random.RandomState(1).randn(6 * 640 + 300))
    wav = wav.astype(np.float32)
    # JAX: infer_once's sequence (pipeline.py:886-932): *_novoice.mp4, the wav, mux_audio
    jw = j_video.StreamingVideoWriter(str(tmp_path / "jax_novoice.mp4"), fps=25)
    for f in frames:
        jw.append(f)
    jw.close()
    j_audio.save_wav_16k(wav, str(tmp_path / "jax_audio.wav"))
    j_out = j_video.mux_audio(str(tmp_path / "jax_novoice.mp4"), str(tmp_path / "jax_audio.wav"),
                              str(tmp_path / "jax.mp4"), remove_wav=True)
    writer = Mp4Writer(str(tmp_path / "port.mp4"), fps=25, audio=wav, device="cpu")
    for f in frames:
        writer.append(f)
    t_out = writer.close()
    j_fps, j_frames = cv2_read(j_out)
    t_fps, t_frames = cv2_read(t_out)
    assert (t_fps, len(t_frames), t_frames[0].shape) == (j_fps, len(j_frames), j_frames[0].shape) == (25.0, 6,
                                                                                                       (64, 64, 3))
    rate, side = wavfile.read(str(tmp_path / "jax.wav"))  # JAX without ffmpeg leaves the audio beside the video
    track = read_mp4_track(t_out)
    assert rate == 16000
    np.testing.assert_array_equal(track.pcm, side)
    src = h264.luma(frames)
    port = [psnr(h264.decode_own(s, track.sps, track.pps).y, src[i]) for i, s in enumerate(track.samples)]
    jax_own = [psnr(h264.luma(f), src[i]) for i, f in enumerate(j_frames)]
    assert min(port) >= max(MIN_LUMA_PSNR, min(jax_own)), (port, jax_own)
    avi = StreamingVideoWriter(str(tmp_path / "same.avi"), fps=25, audio=wav)
    for f in frames:
        avi.append(f)
    assert os.path.getsize(t_out) * 5 <= os.path.getsize(avi.close())
