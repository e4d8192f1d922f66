"""Audio front end: wav IO, mel spectrogram and F0 tracking (numpy/scipy
copy of `genefaceplusplus_tpu/data/audio.py`).

- mel: 16 kHz, STFT fft 512 / hop 320 / win 512 hann, center=False, 80
  Slaney mels (fmin 80, fmax 7600), log10(max(1e-6, .));
- F0: a Boersma-style windowed-autocorrelation tracker (the sound's ACF
  normalised by the window's, parabolic peak interpolation, voicing
  threshold 0.6, 80-750 Hz), one value per mel hop; unvoiced frames 0.

HuBERT features are not computed here (its weights are not in the
repository): audio-driven serving takes them precomputed
(`GeneFaceInfer.prepare_batch_from_inp`'s `drv_aud_features`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000
HOP_SIZE = 320
FFT_SIZE = 512
WIN_LENGTH = 512
NUM_MELS = 80
FMIN = 80.0
FMAX = 7600.0


def load_wav_16k(path: str) -> np.ndarray:
    """Read a wav file -> float32 mono 16 kHz in [-1, 1]."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != SAMPLE_RATE:
        from math import gcd

        g = gcd(int(sr), SAMPLE_RATE)
        data = resample_poly(data, SAMPLE_RATE // g, int(sr) // g).astype(np.float32)
    return data


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr=SAMPLE_RATE, n_fft=FFT_SIZE, n_mels=NUM_MELS, fmin=FMIN, fmax=FMAX) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filterbank (librosa default)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_mag(wav: np.ndarray, n_fft=FFT_SIZE, hop=HOP_SIZE, win_length=WIN_LENGTH) -> np.ndarray:
    """|STFT| with hann window, center=False -> [n_bins, T]."""
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)  # periodic hann
    n_frames = 1 + (len(wav) - n_fft) // hop if len(wav) >= n_fft else 0
    if n_frames <= 0:
        return np.zeros((n_fft // 2 + 1, 0), np.float32)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * window[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return np.abs(spec).T.astype(np.float32)


def extract_mel(wav: np.ndarray, eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """wav -> (padded wav, log10-mel [T, 80]); pads wav to a whole number of
    hops on the right (librosa_pad_lr, extract_mel_f0.py:34-43)."""
    spc = stft_mag(wav)
    mel = mel_filterbank() @ spc
    mel = np.log10(np.maximum(eps, mel)).T  # [T, 80]
    pad = (len(wav) // HOP_SIZE + 1) * HOP_SIZE - len(wav)
    wav = np.pad(wav, (0, pad))
    return wav.astype(np.float32), mel.astype(np.float32)


def extract_f0(
    wav: np.ndarray,
    mel_len: Optional[int] = None,
    f0_min: float = 80.0,
    f0_max: float = 750.0,
    voicing_threshold: float = 0.6,
    hop: int = HOP_SIZE,
    sr: int = SAMPLE_RATE,
) -> np.ndarray:
    """Autocorrelation F0 tracker (Boersma-style): per frame, the sound's
    normalised ACF divided by the hann window's ACF; the highest peak in the
    [1/f0_max, 1/f0_min] lag range wins if above the voicing threshold.
    Unvoiced frames -> 0 (matching parselmouth's selected_array['frequency']).
    """
    # window: >= 3 periods of f0_min for reliable ACF (Praat uses 3/pitch_floor)
    win = int(3.0 * sr / f0_min)
    win = min(win, 1024)
    window = np.hanning(win).astype(np.float64)
    wacf = np.correlate(window, window, mode="full")[win - 1 :]
    wacf = wacf / wacf[0]

    lag_min = int(sr / f0_max)
    lag_max = min(int(sr / f0_min), win - 2)

    n_frames = max(1, 1 + (len(wav) - win) // hop) if len(wav) >= win else 1
    f0 = np.zeros(n_frames, np.float32)
    wav64 = wav.astype(np.float64)
    for t in range(n_frames):
        start = t * hop
        frame = wav64[start : start + win]
        if len(frame) < win:
            frame = np.pad(frame, (0, win - len(frame)))
        frame = frame - frame.mean()
        e = (frame ** 2).sum()
        if e < 1e-9:
            continue
        acf = np.correlate(frame * window, frame * window, mode="full")[win - 1 :]
        acf = acf / acf[0]
        r = acf[: lag_max + 1] / np.maximum(wacf[: lag_max + 1], 1e-6)
        seg = r[lag_min : lag_max + 1]
        k = int(np.argmax(seg)) + lag_min
        strength = r[k]
        if strength >= voicing_threshold and 0 < k < lag_max:
            # parabolic interpolation around the peak
            a, b, c = r[k - 1], r[k], r[k + 1]
            denom = a - 2 * b + c
            delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            lag = k + np.clip(delta, -1, 1)
            f0[t] = sr / lag
    if mel_len is not None:
        if len(f0) < mel_len:
            last = f0[-1] if len(f0) else 0.0
            f0 = np.concatenate([f0, np.full(mel_len - len(f0), last, np.float32)])
        f0 = f0[:mel_len]
    return f0
