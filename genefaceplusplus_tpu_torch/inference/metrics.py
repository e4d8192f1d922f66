"""Serving observability: thread-safe counters and latency histograms (the
port's copy of `genefaceplusplus_tpu/inference/metrics.py`, which uses no
jax).

One module-level registry, `METRICS`, records how many streams ran, how
many frames were pushed or dropped by backpressure, the gap between emitted
frames (does the stream keep up with 25 fps) and the realtime factor of
completed streams. Histograms have fixed bucket edges, so a snapshot is a
plain dict; one lock guards everything (a record takes microseconds).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence


class LatencyHistogram:
    """Fixed-bucket histogram of millisecond latencies.

    `edges` are upper bounds; an implicit +inf bucket catches the rest.
    """

    DEFAULT_EDGES_MS = (5.0, 10.0, 20.0, 40.0, 60.0, 100.0, 200.0, 500.0,
                        1000.0, 5000.0)

    def __init__(self, edges_ms: Sequence[float] = DEFAULT_EDGES_MS):
        self.edges = tuple(float(e) for e in edges_ms)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        i = 0
        for i, e in enumerate(self.edges):
            if ms <= e:
                break
        else:
            i = len(self.edges)
        self.counts[i] += 1
        self.total += 1
        self.sum_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def snapshot(self) -> Dict:
        out = {"total": self.total, "sum_ms": round(self.sum_ms, 3),
               "mean_ms": round(self.sum_ms / self.total, 3) if self.total else None,
               "max_ms": round(self.max_ms, 3), "buckets": {}}
        lo = 0.0
        for e, c in zip(self.edges, self.counts):
            out["buckets"][f"le_{e:g}ms"] = c
            lo = e
        out["buckets"][f"gt_{lo:g}ms"] = self.counts[-1]
        return out


class ServingMetrics:
    """Registry for the streaming endpoints (/stream MJPEG, /ws push)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self.streams_started = 0
            self.streams_completed = 0
            self.streams_failed = 0
            self.frames_pushed = 0
            self.frames_dropped = 0
            self.frame_gap = LatencyHistogram()       # renderer emit cadence
            self.push_latency = LatencyHistogram()    # socket write time
            self.rtf_last: Optional[float] = None
            self.rtf_all: List[float] = []

    # -- stream lifecycle ---------------------------------------------------
    def stream_started(self) -> None:
        with self._lock:
            self.streams_started += 1

    def stream_finished(self, ok: bool, audio_seconds: float = 0.0,
                        wall_seconds: float = 0.0) -> None:
        with self._lock:
            if ok:
                self.streams_completed += 1
            else:
                self.streams_failed += 1
            if ok and audio_seconds > 0 and wall_seconds > 0:
                rtf = wall_seconds / audio_seconds
                self.rtf_last = rtf
                self.rtf_all.append(rtf)

    # -- per-frame ------------------------------------------------------------
    def frame_emitted(self, gap_ms: float) -> None:
        with self._lock:
            self.frame_gap.record(gap_ms)

    def frame_pushed(self, push_ms: float) -> None:
        with self._lock:
            self.frames_pushed += 1
            self.push_latency.record(push_ms)

    def frame_dropped(self, n: int = 1) -> None:
        with self._lock:
            self.frames_dropped += n

    def snapshot(self) -> Dict:
        with self._lock:
            rtfs = list(self.rtf_all)
            return {
                "streams": {"started": self.streams_started,
                            "completed": self.streams_completed,
                            "failed": self.streams_failed},
                "frames": {"pushed": self.frames_pushed,
                           "dropped": self.frames_dropped},
                "frame_gap_ms": self.frame_gap.snapshot(),
                "push_latency_ms": self.push_latency.snapshot(),
                "rtf": {"last": self.rtf_last,
                        "mean": (sum(rtfs) / len(rtfs)) if rtfs else None,
                        "count": len(rtfs)},
            }


METRICS = ServingMetrics()


def instrumented(frames, metrics: ServingMetrics = METRICS):
    """Wrap a frame iterator: records the inter-emit gap per frame and the
    stream's realtime factor at the end (audio seconds inferred at 25 fps)."""
    metrics.stream_started()
    t_start = time.perf_counter()
    t_prev = t_start
    n = 0
    try:
        for frame in frames:
            now = time.perf_counter()
            metrics.frame_emitted((now - t_prev) * 1e3)
            t_prev = now
            n += 1
            yield frame
    except BaseException:
        metrics.stream_finished(ok=False)
        raise
    metrics.stream_finished(ok=True, audio_seconds=n / 25.0,
                            wall_seconds=time.perf_counter() - t_start)
