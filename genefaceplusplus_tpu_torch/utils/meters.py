"""Averaging and timing meters (port of `genefaceplusplus_tpu/utils/meters.py`).

`Timer` adds up each name's wall time over its `with` blocks and prints
every `print_interval` hits. Given `sync` (a tensor), it waits for that
tensor's CUDA device (`torch.cuda.synchronize`) before reading the clock,
where JAX blocks on an array."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import torch


class AvgrageMeter:  # the reference's spelling
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


class Timer:
    totals = defaultdict(float)
    counts = defaultdict(int)

    def __init__(self, name: str, enable: bool = True, print_interval: int = 100,
                 sync: Optional[torch.Tensor] = None):
        self.name = name
        self.enable = enable
        self.print_interval = print_interval
        self.sync = sync

    def __enter__(self):
        if self.enable:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enable:
            return
        if self.sync is not None and self.sync.is_cuda:
            torch.cuda.synchronize(self.sync.device)
        dt = time.perf_counter() - self.t0
        Timer.totals[self.name] += dt
        Timer.counts[self.name] += 1
        if Timer.counts[self.name] % self.print_interval == 0:
            print(f"| Timer[{self.name}]: total {Timer.totals[self.name]:.2f}s "
                  f"over {Timer.counts[self.name]} hits")
