"""Pitch (F0) quantisation (port of `genefaceplusplus_tpu/utils/pitch.py`).

A 256-bin mel-scale quantiser over [50, 1100] Hz: bin 1 is unvoiced or
low, bin 255 the top. Computed in float32 with JAX's constants and
operation order, so the bins are JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantise F0 in Hz to integer bins in [1, 255] (int64). 0 Hz -> 1."""
    f0 = torch.as_tensor(f0, dtype=torch.float32)
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - float(F0_MEL_MIN)) * (F0_BIN - 2) / float(F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, F0_BIN - 1)
    # the reference's (x + 0.5).long() == floor(x + 0.5)
    return torch.floor(f0_mel + 0.5).long()


def coarse_to_f0(coarse: torch.Tensor) -> torch.Tensor:
    """Inverse of `f0_to_coarse` (bin centres); bin 1 -> 0 Hz."""
    coarse = torch.as_tensor(coarse)
    f0_mel = (coarse - 1) * float(F0_MEL_MAX - F0_MEL_MIN) / (F0_BIN - 2) + float(F0_MEL_MIN)
    f0 = (torch.exp(f0_mel.float() / 1127.0) - 1.0) * 700.0
    return torch.where(coarse == 1, torch.zeros_like(f0), f0)
