"""Learnable multi-scale Fourier position features (port of
`genefaceplusplus_tpu/ops/fourier_encoder.py`).

gamma(x) = [sin(2*pi x @ B^T), cos(2*pi x @ B^T)], B [F, D] initialised
N(0, 1) scaled per row by log-spaced frequencies.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from genefaceplusplus_tpu_torch.ops.fastmath import fast_cos, fast_sin


def multiscale_scales(num_features: int, min_scale: float, max_scale: float) -> np.ndarray:
    """Log-spaced per-row frequency scales (analogue of grid levels)."""
    return np.logspace(np.log10(min_scale), np.log10(max_scale), num_features).astype(np.float32)


def project(x: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ Bt [D, F] in full float32.

    The phase reaches hundreds of radians at the top scale, where TF32's
    10-bit mantissa would lose a large fraction of a radian, so a CUDA
    tensor refuses to run with TF32 matmuls enabled. (On the CPU the
    product equals XLA's fused multiply-add chain bit for bit.)"""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("Fourier projection needs full float32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return x @ Bt


class FourierEncoder(nn.Module):
    """[..., D] in [-bound, bound] -> [..., 2*num_features]."""

    def __init__(self, input_dim: int = 3, num_features: int = 128,
                 min_scale: float = 1.0, max_scale: float = 256.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = input_dim
        self.num_features = num_features
        scales = torch.from_numpy(multiscale_scales(num_features, min_scale, max_scale))
        B = torch.randn(num_features, input_dim, generator=generator) * scales[:, None]
        self.B = nn.Parameter(B)

    @property
    def output_dim(self) -> int:
        return 2 * self.num_features

    def forward(self, x: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        x01 = x / bound
        proj = (2.0 * math.pi) * project(x01, self.B.t().to(x01.dtype))
        return torch.cat([fast_sin(proj), fast_cos(proj)], dim=-1)
