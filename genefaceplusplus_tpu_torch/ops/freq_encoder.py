"""NeRF positional (frequency) encoding (port of
`genefaceplusplus_tpu/ops/freq_encoder.py`).

Layout: [x_0..x_{D-1}, sin(2^0 x_*), cos(2^0 x_*), sin(2^1 x_*), cos(2^1 x_*), ...]
(each frequency block repeats all D dims). Output dim = D + D * 2 * degree.
"""

from __future__ import annotations

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """x: [..., D] -> [..., D + D*2*degree]."""
    outs = [x]
    for f in range(degree):
        scaled = x * (2.0 ** f)
        outs += [torch.sin(scaled), torch.cos(scaled)]
    return torch.cat(outs, dim=-1)
