"""Invertible normalising-flow prior: residual coupling blocks (port of
`genefaceplusplus_tpu/models/audio2motion/flow.py`).

Mean-only affine coupling (a pure shift of the second half by a WaveNet of
the first), a zero-initialised `post` projection, and a channel flip
between flows; `reverse=True` inverts exactly. Feature-last [B, T, C].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.models.audio2motion.wavenet import WN, Conv1d, channels_first


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, mean_only: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = Conv1d(self.half, hidden_channels, 1, generator=generator)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels=gin_channels,
                      generator=generator)
        self.post = Conv1d(hidden_channels, self.half * (1 if mean_only else 2), 1, generator=generator)
        nn.init.zeros_(self.post.weight)  # flax's zeros init: at init the flow is the identity

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, reverse: bool = False) -> torch.Tensor:
        half = self.half
        if x_mask is None:
            x_mask = torch.ones_like(x[..., :1])
        x0, x1 = x[..., :half], x[..., half:]
        h = channels_first(self.pre(channels_first(x0))) * x_mask
        h = self.enc(h, x_mask, g)
        stats = channels_first(self.post(channels_first(h))) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[..., :half], stats[..., half:]
        if not reverse:
            x1 = m + x1 * torch.exp(logs) * x_mask
        else:
            x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=-1)


class ResidualCouplingBlock(nn.Module):
    """[coupling, flip] x n_flows; the flows are `flow_i`, as in JAX."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, n_flows: int = 4, gin_channels: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            setattr(self, f"flow_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels, mean_only=True, generator=generator))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, reverse: bool = False) -> torch.Tensor:
        flows = [getattr(self, f"flow_{i}") for i in range(self.n_flows)]
        if not reverse:
            for flow in flows:
                x = torch.flip(flow(x, x_mask, g=g), dims=(-1,))
        else:
            for flow in reversed(flows):
                x = flow(torch.flip(x, dims=(-1,)), x_mask, g=g, reverse=True)
        return x
