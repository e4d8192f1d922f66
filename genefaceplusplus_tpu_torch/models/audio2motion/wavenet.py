"""Non-causal WaveNet stack with gated activations and global conditioning
(port of `genefaceplusplus_tpu/models/audio2motion/wavenet.py`).

Dilated conv -> gated tanh * sigmoid (plus this layer's slice of the 1x1
condition projection) -> residual and skip 1x1 convs. The interface keeps
JAX's feature-last layout [B, T, C]; inside, the convolutions run on
[B, C, T]. Module names are JAX's (`cond_layer`, `in_layer_i`,
`res_skip_layer_i`), so the weight bridge maps them one to one.

`Conv1d` and `ConvTranspose1d` are the a2m's convolutions: a float32
convolution runs in full float32, forward and backward
(`utils/device.py:conv_f32`), whatever cuDNN's TF32 flag says. Weights
follow flax's initialisers: `lecun_normal` kernels, zero biases.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.models.cond_encoder import lecun_normal_
from genefaceplusplus_tpu_torch.utils.device import Float32Conv, conv_f32


class Conv1d(Float32Conv, nn.Conv1d):
    """`nn.Conv1d` on [B, C, T], in full float32."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__(c_in, c_out, kernel_size, stride=stride, padding=padding, dilation=dilation,
                         bias=bias)
        lecun_normal_(self.weight, kernel_size * c_in, generator)
        if bias:
            nn.init.zeros_(self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """`nn.ConvTranspose1d` (kernel = stride, no padding) on [B, C, T], in
    full float32. torch flips the kernel where flax's `ConvTranspose` does
    not: the weight bridge flips it."""

    def __init__(self, c_in: int, c_out: int, stride: int, generator: Optional[torch.Generator] = None):
        super().__init__(c_in, c_out, stride, stride=stride)
        lecun_normal_(self.weight, stride * c_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_f32(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups,
                        transposed=True, output_padding=self.output_padding)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden_channels
        self.hidden_channels, self.n_layers, self.gin_channels = H, n_layers, gin_channels
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels, 2 * H * n_layers, 1, generator=generator)
        for i in range(n_layers):
            dilation = dilation_rate ** i
            pad = (kernel_size * dilation - dilation) // 2
            setattr(self, f"in_layer_{i}", Conv1d(H, 2 * H, kernel_size, padding=pad, dilation=dilation,
                                                  generator=generator))
            res_skip = 2 * H if i < n_layers - 1 else H
            setattr(self, f"res_skip_layer_{i}", Conv1d(H, res_skip, 1, generator=generator))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, H], x_mask [B, T, 1] (ones when None), g [B, T, gin] ->
        [B, T, H]."""
        H = self.hidden_channels
        x = channels_first(x)
        mask = torch.ones_like(x[:, :1]) if x_mask is None else channels_first(x_mask)
        output = torch.zeros_like(x)
        g_all = self.cond_layer(channels_first(g)) if g is not None and self.gin_channels > 0 else None
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_layer_{i}")(x)
            g_l = g_all[:, i * 2 * H:(i + 1) * 2 * H] if g_all is not None else torch.zeros_like(x_in)
            acts = torch.tanh(x_in[:, :H] + g_l[:, :H]) * torch.sigmoid(x_in[:, H:] + g_l[:, H:])
            rs = getattr(self, f"res_skip_layer_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + rs[:, :H]) * mask
                output = output + rs[:, H:]
            else:
                output = output + rs
        return channels_first(output * mask)
