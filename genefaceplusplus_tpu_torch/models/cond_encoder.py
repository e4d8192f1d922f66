"""Condition encoders for the dynamic NeRF (port of
`genefaceplusplus_tpu/models/cond_encoder.py`).

The public functions keep the JAX layout: the encoders take feature-last
`[B, T, C]`; inside, each convolution keeps `Conv1d`'s parameters and runs
on `[B, C, T]` as an im2col product (`conv3_apply`). Weights follow flax's
distributions: `lecun_normal` kernels (truncated normal, fan-in scaled) and
zero biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.02)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `lecun_normal`: truncated N(0, 1) on [-2, 2], scaled so the
    variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)


def dense(d_in: int, d_out: int, bias: bool, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=bias)
    lecun_normal_(layer.weight, d_in, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def conv3(c_in: int, c_out: int, stride: int, generator: Optional[torch.Generator]) -> nn.Conv1d:
    layer = nn.Conv1d(c_in, c_out, kernel_size=3, stride=stride, padding=1)
    lecun_normal_(layer.weight, 3 * c_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


def conv3_apply(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (kernel 3, padding 1) on x [B, C, T] as an explicit im2col
    product. The product runs as a float32 matmul, so the result does not
    depend on cuDNN's TF32 default for convolutions, and the tiny
    condition convolutions launch one GEMM instead of cuDNN's layout
    passes."""
    cols = F.pad(x, (1, 1)).unfold(2, 3, conv.stride[0])  # [B, C, T_out, 3]
    return torch.einsum("bctk,ock->bot", cols, conv.weight) + conv.bias[None, :, None]


def _audio_net_strides(win_size: int) -> Sequence[int]:
    if win_size == 1:
        return (1, 1, 1, 1)
    if win_size == 2:
        return (2, 1, 1, 1)
    if win_size in (3, 4):
        return (2, 2, 1, 1)
    if win_size in (5, 8):
        return (2, 2, 2, 1)
    if win_size == 16:
        return (2, 2, 2, 2)
    raise ValueError(f"unsupported win_size {win_size}")


class AudioNet(nn.Module):
    """[B, T_win, C_in] -> [B, dim_aud] condition feature."""

    def __init__(self, dim_in: int = 29, dim_aud: int = 64, win_size: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = (32, 32, 64, 64)
        ins = (dim_in,) + chans[:-1]
        self.convs = nn.ModuleList(
            conv3(i, o, s, generator) for i, o, s in zip(ins, chans, _audio_net_strides(win_size)))
        self.dense = nn.ModuleList([dense(64, 64, True, generator), dense(64, dim_aud, True, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)  # [B, C, T]
        for conv in self.convs:
            h = leaky_relu(conv3_apply(conv, h))
        h = h[:, :, 0]
        h = leaky_relu(self.dense[0](h))
        return self.dense[1](h)


class AudioAttNet(nn.Module):
    """[T_smo, C] -> [C]: attention-weighted temporal smoothing."""

    def __init__(self, in_out_dim: int = 64, seq_len: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_out_dim = in_out_dim
        self.seq_len = seq_len
        chans = (16, 8, 4, 2, 1)
        ins = (in_out_dim,) + chans[:-1]
        self.convs = nn.ModuleList(conv3(i, o, 1, generator) for i, o in zip(ins, chans))
        self.dense = nn.ModuleList([dense(seq_len, seq_len, True, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[None, :, : self.in_out_dim].transpose(1, 2)  # [1, C, T]
        for conv in self.convs:
            y = leaky_relu(conv3_apply(conv, y))
        y = y.reshape(1, self.seq_len)
        y = torch.softmax(self.dense[0](y), dim=1).reshape(self.seq_len, 1)
        return (y * x).sum(dim=0)


class MLP(nn.Module):
    """Bias-free Linear+ReLU stack. `dtype=torch.bfloat16` runs each layer
    with bf16 inputs, weights and outputs (flax `Dense(dtype=bf16)`);
    None runs in float32."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int, num_layers: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.dense = nn.ModuleList(
            dense(dims[i], dims[i + 1], False, generator) for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            if self.dtype is None:
                x = layer(x)
            else:
                x = F.linear(x.to(self.dtype), layer.weight.to(self.dtype))
            if i != len(self.dense) - 1:
                x = F.relu(x)
        return x
