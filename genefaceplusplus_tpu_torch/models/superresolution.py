"""StyleGAN2-style 2x super-resolution head (port of
`genefaceplusplus_tpu/models/superresolution.py`).

`Superresolution` takes and returns NHWC images, as JAX's does; inside,
activations are NCHW views of them (channels-last in memory, the layout
cuDNN's bf16 convolutions prefer) and conv weights are OIHW. Parameters
stay float32; with `dtype=torch.bfloat16` (the production `sr_dtype`) the
blocks compute in bf16 and the img/skip sum stays float32. The style
products are elementwise sums, and every float32 convolution runs with
TF32 off (`ops/upfirdn2d.py:conv2d`), so the float32 SR does not depend on
either TF32 flag. `noise_const` is a buffer (flax's `buffers` collection):
the weight bridge carries it across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.ops.bias_act import bias_act
from genefaceplusplus_tpu_torch.ops.upfirdn2d import conv2d_resample, setup_filter, upsample2d

RESAMPLE_FILTER = setup_filter([1, 3, 3, 1])
CONV_CLAMP = 256.0  # conv_clamp of every layer (radnerf_sr.py)


class FullyConnectedLayer(nn.Module):
    """weight [out, in] ~ N(0, 1) / lr_multiplier, scaled at run time by
    lr_multiplier / sqrt(in); bias scaled by lr_multiplier."""

    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(torch.randn(out_features, in_features, generator=generator)
                                   / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * (self.lr_multiplier / math.sqrt(self.in_features))
        x = (x[..., None, :] * w.to(x.dtype)).sum(-1)  # a tiny product, kept off TF32
        return bias_act(x, (self.bias * self.lr_multiplier).to(x.dtype), act=self.activation, dim=-1)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1, padding: int = 0,
                     resample_filter=None, demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    """Style-modulated conv of x [B, I, H, W] with weight [O, I, kh, kw] and
    styles [B, I] (unfused: scale the activations before and after the
    conv, the same math as the fused grouped conv)."""
    O, I, kh, kw = weight.shape
    if x.dtype == torch.bfloat16 and demodulate:
        # low-precision pre-normalisation (networks_stylegan2.py:57-60)
        wnorm = weight.abs().amax(dim=(1, 2, 3), keepdim=True)
        weight = weight * (1.0 / math.sqrt(I * kh * kw) / wnorm)
        styles = styles / styles.abs().amax(dim=1, keepdim=True)

    dcoefs = None
    if demodulate:
        wmod = weight[None] * styles[:, None, :, None, None]  # [B, O, I, kh, kw]
        dcoefs = torch.rsqrt((wmod.float() ** 2).sum(dim=(2, 3, 4)) + 1e-8)  # [B, O]

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class SynthesisLayer(nn.Module):
    """Modulated 3x3 conv (up 1 or 2) + const noise + bias, lrelu, clamp."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = up
        self.padding = kernel_size // 2
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size,
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.register_buffer("noise_const", torch.randn(resolution, resolution, generator=generator))

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "const",
                noise_offset=(0, 0)) -> torch.Tensor:
        """x [B, I, H, W] -> [B, O, H*up, W*up], with the const noise
        (noise_mode 'const') or none ('none'; JAX's 'random' is a training
        mode, not ported). The output may be a sub-rect of `resolution` (SR
        on a crop): `noise_offset` is the crop's top-left at this layer's
        resolution, so the sliced noise is the full frame's at those pixels."""
        if noise_mode not in ("const", "none"):
            raise ValueError(f"noise_mode={noise_mode!r}: 'const' or 'none'")
        styles = self.affine(w)
        noise = None
        if noise_mode == "const":
            r0, c0 = noise_offset
            const = self.noise_const[r0:r0 + x.shape[2] * self.up, c0:c0 + x.shape[3] * self.up]
            noise = (const * self.noise_strength)[None, None]
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up, padding=self.padding,
                             resample_filter=RESAMPLE_FILTER, flip_weight=self.up == 1)
        return bias_act(x, self.bias.to(x.dtype), act="lrelu", gain=math.sqrt(2.0), clamp=CONV_CLAMP)


class ToRGBLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size,
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), clamp=CONV_CLAMP)


class SynthesisBlock(nn.Module):
    """'skip'-architecture block: conv0 (up) -> conv1 -> toRGB + upsampled skip."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int = 3, up: int = 2, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = up
        self.dtype = dtype
        g = generator
        self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up, generator=g)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution, generator=g)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, generator=g)

    def forward(self, x, img, ws, noise_mode: str = "const", noise_offset=(0, 0)):
        x = x.to(self.dtype)
        # noise_offset arrives at the block's input resolution; both layers
        # emit at input * up
        off = (noise_offset[0] * self.up, noise_offset[1] * self.up)
        x = self.conv0(x, ws[:, 0], noise_mode=noise_mode, noise_offset=off)
        x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, noise_offset=off)
        if self.up > 1:
            img = upsample2d(img, RESAMPLE_FILTER)
        return x, img + self.torgb(x, ws[:, 2]).float()


class Superresolution(nn.Module):
    """2x SR head: [B, H, W, 3] raw render -> [B, 2H, 2W, 3], float32 out."""

    def __init__(self, channels: int = 3, input_resolution: int = 256, w_dim: int = 16,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_dim = w_dim
        self.block0 = SynthesisBlock(channels, 128, w_dim, resolution=input_resolution, up=1,
                                     dtype=dtype, generator=generator)
        self.block1 = SynthesisBlock(128, 64, w_dim, resolution=input_resolution * 2, up=2,
                                     dtype=dtype, generator=generator)

    def forward(self, rgb: torch.Tensor, noise_mode: str = "const", noise_offset=(0, 0)) -> torch.Tensor:
        """When rgb is a sub-rect of the frame (sr_crop), noise_offset is its
        top-left at the input resolution."""
        ws = torch.ones((rgb.shape[0], 3, self.w_dim), dtype=torch.float32, device=rgb.device)
        x = img = rgb.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
        x, img = self.block0(x, img, ws, noise_mode=noise_mode, noise_offset=noise_offset)
        x, img = self.block1(x, img, ws, noise_mode=noise_mode, noise_offset=noise_offset)
        return img.permute(0, 2, 3, 1)
