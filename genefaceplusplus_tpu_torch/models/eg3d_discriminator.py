"""The EG3D dual discriminator, a camera-conditioned StyleGAN2 resnet
discriminator (port of `genefaceplusplus_tpu/models/eg3d_discriminator.py`),
with the radnerf_sr feature-matching configuration: channel_base 32768,
channel_max 512, 512^2 input, minibatch-std group 2, conv_clamp 256, a
25-d camera label through the mapping network.

NCHW activations and OIHW conv weights; `EqualDense` keeps its weight
[out, in] and `EqualConv2d` its weight OIHW under the flax leaf name
`weight`, so the weight bridge (`utils/convert_jax.py`) carries JAX's
params (HWIO there) across. Equalized learning rate: weights scaled at run
time by gain / sqrt(fan_in), biases by the lr multiplier, lrelu with gain
sqrt(2), outputs clamped to conv_clamp. Every float32 convolution runs
with TF32 off (`ops/upfirdn2d.py:conv2d`, `utils/device.py:conv_f32`).
The discriminator's output that the SR task uses is its feature maps, the
per-resolution block outputs (`feature_matching_loss`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from genefaceplusplus_tpu_torch.models.superresolution import FullyConnectedLayer
from genefaceplusplus_tpu_torch.ops.bias_act import bias_act
from genefaceplusplus_tpu_torch.ops.upfirdn2d import conv2d, setup_filter, upfirdn2d
from genefaceplusplus_tpu_torch.utils.device import conv_f32

_FILTER = setup_filter([1, 3, 3, 1])

# StyleGAN2's FullyConnectedLayer, as the SR's: weight [out, in] ~ N(0, 1) /
# lr_multiplier, y = x @ (w.T * lr / sqrt(in)) + b * lr, then bias_act
EqualDense = FullyConnectedLayer


class EqualConv2d(nn.Module):
    """StyleGAN2's Conv2dLayer: weight [out, in, k, k] ~ N(0, 1) scaled by
    1 / sqrt(in k k) at run time, an optional filtered stride-2 down (the
    FIR lowpass, then a VALID strided conv), bias_act with gain and clamp."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, down: int = 1,
                 use_bias: bool = True, activation: str = "linear", conv_clamp: Optional[float] = 256.0,
                 gain: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.down, self.activation = kernel, down, activation
        self.weight = nn.Parameter(torch.randn(features, in_channels, kernel, kernel, generator=generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.clamp = None if conv_clamp is None else conv_clamp * gain
        self.act_gain = {"linear": 1.0, "lrelu": math.sqrt(2.0)}[activation] * gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        w = self.weight * (1.0 / math.sqrt(self.weight.shape[1] * k * k))
        if self.down > 1:
            fw = _FILTER.shape[-1]
            p0 = k // 2 + (fw - self.down + 1) // 2
            p1 = k // 2 + (fw - self.down) // 2
            y = conv2d(upfirdn2d(x, _FILTER, padding=(p0, p1, p0, p1)), w, stride=self.down)
        else:
            y = conv_f32(x, w, padding=k // 2)  # SAME for an odd kernel
        return bias_act(y, self.bias, act=self.activation, gain=self.act_gain, clamp=self.clamp)


class DiscriminatorBlock(nn.Module):
    """The resnet block: fromrgb (first block only), conv0 (3x3), conv1
    (3x3, filtered stride-2 down) and the 1x1 bias-free skip, both halves
    scaled by sqrt(0.5)."""

    def __init__(self, tmp_channels: int, out_channels: int, img_channels: int = 6, first: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        if first:
            self.fromrgb = EqualConv2d(img_channels, tmp_channels, kernel=1, activation="lrelu", generator=g)
        self.skip = EqualConv2d(tmp_channels, out_channels, kernel=1, down=2, use_bias=False, conv_clamp=None,
                                gain=math.sqrt(0.5), generator=g)
        self.conv0 = EqualConv2d(tmp_channels, tmp_channels, kernel=3, activation="lrelu", generator=g)
        self.conv1 = EqualConv2d(tmp_channels, out_channels, kernel=3, down=2, activation="lrelu",
                                 gain=math.sqrt(0.5), generator=g)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor]) -> torch.Tensor:
        if img is not None:
            x = self.fromrgb(img)
        return self.skip(x) + self.conv1(self.conv0(x))


def minibatch_std(x: torch.Tensor, group_size: int = 2, num_channels: int = 1) -> torch.Tensor:
    """StyleGAN2's MinibatchStdLayer on x [N, C, H, W]: the batch's std over
    groups of G = min(group_size, N), averaged over channels and space,
    appended as `num_channels` channels. Batch element b = g n + i carries
    slot i's statistic (torch's repeat tiles along the batch)."""
    N, C, H, W = x.shape
    G = min(group_size, N)
    F = num_channels
    y = x.reshape(G, -1, F, C // F, H, W)
    y = y - y.mean(dim=0)
    y = torch.sqrt((y ** 2).mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))  # [n, F]
    y = y.reshape(-1, F, 1, 1).repeat(G, 1, H, W)[:N]
    return torch.cat([x, y], dim=1)


class MappingNetwork(nn.Module):
    """The camera label's mapping (z_dim 0): embed, normalise the second
    moment, then `num_layers` lrelu layers at lr multiplier 0.01."""

    def __init__(self, c_dim: int, w_dim: int, num_layers: int = 8, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.embed = EqualDense(c_dim, w_dim, generator=generator)
        for i in range(num_layers):
            setattr(self, f"fc{i}", EqualDense(w_dim, w_dim, activation="lrelu", lr_multiplier=0.01,
                                               generator=generator))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = self.embed(c)
        x = x * (1.0 / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + 1e-8))
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x


class EG3DDualDiscriminator(nn.Module):
    """The dual discriminator: the image [B, 3, R, R] and the raw render [B,
    3, R/2, R/2] (FIR-upsampled 2x, gain 4) concatenated to 6 channels and
    clamped to [-1, 1], the resnet blocks from R down to 8, then the
    epilogue (minibatch std, 3x3 conv, fc, out) projected on the camera's
    mapping. Returns (logits [B, 1], the blocks' outputs)."""

    def __init__(self, img_resolution: int = 512, channel_base: int = 32768, channel_max: int = 512,
                 camera_dim: int = 25, mbstd_group_size: int = 2, mapping_layers: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.mbstd_group_size = mbstd_group_size
        self.block_res = [2 ** i for i in range(int(math.log2(img_resolution)), 2, -1)]
        ch = {r: min(channel_base // r, channel_max) for r in self.block_res + [4]}
        self.cmap_dim = ch[4]
        for i, r in enumerate(self.block_res):
            setattr(self, f"b{r}", DiscriminatorBlock(ch[r], ch[r // 2], first=(i == 0), generator=g))
        self.mapping = MappingNetwork(camera_dim, self.cmap_dim, mapping_layers, generator=g)
        self.b4_conv = EqualConv2d(ch[4] + 1, ch[4], kernel=3, activation="lrelu", generator=g)
        self.b4_fc = EqualDense(ch[4] * 16, ch[4], activation="lrelu", generator=g)
        self.b4_out = EqualDense(ch[4], self.cmap_dim, generator=g)

    def forward(self, image: torch.Tensor, image_raw: torch.Tensor, camera: torch.Tensor, c_noise: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fw, up = _FILTER.shape[-1], 2
        p0, p1 = (fw + up - 1) // 2, (fw - up) // 2
        raw_up = upfirdn2d(image_raw, _FILTER, up=up, padding=(p0, p1, p0, p1), gain=4.0)
        img = torch.clamp(torch.cat([image, raw_up], dim=1), -1.0, 1.0)
        feats: List[torch.Tensor] = []
        x = None
        for i, r in enumerate(self.block_res):
            x = getattr(self, f"b{r}")(x, img if i == 0 else None)
            feats.append(x)
        c = camera
        if c_noise > 0 and generator is not None and camera.shape[0] > 1:  # the label noise (off for FM)
            c = c + torch.randn(c.shape, generator=generator, device=c.device) * c.std(0, correction=0) * c_noise
        cmap = self.mapping(c)
        x = self.b4_conv(minibatch_std(x, self.mbstd_group_size))
        x = self.b4_out(self.b4_fc(x.reshape(x.shape[0], -1)))  # NCHW flatten, as the reference's
        logits = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return logits, feats


def feature_matching_loss(fake_feats: List[torch.Tensor], real_feats: List[torch.Tensor]) -> torch.Tensor:
    """The mean L1 between fake and (detached) real feature maps, averaged
    over the maps."""
    total = 0.0
    for f, r in zip(fake_feats, real_feats):
        total = total + (f - r.detach()).abs().mean()
    return total / max(1, len(fake_feats))
