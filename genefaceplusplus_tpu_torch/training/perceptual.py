"""Perceptual (LPIPS-style) loss for the lip and SR training steps (port of
`genefaceplusplus_tpu/training/perceptual.py`).

  * `arch="small"` (the default): a fixed random-weight VGG-style stack
    (conv-relu-conv-relu per width, 2x2 average pools), distance = mean
    squared difference of channel-normalised features on inputs in [-1, 1].
  * `arch="vgg19"`: the VGG19 relu_x_1 pyramid with the layer weights
    {1/32, 1/16, 1/8, 1/4, 1}, ImageNet normalisation, L1 distance and
    `N_SCALE` (3) more passes at half resolution (the deepest layer only;
    bilinear with antialiasing, as `jax.image.resize` downsamples), plus
    the VGGFace (VGG16) term on 255-scale inputs when its weights are given.

Weights are fixed. Files are the flax msgpack trees the JAX package reads
(`scripts/convert_vgg.py`), read with `utils/msgpack.py` and converted by
the weight bridge (`Conv_i` -> `convs.i`, HWIO -> OIHW). Without a file the
towers start from flax's default initialisation's distribution (truncated
lecun normal, zero bias) drawn from a torch generator, so the random
weights differ from JAX's `PRNGKey(0)` ones: tests carry JAX's across.
Inputs are NHWC in [0, 1], as in JAX; the convolutions run in full
float32, forward and backward (`utils/device.py:Conv2d`), whatever cuDNN's
TF32 flag says.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.utils import msgpack
from genefaceplusplus_tpu_torch.utils.convert_jax import load_flax_tree
from genefaceplusplus_tpu_torch.utils.device import Conv2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# torchvision vgg19.features conv plan: (out_channels, max pool before)
VGG19_PLAN = (
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False), (256, False),
    (512, True), (512, False), (512, False), (512, False),
    (512, True), (512, False), (512, False), (512, False),
)
VGG19_RELU_X1 = (0, 2, 4, 8, 12)
VGG19_LAYER_WEIGHTS = (0.03125, 0.0625, 0.125, 0.25, 1.0)
VGG16_PLAN = (
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
)
VGG16_RELU_X1 = (0, 2, 4, 7, 10)
VGGFACE_MEAN = (129.186279296875 / 255.0, 104.76238250732422 / 255.0, 93.59396362304688 / 255.0)
SMALL_WIDTHS = (32, 64, 128, 256)
N_SCALE = 3  # vgg19's extra half-resolution passes


def _conv_stack(widths, generator: Optional[torch.Generator]) -> nn.ModuleList:
    """3x3 'SAME' convolutions from 3 channels, initialised as flax's
    `nn.Conv` is (truncated lecun normal kernels, zero biases)."""
    convs, c_in = nn.ModuleList(), 3
    for w in widths:
        conv = Conv2d(c_in, w, 3, padding=1)
        std = math.sqrt(1.0 / (9 * c_in)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.bias.zero_()
        convs.append(conv)
        c_in = w
    return convs


class VGGFeatures(nn.Module):
    """The small stack: per width conv-relu-conv-relu, a feature map, a 2x2
    average pool."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = _conv_stack([w for w in SMALL_WIDTHS for _ in range(2)], generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i in range(0, len(self.convs), 2):
            x = F.relu(self.convs[i + 1](F.relu(self.convs[i](x))))
            feats.append(x)
            if i + 2 < len(self.convs):  # the last pool's output is unused
                x = F.avg_pool2d(x, 2)
        return feats


class PlanFeatures(nn.Module):
    """A VGG feature extractor by conv plan (VGG19: `VGG19_PLAN`; VGGFace's
    VGG16: `VGG16_PLAN`) -> the relu_x_1 pyramid."""

    def __init__(self, plan, relu_x1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool_before = [p for _, p in plan]
        self.relu_x1 = set(relu_x1)
        self.convs = _conv_stack([w for w, _ in plan], generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, conv in enumerate(self.convs):
            if self.pool_before[i]:
                x = F.max_pool2d(x, 2)
            x = F.relu(conv(x))
            if i in self.relu_x1:
                feats.append(x)
        return feats


def _read_tree(path: str):
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


class PerceptualLoss(nn.Module):
    """Multi-scale fixed-feature distance (module docstring)."""

    def __init__(self, seed: int = 0, weights_path: Optional[str] = None, arch: str = "small",
                 vggface_weights_path: Optional[str] = None, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.arch = arch
        self.vggface = None
        if arch == "vgg19":
            self.net = PlanFeatures(VGG19_PLAN, VGG19_RELU_X1, gen)
            if vggface_weights_path:
                self.vggface = PlanFeatures(VGG16_PLAN, VGG16_RELU_X1, gen)
                load_flax_tree(self.vggface, _read_tree(vggface_weights_path))
        else:
            self.net = VGGFeatures(gen)
        if weights_path:
            self.load_pretrained(weights_path)
        self.requires_grad_(False)
        if device is not None:
            self.to(device)

    def load_pretrained(self, path: str):
        load_flax_tree(self.net, _read_tree(path))

    def forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """pred/gt: [B, H, W, 3] in [0, 1] -> a scalar."""
        a, b = pred.permute(0, 3, 1, 2).float(), gt.permute(0, 3, 1, 2).float()
        if self.arch == "vgg19":
            return self._vgg_loss(a, b)
        total = a.new_zeros(())
        for x, y in zip(self.net(a * 2 - 1), self.net(b * 2 - 1)):
            xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)
            yn = y / (torch.linalg.vector_norm(y, dim=1, keepdim=True) + 1e-8)
            total = total + torch.mean((xn - yn) ** 2)
        return total

    def _vgg_loss(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        lw = VGG19_LAYER_WEIGHTS
        total = a.new_zeros(())
        if self.vggface is not None:
            face_mean = a.new_tensor(VGGFACE_MEAN)[None, :, None, None]
            fa = self.vggface((a - face_mean) * 255.0)
            fb = self.vggface((b - face_mean) * 255.0)
            face = sum(w * torch.mean(torch.abs(x - y)) / 255.0 for w, x, y in zip(lw, fa, fb))
            total = total + face
        mean = a.new_tensor(IMAGENET_MEAN)[None, :, None, None]
        std = a.new_tensor(IMAGENET_STD)[None, :, None, None]
        a, b = (a - mean) / std, (b - mean) / std
        for scale in range(1 + N_SCALE):
            fa, fb = self.net(a), self.net(b)
            if scale == 0:
                for w, x, y in zip(lw, fa, fb):
                    total = total + w * torch.mean(torch.abs(x - y))
            else:  # the extra scales use the deepest layer
                total = total + lw[-1] * torch.mean(torch.abs(fa[-1] - fb[-1]))
            if scale < N_SCALE:
                H, W = a.shape[2:]
                if min(H, W) < 64:
                    break
                a = F.interpolate(a, size=(H // 2, W // 2), mode="bilinear", align_corners=False,
                                  antialias=True)
                b = F.interpolate(b, size=(H // 2, W // 2), mode="bilinear", align_corners=False,
                                  antialias=True)
        return total


def perceptual_from_task_config(tcfg, device=None) -> PerceptualLoss:
    """The perceptual loss a task config names (`perceptual_arch`,
    `vgg_weights_path`, `vggface_weights_path`). A weights path implies
    arch='vgg19' and must exist: a missing file raises instead of training
    on the random-weight stack."""
    arch = getattr(tcfg, "perceptual_arch", "small") or "small"
    wp = getattr(tcfg, "vgg_weights_path", "") or None
    fwp = getattr(tcfg, "vggface_weights_path", "") or None
    if wp or fwp:
        arch = "vgg19"
    for name, p in (("vgg_weights_path", wp), ("vggface_weights_path", fwp)):
        if p and not os.path.exists(p):
            raise FileNotFoundError(
                f"{name}={p!r} configured but not found; refusing to fall back to the "
                "random-weight perceptual stack (convert weights with scripts/convert_vgg.py "
                "or unset the path)")
    return PerceptualLoss(seed=0, arch=arch, weights_path=wp, vggface_weights_path=fwp, device=device)
