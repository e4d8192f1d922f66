"""The compact camera-conditioned dual discriminator (port of
`genefaceplusplus_tpu/models/dual_discriminator.py`): the small stack the
SR task's `disc_arch: "compact"` uses (tests, tiny resolutions), where the
reference's mechanism is `models/eg3d_discriminator.py`.

The image [B, 3, R, R] and the raw render [B, 3, R/2, R/2] (FIR-upsampled
2x, gain 4) concatenated to 6 channels; `n_down` times a 3x3 conv, lrelu
0.2 (a feature map) and a FIR 2x downsample; the last map flattened in
JAX's NHWC order, joined with the camera's 128-d projection, then two
dense layers to the logit. Module names follow the weight bridge
(`convs.i` for flax's `Conv_i`, `dense.i` for `Dense_i`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.models.cond_encoder import lecun_normal_
from genefaceplusplus_tpu_torch.models.eg3d_discriminator import feature_matching_loss  # noqa: F401
from genefaceplusplus_tpu_torch.ops.upfirdn2d import downsample2d, setup_filter, upfirdn2d
from genefaceplusplus_tpu_torch.utils.device import Conv2d

_F = setup_filter([1, 3, 3, 1])


def _lecun(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's default init: lecun normal weights, zero bias."""
    lecun_normal_(module.weight, module.weight[0].numel(), generator)
    nn.init.zeros_(module.bias)
    return module


class DualDiscriminator(nn.Module):
    def __init__(self, img_resolution: int, base_channels: int = 32, max_channels: int = 256, n_down: int = 5,
                 camera_dim: int = 25, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        chans = [min(base_channels * 2 ** i, max_channels) for i in range(n_down)]
        self.convs = nn.ModuleList(_lecun(Conv2d(c_in, c_out, 3, padding=1), g)
                                   for c_in, c_out in zip([6] + chans[:-1], chans))
        flat = chans[-1] * (img_resolution >> n_down) ** 2
        self.dense = nn.ModuleList(_lecun(nn.Linear(i, o), g)
                                   for i, o in ((camera_dim, 128), (flat + 128, 256), (256, 1)))

    def forward(self, image: torch.Tensor, image_raw: torch.Tensor, camera: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """image [B, 3, R, R], image_raw [B, 3, R/2, R/2], camera [B, 25] ->
        (logits [B, 1], the feature maps)."""
        raw_up = upfirdn2d(image_raw, _F, up=2, padding=(2, 1, 2, 1), gain=4.0)
        x = torch.cat([image, raw_up], dim=1)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
            feats.append(x)
            x = downsample2d(x, _F)
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's NHWC flatten
        h = torch.cat([h, self.dense[0](camera)], dim=-1)
        logits = self.dense[2](F.leaky_relu(self.dense[1](h), 0.2))
        return logits, feats
