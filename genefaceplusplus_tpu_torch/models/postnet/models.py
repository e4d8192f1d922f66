"""Pitch-conditioned CNN postnet: landmark refinement (port of
`genefaceplusplus_tpu/models/postnet/models.py`).

postnet(raw lm3d [B, T, out_dim], pitch [B, 2T, C]) -> refined [B, T,
out_dim]: the pitch is downsampled 2x (every second frame), cut to T
frames and edge-padded where shorter, concatenated to the landmarks, then
a k3 conv, `n_layers` residual blocks (a k3 conv of dilation 2^i and
padding 2^i, tanh-approximated GELU as flax's `nn.gelu` default, a 1x1
conv) and a 1x1 conv to the residual, which starts at zero: a fresh
postnet is the identity. flax's `Conv_0 .. Conv_{2n+1}` are `convs.0 ..
convs.{2n+1}` (the weight bridge maps them); feature-last I/O, the
convolutions in full float32 (`wavenet.Conv1d`).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import downsample2x_nearest
from genefaceplusplus_tpu_torch.models.audio2motion.wavenet import Conv1d, channels_first


class PitchContourCNNPostNet(nn.Module):
    def __init__(self, out_dim: int = 204, hidden: int = 256, n_layers: int = 4, pitch_dim: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        convs = [Conv1d(out_dim + pitch_dim, hidden, 3, padding=1, generator=g)]
        for i in range(n_layers):
            convs += [Conv1d(hidden, hidden, 3, padding=2 ** i, dilation=2 ** i, generator=g),
                      Conv1d(hidden, hidden, 1, generator=g)]
        convs.append(Conv1d(hidden, out_dim, 1, generator=g))
        nn.init.zeros_(convs[-1].weight)  # flax's zeros kernel_init: the identity at init
        self.convs = nn.ModuleList(convs)
        self.n_layers = n_layers

    def forward(self, lm3d: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
        """lm3d [B, T, out_dim]; pitch [B, 2T, C] -> refined [B, T, out_dim]."""
        T = lm3d.shape[1]
        pitch = downsample2x_nearest(pitch)[:, :T]
        if pitch.shape[1] < T:
            pitch = torch.cat([pitch, pitch[:, -1:].expand(-1, T - pitch.shape[1], -1)], dim=1)
        h = self.convs[0](channels_first(torch.cat([lm3d, pitch], dim=-1)))
        for i in range(self.n_layers):
            r = F.gelu(self.convs[2 * i + 1](h), approximate="tanh")
            h = h + self.convs[2 * i + 2](r)
        return lm3d + channels_first(self.convs[-1](h))


def postnet_from_hparams(hp: Mapping[str, Any], generator: Optional[torch.Generator] = None
                         ) -> PitchContourCNNPostNet:
    """The postnet `GeneFaceInfer` builds from a postnet work dir's config
    (the keys and defaults JAX reads at `inference/pipeline.py:141-146`)."""
    return PitchContourCNNPostNet(out_dim=hp.get("postnet_out_dim", 204), hidden=hp.get("postnet_hidden", 256),
                                  n_layers=hp.get("postnet_layers", 4), generator=generator)
