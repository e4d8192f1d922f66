"""Torso model: a 2D deformable field in the image plane, composited behind
the head (port of `genefaceplusplus_tpu/models/radnerf_torso.py`).

Per pixel: coords shrunk by `torso_shrink`, frequency-encoded (degree 10),
with the 7 jaw landmarks of lm68 (or the head pose, `cond_mode` 'pose')
frequency-encoded (degree 4), the torso individual code and, head-aware, an
encoding of the head's (rgb, weights sum); a deform MLP moves the coords,
and a canonical MLP on the moved coords' Fourier features gives (alpha,
color). The canonical encoder is Fourier features (`grid_type` 'fourier')
or the reference's 2D tiled grid ('tiledgrid': 16 levels x 2, desired
resolution 2048). Module names are JAX's (`torso_canonicial_net` included), so the weight
bridge maps them one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.models.cond_encoder import MLP, dense, leaky_relu
from genefaceplusplus_tpu_torch.models.grid_modules import GridEncoder
from genefaceplusplus_tpu_torch.ops.fourier_encoder import FourierEncoder
from genefaceplusplus_tpu_torch.ops.freq_encoder import freq_encode, freq_output_dim
from genefaceplusplus_tpu_torch.ops.grid_encoder import GridSpec

# lm68 jaw points used as torso condition (radnerf_torso_sr.py:86)
JAW_LM_INDICES = (5, 6, 7, 8, 9, 10, 11)


@dataclasses.dataclass(frozen=True)
class TorsoConfig:
    torso_shrink: float = 0.8
    grid_size: int = 128
    density_thresh_torso: float = 0.01
    torso_individual_embedding_num: int = 13000
    torso_individual_embedding_dim: int = 8
    torso_head_aware: bool = True
    grid_type: str = "fourier"  # fourier | tiledgrid
    fourier_features: int = 64
    fourier_max_scale: float = 256.0
    cond_mode: str = "lm68"  # 'lm68' (SR variant) | 'pose' (non-SR variant)

    @classmethod
    def from_hparams(cls, hp: Mapping) -> "TorsoConfig":
        """Same keys and defaults as the JAX config's `from_hparams`; `hp` is
        a plain dict."""
        get = hp.get
        return cls(
            torso_shrink=get("torso_shrink", 0.8),
            grid_size=get("grid_size", 128),
            density_thresh_torso=get("density_thresh_torso", 0.01),
            torso_individual_embedding_num=get("individual_embedding_num", 13000),
            torso_individual_embedding_dim=get("torso_individual_embedding_dim", 8),
            torso_head_aware=get("torso_head_aware", False),
            grid_type="fourier" if get("grid_type", "fourier") == "fourier" else "tiledgrid",
            cond_mode="lm68" if get("with_sr", True) else "pose",
        )


class TorsoOutput(NamedTuple):
    alpha: torch.Tensor  # [N, 1]
    color: torch.Tensor  # [N, 3]
    deform: torch.Tensor  # [N, 2]


def sample_occupancy_2d(grid2d: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an [H, H] grid at coords [N, 2] in [-1, 1]
    (align_corners=True). The reference stores the torso grid with xy
    transposed, so coord0 indexes rows of this [H, H] layout."""
    H = grid2d.shape[0]
    xy = (coords + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(xy), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, H - 1)
    f = xy - x0
    x0i, x1i = x0.long(), x1.long()
    flat = grid2d.reshape(-1)

    def at(rx, ry):
        return flat[rx * H + ry]

    v00 = at(x0i[:, 0], x0i[:, 1])
    v01 = at(x0i[:, 0], x1i[:, 1])
    v10 = at(x1i[:, 0], x0i[:, 1])
    v11 = at(x1i[:, 0], x1i[:, 1])
    return (v00 * (1 - f[:, 0]) * (1 - f[:, 1])
            + v01 * (1 - f[:, 0]) * f[:, 1]
            + v10 * f[:, 0] * (1 - f[:, 1])
            + v11 * f[:, 0] * f[:, 1])


class TorsoField(nn.Module):
    """forward(x [N, 2] pixel coords in [-1, 1], cond lm68 [1, 68, 2] or pose
    [1, 6], ind_code [ind_dim], head_rgb [N, 3], head_ws [N, 1]) ->
    TorsoOutput. Initialised on the CPU from `generator`."""

    def __init__(self, cfg: TorsoConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        g = generator
        if c.torso_individual_embedding_dim > 0:
            self.torso_individual_codes = nn.Parameter(0.1 * torch.randn(
                c.torso_individual_embedding_num, c.torso_individual_embedding_dim, generator=g))
        if c.grid_type == "fourier":
            self.torso_embedder = FourierEncoder(2, c.fourier_features, max_scale=c.fourier_max_scale,
                                                 generator=g)
        else:
            self.torso_embedder = GridEncoder(GridSpec.create(
                input_dim=2, num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=16,
                desired_resolution=2048, gridtype="tiled"), generator=g)
        cond_dim = freq_output_dim(2 * len(JAW_LM_INDICES) if c.cond_mode == "lm68" else 6, 4)
        in_dim = freq_output_dim(2, 10) + max(c.torso_individual_embedding_dim, 0) + cond_dim
        if c.torso_head_aware:
            self.head_aware_l1 = dense(4, 16, True, g)
            self.head_aware_l2 = dense(16, 32, True, g)
            self.head_aware_l3 = dense(32, 16, True, g)
            in_dim += 16
        self.torso_deform_net = MLP(in_dim, 2, 64, 3, generator=g)
        self.torso_canonicial_net = MLP(self.torso_embedder.output_dim + in_dim, 4, 32, 3, generator=g)

    def get_individual_code(self, index) -> Optional[torch.Tensor]:
        if self.cfg.torso_individual_embedding_dim <= 0:
            return None
        n = self.torso_individual_codes.shape[0]
        index = min(max(index + n if index < 0 else index, 0), n - 1)  # JAX's gather clamps
        return self.torso_individual_codes[index]

    def forward(self, x: torch.Tensor, cond: torch.Tensor, ind_code: Optional[torch.Tensor] = None,
                head_rgb: Optional[torch.Tensor] = None,
                head_ws: Optional[torch.Tensor] = None) -> TorsoOutput:
        c = self.cfg
        N = x.shape[0]
        x = x * c.torso_shrink
        enc_x = freq_encode(x, degree=10)  # [N, 42]
        if c.cond_mode == "lm68":
            jaw = cond.reshape(1, 68, 2)[:, list(JAW_LM_INDICES), :].reshape(1, -1)  # [1, 14]
            enc_cond = freq_encode(jaw, degree=4)  # [1, 126]
        else:
            enc_cond = freq_encode(cond.reshape(1, -1), degree=4)  # pose [1, 54]
        parts = [enc_x]
        if ind_code is not None:
            parts.append(ind_code.reshape(1, -1).expand(N, ind_code.numel()))
        parts.append(enc_cond.expand(N, enc_cond.shape[-1]))
        if c.torso_head_aware:
            if head_rgb is None:
                head_rgb = x.new_zeros((N, 3))
                head_ws = x.new_zeros((N, 1))
            ha = torch.cat([head_rgb, head_ws], dim=-1)
            ha = leaky_relu(self.head_aware_l1(ha))
            ha = leaky_relu(self.head_aware_l2(ha))
            parts.append(self.head_aware_l3(ha))
        h = torch.cat(parts, dim=-1)
        dx = self.torso_deform_net(h)
        x_deformed = torch.clamp(x + dx, -1.0, 1.0).float()
        feat = self.torso_embedder(x_deformed, bound=1.0)
        h = self.torso_canonicial_net(torch.cat([feat, h], dim=-1))
        return TorsoOutput(alpha=torch.sigmoid(h[..., :1]), color=torch.sigmoid(h[..., 1:]), deform=dx)


def composite_head_torso(head_image, head_weights_sum, torso_alpha, torso_color, bg_color):
    """head over torso over background (radnerf_torso_sr.py:221-226).
    Returns (image clipped to [0, 1], torso over background)."""
    torso_bg = torso_color * torso_alpha + bg_color * (1.0 - torso_alpha)
    image = head_image + (1.0 - head_weights_sum)[..., None] * torso_bg
    return torch.clamp(image, 0.0, 1.0), torso_bg
