"""RAD-NeRF head model (port of `genefaceplusplus_tpu/models/radnerf.py`).

cond_prenet (AudioNet) -> optional blink embedding + encoder added to the
first `eye_blink_dim` channels -> cond_att_net (AudioAttNet) over the smo
window; field: position features -> ambient MLP -> tanh -> ambient
features -> sigma MLP -> exp, geo -> SH(dir) + geo + ind code -> color MLP
-> sigmoid. The position and ambient encoders are Fourier features
(`grid_type` 'fourier', the fused field's) or, as the reference trains
its heads, tiled or hash grids ('tiledgrid', 'hashgrid': 16 levels x 2,
`models/grid_modules.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.models.cond_encoder import MLP, AudioAttNet, AudioNet, dense
from genefaceplusplus_tpu_torch.models.grid_modules import GridEncoder
from genefaceplusplus_tpu_torch.ops.fastmath import fast_tanh
from genefaceplusplus_tpu_torch.ops.fourier_encoder import FourierEncoder
from genefaceplusplus_tpu_torch.ops.grid_encoder import GridSpec
from genefaceplusplus_tpu_torch.ops.sh_encoder import sh_encode
from genefaceplusplus_tpu_torch.ops.trunc_exp import trunc_exp


@dataclasses.dataclass(frozen=True)
class RADNeRFConfig:
    # condition
    cond_type: str = "idexp_lm3d_normalized"
    keypoint_mode: str = "lm68"
    cond_out_dim: int = 64
    cond_win_size: int = 1
    smo_win_size: int = 3
    with_att: bool = True
    add_eye_blink_cond: bool = True
    eye_blink_dim: int = 2
    # scene
    bound: float = 1.0
    grid_size: int = 128
    min_near: float = 0.05
    density_thresh: float = 10.0
    # spatial encoder: 'fourier', 'tiledgrid' or 'hashgrid'
    grid_type: str = "fourier"
    grid_interpolation_type: str = "linear"
    log2_hashmap_size: int = 16
    desired_resolution: int = 2048
    fourier_pos_features: int = 128
    fourier_pos_max_scale: float = 128.0
    fourier_amb_features: int = 64
    fourier_amb_max_scale: float = 64.0
    # field MLPs
    num_layers_ambient: int = 3
    hidden_dim_ambient: int = 128
    ambient_coord_dim: int = 3
    num_layers_sigma: int = 3
    hidden_dim_sigma: int = 128
    geo_feat_dim: int = 128
    num_layers_color: int = 2
    hidden_dim_color: int = 128
    # per-frame individual codes
    individual_embedding_num: int = 13000
    individual_embedding_dim: int = 4
    # 'float32' or 'bfloat16' field MLP activations
    field_act_dtype: str = "float32"

    @property
    def cond_in_dim(self) -> int:
        if self.cond_type in ("esperanto",):
            return 44
        if self.cond_type in ("deepspeech",):
            return 29
        n = {"lm68": 68, "lm131": 131, "lm468": 468}[self.keypoint_mode]
        return n * 3

    @classmethod
    def from_hparams(cls, hp: Mapping) -> "RADNeRFConfig":
        """Same keys and defaults as the JAX config's `from_hparams`; `hp` is
        a mapping (a dict, or a `config.Config` from `set_hparams`)."""
        get = hp.get
        return cls(
            cond_type=get("cond_type", "idexp_lm3d_normalized"),
            keypoint_mode=get("nerf_keypoint_mode", "lm68"),
            cond_out_dim=get("cond_out_dim", 64) // 2 * 2,
            cond_win_size=get("cond_win_size", 1),
            smo_win_size=get("smo_win_size", 3),
            with_att=get("with_att", True),
            add_eye_blink_cond=get("add_eye_blink_cond", False),
            eye_blink_dim=get("eye_blink_dim", 2),
            bound=get("bound", 1),
            grid_size=get("grid_size", 128),
            min_near=get("min_near", 0.05),
            density_thresh=get("density_thresh", 10.0),
            grid_type=get("grid_type", "fourier"),
            grid_interpolation_type=get("grid_interpolation_type", "linear"),
            log2_hashmap_size=get("log2_hashmap_size", 16),
            desired_resolution=get("desired_resolution", 2048),
            fourier_pos_features=get("fourier_pos_features", 128),
            fourier_pos_max_scale=get("fourier_pos_max_scale", 128.0),
            fourier_amb_features=get("fourier_amb_features", 64),
            fourier_amb_max_scale=get("fourier_amb_max_scale", 64.0),
            num_layers_ambient=get("num_layers_ambient", 3),
            hidden_dim_ambient=get("hidden_dim_ambient", 128),
            ambient_coord_dim=get("ambient_coord_dim", 3),
            num_layers_sigma=get("num_layers_sigma", 3),
            hidden_dim_sigma=get("hidden_dim_sigma", 128),
            geo_feat_dim=get("geo_feat_dim", 128),
            num_layers_color=get("num_layers_color", 2),
            hidden_dim_color=get("hidden_dim_color", 128),
            individual_embedding_num=get("individual_embedding_num", 13000),
            individual_embedding_dim=get("individual_embedding_dim", 4),
            field_act_dtype=get("field_act_dtype", "float32"),
        )

    def _grid_spec(self, input_dim: int, desired_resolution: float) -> GridSpec:
        return GridSpec.create(input_dim=input_dim, num_levels=16, level_dim=2, base_resolution=16,
                               desired_resolution=desired_resolution, log2_hashmap_size=self.log2_hashmap_size,
                               gridtype="hash" if self.grid_type == "hashgrid" else "tiled",
                               interpolation=self.grid_interpolation_type)

    def position_grid_spec(self) -> GridSpec:
        return self._grid_spec(3, self.desired_resolution * self.bound)

    def ambient_grid_spec(self) -> GridSpec:
        return self._grid_spec(self.ambient_coord_dim, self.desired_resolution)


# egs/datasets/May/lm3d_radnerf.yaml resolved through its base configs,
# restricted to the keys the head stage reads: the non-SR 512^2 head model
# (tests/test_torch_pipeline.py holds it to the YAML).
MAY_LM3D_RADNERF = {
    "cond_type": "idexp_lm3d_normalized",
    "nerf_keypoint_mode": "lm68",
    "cond_out_dim": 64,
    "cond_win_size": 1,
    "smo_win_size": 5,
    "with_att": True,
    "add_eye_blink_cond": True,
    "eye_blink_dim": 2,
    "bound": 1,
    "grid_size": 128,
    "min_near": 0.05,
    "density_thresh": 10,
    "grid_type": "fourier",
    "grid_interpolation_type": "linear",
    "log2_hashmap_size": 16,
    "desired_resolution": 2048,
    "fourier_pos_features": 128,
    "fourier_pos_max_scale": 128.0,
    "fourier_amb_features": 64,
    "fourier_amb_max_scale": 64.0,
    "num_layers_ambient": 3,
    "hidden_dim_ambient": 128,
    "ambient_coord_dim": 3,
    "num_layers_sigma": 3,
    "hidden_dim_sigma": 128,
    "geo_feat_dim": 128,
    "num_layers_color": 2,
    "hidden_dim_color": 128,
    "individual_embedding_num": 13000,
    "individual_embedding_dim": 4,
    "field_act_dtype": "float32",
}

# egs/datasets/May/lm3d_radnerf_sr.yaml resolved the same way: the SR head
# stage (256^2 raw render, 2x SR to 512^2), its SR keys included.
MAY_LM3D_RADNERF_SR = dict(MAY_LM3D_RADNERF, smo_win_size=3, with_sr=True, sr_dtype="bfloat16")

# egs/datasets/May/lm3d_radnerf_torso_sr.yaml resolved the same way,
# restricted to the keys `TorsoConfig.from_hparams` reads. Its head is the
# lm3d_radnerf_sr stage named by `head_model_dir`.
MAY_LM3D_RADNERF_TORSO_SR = {
    "torso_shrink": 0.8,
    "grid_size": 128,
    "density_thresh_torso": 0.01,
    "individual_embedding_num": 13000,
    "torso_individual_embedding_dim": 8,
    "torso_head_aware": True,
    "grid_type": "fourier",
    "with_sr": True,
}


class RADNeRF(nn.Module):
    """Head field. Methods mirror the flax module:
    - cal_cond_feat(cond, eye_area_percent) -> [1, cond_out_dim]
    - field(xyz, dirs, cond_feat, ind_code) -> (sigma, rgb, ambient_pos)
    - density(xyz, cond_feat) -> sigma

    Parameters are initialised on the CPU from `generator` (flax's
    distributions, not its bits); move the module with `.to(device)`."""

    def __init__(self, cfg: RADNeRFConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        g = generator
        self.cond_prenet = AudioNet(c.cond_in_dim, c.cond_out_dim, win_size=c.cond_win_size, generator=g)
        if c.add_eye_blink_cond:
            half = c.cond_out_dim // 2
            # flax nn.Embed default init: N(0, 1/dim)
            self.blink_embedding = nn.Embedding(1, half)
            with torch.no_grad():
                self.blink_embedding.weight.normal_(0.0, half ** -0.5, generator=g)
            self.blink_encoder = nn.ModuleList(
                [dense(half, half, True, g), dense(half, c.eye_blink_dim, True, g)])
        if c.with_att:
            self.cond_att_net = AudioAttNet(c.cond_out_dim, seq_len=c.smo_win_size, generator=g)
        if c.grid_type == "fourier":
            self.position_embedder = FourierEncoder(
                3, c.fourier_pos_features, max_scale=c.fourier_pos_max_scale, generator=g)
            self.ambient_embedder = FourierEncoder(
                c.ambient_coord_dim, c.fourier_amb_features, max_scale=c.fourier_amb_max_scale, generator=g)
        else:  # any other grid_type is a grid, 'hashgrid' a hashed one, as in JAX
            self.position_embedder = GridEncoder(c.position_grid_spec(), generator=g)
            self.ambient_embedder = GridEncoder(c.ambient_grid_spec(), generator=g)
        dt = torch.bfloat16 if c.field_act_dtype == "bfloat16" else None
        pos_dim = self.position_embedder.output_dim
        amb_dim = self.ambient_embedder.output_dim
        self.ambient_net = MLP(pos_dim + c.cond_out_dim, c.ambient_coord_dim,
                               c.hidden_dim_ambient, c.num_layers_ambient, dtype=dt, generator=g)
        self.sigma_net = MLP(pos_dim + amb_dim, 1 + c.geo_feat_dim,
                             c.hidden_dim_sigma, c.num_layers_sigma, dtype=dt, generator=g)
        self.color_net = MLP(16 + c.geo_feat_dim + c.individual_embedding_dim, 3,
                             c.hidden_dim_color, c.num_layers_color, dtype=dt, generator=g)
        if c.individual_embedding_dim > 0:
            self.individual_embeddings = nn.Parameter(
                0.1 * torch.randn(c.individual_embedding_num, c.individual_embedding_dim, generator=g))

    def cal_cond_feat(self, cond: torch.Tensor, eye_area_percent: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cond: [smo_win, T_win, C_in] -> [1, cond_out_dim] smoothed feature."""
        c = self.cfg
        feat = self.cond_prenet(cond)  # [smo_win, cond_out_dim]
        if c.add_eye_blink_cond:
            if eye_area_percent is None:
                eye_area_percent = torch.zeros((1, 1), dtype=feat.dtype, device=feat.device)
            blink = self.blink_embedding.weight[0:1] * eye_area_percent.reshape(1, 1)
            for layer in self.blink_encoder:
                blink = layer(blink)
            feat = torch.cat([feat[..., : c.eye_blink_dim] + blink, feat[..., c.eye_blink_dim:]], dim=-1)
        if c.with_att:
            feat = self.cond_att_net(feat).reshape(1, -1)
        return feat

    def _act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.field_act_dtype == "bfloat16" else torch.float32

    def field_sigma(self, position: torch.Tensor, cond_feat: torch.Tensor):
        """Geometry stage: (sigma [N], geo_feat [N, G], ambient_pos [N, D])."""
        c = self.cfg
        N = position.shape[0]
        dt = self._act_dtype()
        pos_feat = self.position_embedder(position, bound=c.bound).to(dt)
        cond_tiled = cond_feat.to(dt).expand(N, cond_feat.shape[-1])
        ambient_logit = self.ambient_net(torch.cat([pos_feat, cond_tiled], dim=-1)).float()
        ambient_pos = fast_tanh(ambient_logit)
        ambient_feat = self.ambient_embedder(ambient_pos, bound=1.0).to(dt)
        h = self.sigma_net(torch.cat([pos_feat, ambient_feat], dim=-1)).float()
        sigma = trunc_exp(h[..., 0])
        return sigma, h[..., 1:], ambient_pos

    def field_color(self, geo_feat: torch.Tensor, direction: torch.Tensor,
                    ind_code: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Appearance stage: view-dependent color [N, 3]."""
        N = geo_feat.shape[0]
        parts = [sh_encode(direction, degree=4).to(geo_feat.dtype), geo_feat]
        if ind_code is not None:
            parts.append(ind_code.reshape(1, -1).to(geo_feat.dtype).expand(N, ind_code.numel()))
        color_logit = self.color_net(torch.cat(parts, dim=-1))
        return torch.sigmoid(color_logit.float())

    def field(self, position, direction, cond_feat, ind_code=None):
        sigma, geo_feat, ambient_pos = self.field_sigma(position, cond_feat)
        return sigma, self.field_color(geo_feat, direction, ind_code), ambient_pos

    def density(self, position: torch.Tensor, cond_feat: torch.Tensor) -> torch.Tensor:
        """sigma only (grid maintenance path), float32 encoders."""
        c = self.cfg
        N = position.shape[0]
        pos_feat = self.position_embedder(position, bound=c.bound)
        cond_tiled = cond_feat.expand(N, cond_feat.shape[-1])
        ambient_pos = fast_tanh(self.ambient_net(torch.cat([pos_feat, cond_tiled], dim=-1)).float())
        ambient_feat = self.ambient_embedder(ambient_pos, bound=1.0)
        h = self.sigma_net(torch.cat([pos_feat.to(ambient_feat.dtype), ambient_feat], dim=-1))
        return trunc_exp(h[..., 0].float())

    def get_individual_code(self, index) -> Optional[torch.Tensor]:
        if self.cfg.individual_embedding_dim <= 0:
            return None
        # JAX's gather semantics: a negative index wraps once, then the index
        # clamps to [0, n - 1]
        n = self.individual_embeddings.shape[0]
        if isinstance(index, torch.Tensor):
            index = torch.where(index < 0, index + n, index).clamp(0, n - 1)
        else:
            index = min(max(index + n if index < 0 else index, 0), n - 1)
        return self.individual_embeddings[index]
