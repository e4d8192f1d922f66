"""HuBERT, for feature extraction only: the network of `transformers`'
`HubertModel` (4.57, `models/hubert/modeling_hubert.py`) in plain PyTorch.

    wav [B, S] -> feature encoder: `len(conv_dim)` strided convolutions,
    each then GELU; LayerNorm over the channels after each ("layer",
    hubert-large) or a per-channel GroupNorm after the first ("group",
    hubert-base) -> [B, T, conv_dim[-1]] -> feature projection (LayerNorm
    where `feat_proj_layer_norm`, Linear) -> [B, T, H] -> the encoder:
    the positional convolution (kernel K, groups G, padding K // 2, the
    last frame cut for an even K, GELU) added, then
    - stable LayerNorm (`do_stable_layer_norm`, hubert-large): pre-LN
      layers and a final LayerNorm;
    - post-LN (hubert-base): a LayerNorm after the positional add and
      post-LN layers
    -> last_hidden_state [B, T, H].

No masking, dropout or layer drop. In float32 the convolutions run
through `conv_f32` and the products with TF32 off, whatever the backend
flags say; the module also runs in float64 (a reference). Parameter names
are `HubertModel`'s, with the positional convolution's weight norm folded
into `weight` (`utils/hf_snapshot.py:hubert_state_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.utils.device import Conv1d, matmul_tf32_off

# facebook/hubert-large-ls960-ft's config.json: the keys the network reads
HUBERT_LARGE_LS960_FT = {
    "architectures": ["HubertForCTC"], "model_type": "hubert", "hidden_size": 1024, "num_hidden_layers": 24,
    "num_attention_heads": 16, "intermediate_size": 4096, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
    "feat_extract_norm": "layer", "feat_extract_activation": "gelu", "conv_bias": True,
    "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "num_feat_extract_layers": 7, "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16,
    "do_stable_layer_norm": True, "mask_time_prob": 0.05, "vocab_size": 32,
}
# and its preprocessor_config.json
HUBERT_PREPROCESSOR = {"do_normalize": True, "feature_extractor_type": "Wav2Vec2FeatureExtractor", "feature_size": 1,
                       "padding_side": "right", "padding_value": 0, "return_attention_mask": True,
                       "sampling_rate": 16000}


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The architecture keys of a HuBERT `config.json` (defaults:
    transformers' `HubertConfig`)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    feat_proj_layer_norm: bool = True
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False

    @classmethod
    def from_json(cls, cfg: Mapping) -> "HubertConfig":
        """The config of a `config.json` dict. Raises ValueError naming the
        key where it asks for what the port does not implement."""
        for key, value in (("conv_pos_batch_norm", False), ("hidden_act", "gelu"),
                           ("feat_extract_activation", "gelu"), ("adapter_attn_dim", None)):
            if cfg.get(key, value) != value:
                raise ValueError(f"HuBERT config {key}={cfg[key]!r} is not supported (the port implements "
                                 f"{key}={value!r})")
        if cfg.get("feat_extract_norm", "group") not in ("group", "layer"):
            raise ValueError(f"HuBERT config feat_extract_norm={cfg['feat_extract_norm']!r}: 'group' or 'layer'")
        kw = {f.name: cfg[f.name] for f in dataclasses.fields(cls) if f.name in cfg}
        out = cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})
        n = len(out.conv_dim)
        if len(out.conv_stride) != n or len(out.conv_kernel) != n or cfg.get("num_feat_extract_layers", n) != n:
            raise ValueError("HuBERT config: conv_dim, conv_stride, conv_kernel and num_feat_extract_layers "
                             "disagree on the number of convolutions")
        if out.hidden_size % out.num_attention_heads:
            raise ValueError(f"HuBERT config: hidden_size {out.hidden_size} is not a multiple of "
                             f"num_attention_heads {out.num_attention_heads}")
        return out


class ConvLayer(nn.Module):
    def __init__(self, cfg: HubertConfig, i: int):
        super().__init__()
        c_out = cfg.conv_dim[i]
        self.conv = Conv1d(cfg.conv_dim[i - 1] if i else 1, c_out, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                           bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out)
        elif i == 0:
            self.layer_norm = nn.GroupNorm(c_out, c_out)
        else:
            self.layer_norm = None

    def forward(self, x):
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = self.layer_norm(x.transpose(-2, -1)).transpose(-2, -1)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wav):
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps) if cfg.feat_proj_layer_norm else None
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(x if self.layer_norm is None else self.layer_norm(x))


class PositionalConv(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups)
        self.cut = 1 - k % 2  # SamePad: an even kernel gives one frame too many

    def forward(self, h):
        x = self.conv(h.transpose(1, 2))
        if self.cut:
            x = x[:, :, :-self.cut]
        return F.gelu(x).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.scaling = (h // self.heads) ** -0.5
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(h, h) for _ in range(4))

    def forward(self, x):
        B, T, H = x.shape

        def split(t):
            return t.view(B, T, self.heads, H // self.heads).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        w = torch.softmax(torch.matmul(q, k.transpose(2, 3)) * self.scaling, dim=-1)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(B, T, H))


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h):
        if self.stable:  # pre-LN
            h = h + self.attention(self.layer_norm(h))
            return h + self.feed_forward(self.final_layer_norm(h))
        h = self.layer_norm(h + self.attention(h))
        return self.final_layer_norm(h + self.feed_forward(h))


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.pos_conv_embed = PositionalConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, h):
        h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        for layer in self.layers:
            h = layer(h)
        return self.layer_norm(h) if self.stable else h


class HubertModel(nn.Module):
    """wav [B, S] (normalised as the snapshot's preprocessor says) ->
    last_hidden_state [B, T, hidden_size]."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    @classmethod
    def from_state(cls, cfg: HubertConfig, state: Mapping[str, torch.Tensor]) -> "HubertModel":
        """The model holding `state` (`hubert_state_dict`'s names; every key
        present, no other), in evaluation mode on the state's device."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        return model.eval()

    def forward(self, wav):
        with matmul_tf32_off():
            x = self.feature_extractor(wav).transpose(1, 2)
            return self.encoder(self.feature_projection(x))
