"""Audio -> motion models: HuBERT (+ pitch) conditioned flow-prior VAEs
(port of `genefaceplusplus_tpu/models/audio2motion/vae_model.py`).

- mel encoder: conv (k3, no bias) -> BatchNorm -> exact GELU -> conv (k3,
  no bias), `ConvStack`;
- pitch (pitch model only): f0 -> 2x nearest downsample -> `f0_to_coarse`
  -> embedding (300) -> conv stack;
- blink: embedding (2) per frame, downsampled;
- optional mouth / eye amplitude embeddings scaled by per-clip scalars;
- `cond_proj` linear -> FVAE (latent 16, kernel 5, stride 4).
Audio at 50 Hz becomes motion at 25 Hz by a 2x temporal downsample:
pairwise mean for `VAEModel`, every second frame for the pitch model.

I/O is JAX's batch dict: 'audio' [B, 2T, C_aud], 'f0' [B, 2T], 'y_mask'
[B, T], optional 'blink' [B, 2T, 1], 'mouth_amp' / 'eye_amp' [B, 1], 'y'
[B, T, C_io] (training). BatchNorm uses its running statistics unless
`train=True`; training updates them with torch's rule (unbiased running
variance), which the serving path never runs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.models.audio2motion.fvae import FVAE
from genefaceplusplus_tpu_torch.models.audio2motion.wavenet import Conv1d, channels_first
from genefaceplusplus_tpu_torch.models.cond_encoder import dense
from genefaceplusplus_tpu_torch.utils.pitch import f0_to_coarse


def downsample2x_linear(x: torch.Tensor) -> torch.Tensor:
    """[B, 2T, C] -> [B, T, C] pairwise mean (F.interpolate linear, sf 0.5)."""
    B, T2, C = x.shape
    return x.reshape(B, T2 // 2, 2, C).mean(dim=2)


def downsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, 2T, C] -> [B, T, C] every second frame (F.interpolate nearest)."""
    return x[:, ::2]


def embedding(num: int, features: int, generator: Optional[torch.Generator]) -> nn.Embedding:
    """flax `Embed`'s default init: N(0, 1 / features)."""
    layer = nn.Embedding(num, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, features ** -0.5, generator=generator)
    return layer


class ConvStack(nn.Module):
    """Conv (k3, no bias) -> BatchNorm -> GELU -> conv (k3, no bias); flax's
    `Conv_0`, `BatchNorm_0`, `Conv_1`."""

    def __init__(self, c_in: int, feat_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([Conv1d(c, feat_dim, 3, padding=1, bias=False, generator=generator)
                                    for c in (c_in, feat_dim)])
        self.norms = nn.ModuleList([nn.BatchNorm1d(feat_dim, eps=1e-5, momentum=0.1)])  # flax momentum 0.9

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, C_in] -> [B, T, feat_dim]."""
        bn = self.norms[0]
        h = self.convs[0](channels_first(x))
        h = F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight, bn.bias, training=train,
                         momentum=bn.momentum, eps=bn.eps)
        h = F.gelu(h, approximate="none")
        return channels_first(self.convs[1](h))


def _fvae(in_out_dim, hidden_channels, enc_n_layers, dec_n_layers, gin_channels, use_prior_flow,
          flow_hidden, flow_n_blocks, sqz_prior, generator):
    return FVAE(in_out_channels=in_out_dim, hidden_channels=hidden_channels, latent_size=16,
                kernel_size=5, enc_n_layers=enc_n_layers, dec_n_layers=dec_n_layers,
                gin_channels=gin_channels, strides=(4,), use_prior_flow=use_prior_flow,
                flow_hidden=flow_hidden, flow_kernel_size=3, flow_n_blocks=flow_n_blocks,
                sqz_prior=sqz_prior, generator=generator)


def _run_vae(vae: FVAE, batch: Mapping[str, Any], cond_feat, train: bool, temperature: float,
             noise, generator):
    mask = batch["y_mask"]
    if not train:
        x_recon, z_p = vae(None, mask, cond_feat, infer=True, temperature=temperature, noise=noise,
                           generator=generator)
        return x_recon * mask[..., None], {"z_p": z_p}
    x_recon, loss_kl, z_p, m_q, logs_q = vae(batch["y"], mask, cond_feat, infer=False, noise=noise,
                                             generator=generator)
    return x_recon * mask[..., None], {"loss_kl": loss_kl, "z_p": z_p, "m_q": m_q, "logs_q": logs_q}


class VAEModel(nn.Module):
    """Landmark VAE conditioned on HuBERT only."""

    def __init__(self, in_out_dim: int = 64, audio_in_dim: int = 1024, sqz_prior: bool = False,
                 use_prior_flow: bool = True, hidden_channels: int = 256, enc_n_layers: int = 8,
                 dec_n_layers: int = 4, flow_hidden: int = 64, flow_n_blocks: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        feat_dim = 64
        self.in_out_dim = in_out_dim
        self.mel_encoder = ConvStack(audio_in_dim, feat_dim, generator)
        self.vae = _fvae(in_out_dim, hidden_channels, enc_n_layers, dec_n_layers, feat_dim,
                         use_prior_flow, flow_hidden, flow_n_blocks, sqz_prior, generator)

    def forward(self, batch: Mapping[str, Any], train: bool = True, temperature: float = 1.0,
                noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        cond_feat = self.mel_encoder(downsample2x_linear(batch["audio"]), train=train)
        return _run_vae(self.vae, batch, cond_feat, train, temperature, noise, generator)


class PitchContourVAEModel(nn.Module):
    """HuBERT + pitch contour + blink conditioned VAE."""

    def __init__(self, in_out_dim: int = 64, audio_in_dim: int = 1024, sqz_prior: bool = False,
                 use_prior_flow: bool = True, use_mouth_amp_embed: bool = True,
                 use_eye_amp_embed: bool = False, feat_dim: int = 128, hidden_channels: int = 256,
                 enc_n_layers: int = 8, dec_n_layers: int = 4, flow_hidden: int = 64,
                 flow_n_blocks: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, fd = generator, feat_dim
        self.in_out_dim, self.feat_dim = in_out_dim, fd
        self.blink_embed = embedding(2, fd, g)
        self.mel_encoder = ConvStack(audio_in_dim, fd, g)
        self.pitch_embed = embedding(300, fd, g)
        self.pitch_encoder = ConvStack(fd, fd, g)
        self.mouth_amp_embed = self.eye_amp_embed = None
        if use_mouth_amp_embed:
            self.mouth_amp_embed = nn.Parameter(torch.randn(fd, generator=g))
        if use_eye_amp_embed:
            self.eye_amp_embed = nn.Parameter(torch.randn(fd, generator=g))
        n_feats = 3 + use_mouth_amp_embed + use_eye_amp_embed
        self.cond_proj = dense(n_feats * fd, fd, True, g)
        self.vae = _fvae(in_out_dim, hidden_channels, enc_n_layers, dec_n_layers, fd, use_prior_flow,
                         flow_hidden, flow_n_blocks, sqz_prior, g)

    def forward(self, batch: Mapping[str, Any], train: bool = True, temperature: float = 1.0,
                noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        mel, f0 = batch["audio"], batch["f0"]  # [B, 2T, C], [B, 2T]
        B = f0.shape[0]
        blink = batch.get("blink")
        if blink is None:
            blink = torch.zeros((B, f0.shape[1], 1), dtype=torch.long, device=f0.device)
        blink_feat = downsample2x_nearest(self.blink_embed(blink[..., 0].long()))
        mel = downsample2x_nearest(mel)
        f0 = downsample2x_nearest(f0[..., None])[..., 0]
        pitch_emb = self.pitch_embed(f0_to_coarse(f0))

        cond_feats = [self.mel_encoder(mel, train=train), self.pitch_encoder(pitch_emb, train=train),
                      blink_feat]
        T = cond_feats[0].shape[1]
        for key, embed in (("mouth_amp", self.mouth_amp_embed), ("eye_amp", self.eye_amp_embed)):
            if embed is not None:
                amp = batch.get(key)
                if amp is None:
                    amp = torch.full((B, 1), 0.4, device=f0.device)
                cond_feats.append((amp[:, :, None] * embed[None, None, :]).expand(B, T, self.feat_dim))
        cond_feat = self.cond_proj(torch.cat(cond_feats, dim=-1))
        return _run_vae(self.vae, batch, cond_feat, train, temperature, noise, generator)


# egs/datasets/May/audio2motion_vae.yaml resolved through its base configs,
# restricted to the keys `a2m_model_from_hparams` reads (the a2m_* widths
# are absent there: JAX's defaults, 11,840,768 variables with batch_stats)
MAY_AUDIO2MOTION_VAE = {"use_pitch": True, "audio_in_dim": 1024}


def a2m_model_from_hparams(hp: Mapping[str, Any], generator: Optional[torch.Generator] = None) -> nn.Module:
    """The a2m model `GeneFaceInfer` builds from an audio2motion config (the
    keys and defaults JAX reads at `inference/pipeline.py:110-132`)."""
    in_out_dim = {"id_exp": 144, "idexp_lm3d": 204}.get(hp.get("motion_type", "exp"), 64)
    kw = dict(in_out_dim=in_out_dim, audio_in_dim=hp.get("audio_in_dim", 1024),
              hidden_channels=hp.get("a2m_hidden_channels", 256), enc_n_layers=hp.get("a2m_enc_layers", 8),
              dec_n_layers=hp.get("a2m_dec_layers", 4), flow_hidden=hp.get("a2m_flow_hidden", 64),
              flow_n_blocks=hp.get("a2m_flow_blocks", 4), generator=generator)
    if hp.get("use_pitch", True):
        return PitchContourVAEModel(use_mouth_amp_embed=hp.get("use_mouth_amp_embed", True), **kw)
    return VAEModel(**kw)


def a2m_batch(hubert, f0, mouth_amp: float, device) -> Dict[str, torch.Tensor]:
    """One request's a2m input (batch of 1): features [2T, C] at 50 Hz and
    f0 [2T] -> the model's batch dict at `device`."""
    hubert = torch.as_tensor(hubert, dtype=torch.float32).to(device)[None]
    f0 = torch.as_tensor(f0, dtype=torch.float32).to(device)[None]
    T = hubert.shape[1] // 2
    return {"audio": hubert, "f0": f0, "y_mask": torch.ones((1, T), device=device),
            "mouth_amp": torch.full((1, 1), float(mouth_amp), device=device)}
