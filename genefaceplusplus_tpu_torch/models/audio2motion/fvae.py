"""Flow-prior VAE over motion sequences (port of
`genefaceplusplus_tpu/models/audio2motion/fvae.py`).

Encoder: strided conv (kernel 2s, stride s, padding s // 2) -> WaveNet ->
1x1 -> (m, logs), z = m + eps * exp(logs). Decoder: transposed conv
(kernel s, stride s) -> WaveNet -> 1x1. Prior: the mean-only coupling
flow; training's KL is E[log q(z) - log N(z_p)] over the mask and the
latent width; inference draws z_p ~ N(0, 1) * temperature, inverts the
flow and decodes. Also the `sqz_prior` style pooling and the 71-channel
exp + pose decoders. Feature-last [B, T, C].

Randomness: JAX draws eps and z_p from a PRNG key. Here each draw is an
explicit tensor (`noise`, unit normal of the drawn shape) or comes from a
`torch.Generator`; passing JAX's own draw gives JAX's result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.models.audio2motion.flow import ResidualCouplingBlock
from genefaceplusplus_tpu_torch.models.audio2motion.wavenet import (
    WN, Conv1d, ConvTranspose1d, channels_first)
from genefaceplusplus_tpu_torch.models.cond_encoder import dense

_LOG_2PI = math.log(2.0 * math.pi)


def normal_logprob(x, mean, logs):
    return -0.5 * (_LOG_2PI + 2.0 * logs + ((x - mean) * torch.exp(-logs)) ** 2)


def unit_normal(shape, device, noise: Optional[torch.Tensor], generator: Optional[torch.Generator]):
    """`noise` (checked against `shape`) on `device`, else a draw from
    `generator`."""
    if noise is not None:
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, dtype=np.float32))
        noise = noise.to(device=device, dtype=torch.float32)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)}; this draw is {tuple(shape)}")
        return noise
    if generator is None:
        raise ValueError("a random draw needs `noise` or a torch.Generator")
    return torch.randn(shape, generator=generator, device=device)


class FVAEEncoder(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, latent_channels: int, kernel_size: int,
                 n_layers: int, gin_channels: int = 0, strides: Sequence[int] = (4,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides, self.latent_channels = tuple(strides), latent_channels
        ins = (in_channels,) + (hidden_channels,) * (len(self.strides) - 1)
        # flax's Conv_0.. (strided) and Conv_<len(strides)> (the stats)
        self.convs = nn.ModuleList(
            [Conv1d(c, hidden_channels, 2 * s, stride=s, padding=s // 2, generator=generator)
             for c, s in zip(ins, self.strides)]
            + [Conv1d(hidden_channels, 2 * latent_channels, 1, generator=generator)])
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels, generator=generator)

    def forward(self, x, x_mask, g, noise=None, generator=None):
        """x [B, T, C_in], x_mask [B, T, 1], g [B, T_sqz, gin] ->
        (z, m, logs, mask_sqz)."""
        h = channels_first(x)
        for conv in self.convs[:-1]:
            h = conv(h)
        h = channels_first(h)
        stride_total = int(np.prod(self.strides))
        mask_sqz = x_mask[:, ::stride_total][:, :h.shape[1]]
        h = h * mask_sqz
        h = self.wn(h, mask_sqz, g) * mask_sqz
        stats = channels_first(self.convs[-1](channels_first(h)))
        m, logs = stats[..., :self.latent_channels], stats[..., self.latent_channels:]
        z = m + unit_normal(m.shape, m.device, noise, generator) * torch.exp(logs)
        return z, m, logs, mask_sqz


class FVAEDecoder(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, kernel_size: int,
                 n_layers: int, gin_channels: int = 0, strides: Sequence[int] = (4,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ins = (in_channels,) + (hidden_channels,) * (len(strides) - 1)
        # flax's ConvTranspose_0.. and Conv_0 (the output projection)
        self.deconvs = nn.ModuleList([ConvTranspose1d(c, hidden_channels, s, generator=generator)
                                      for c, s in zip(ins, strides)])
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels, generator=generator)
        self.convs = nn.ModuleList([Conv1d(hidden_channels, out_channels, 1, generator=generator)])

    def forward(self, z, x_mask, g):
        """z [B, T_sqz, C]; x_mask [B, T, 1], or None for all ones; g
        [B, T, gin]."""
        h = channels_first(z)
        for deconv in self.deconvs:
            h = deconv(h)
        h = channels_first(h)
        T = h.shape[1]
        if x_mask is not None:
            # the encoder's strided conv may round T / stride up: fit the
            # mask to the decoded length
            mask = x_mask[:, :T]
            mask = F.pad(mask, (0, 0, 0, T - mask.shape[1]))
            h = h * mask
        else:
            mask = torch.ones_like(h[..., :1])
        g_fit = g[:, :T]
        g_fit = F.pad(g_fit, (0, 0, 0, T - g_fit.shape[1]))
        h = self.wn(h, mask, g_fit) * mask
        return channels_first(self.convs[0](channels_first(h)))


class FVAE(nn.Module):
    def __init__(self, in_out_channels: int = 64, hidden_channels: int = 256, latent_size: int = 16,
                 kernel_size: int = 3, enc_n_layers: int = 5, dec_n_layers: int = 5,
                 gin_channels: int = 80, strides: Sequence[int] = (4,), use_prior_flow: bool = True,
                 flow_hidden: int = 256, flow_kernel_size: int = 3, flow_n_blocks: int = 4,
                 sqz_prior: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        s = strides[0]
        self.in_out_channels, self.latent_size = in_out_channels, latent_size
        self.use_prior_flow, self.sqz_prior = use_prior_flow, sqz_prior
        self.g_pre_net = Conv1d(gin_channels, gin_channels, 2 * s, stride=s, padding=s // 2, generator=g)
        self.encoder = FVAEEncoder(in_out_channels, hidden_channels, latent_size, kernel_size,
                                   enc_n_layers, gin_channels, strides, generator=g)
        if use_prior_flow:
            self.prior_flow = ResidualCouplingBlock(latent_size, flow_hidden, flow_kernel_size, 1,
                                                    flow_n_blocks, n_flows=4, gin_channels=gin_channels,
                                                    generator=g)
        dec_in = hidden_channels if sqz_prior else latent_size
        if sqz_prior:
            self.query_proj = dense(latent_size, latent_size, True, g)
            self.key_proj = dense(latent_size, latent_size, True, g)
            self.value_proj = dense(latent_size, hidden_channels, True, g)
        if in_out_channels == 71:
            self.exp_decoder = FVAEDecoder(dec_in, hidden_channels, 64, kernel_size, dec_n_layers,
                                           gin_channels, strides, generator=g)
            self.pose_decoder = FVAEDecoder(dec_in, hidden_channels, 7, kernel_size, dec_n_layers,
                                            gin_channels, strides, generator=g)
        else:
            self.decoder = FVAEDecoder(dec_in, hidden_channels, in_out_channels, kernel_size,
                                       dec_n_layers, gin_channels, strides, generator=g)

    def latent_length(self, T: int) -> int:
        """The latent sequence's length for T motion frames (`g_pre_net`'s
        output length): the time axis of an inference `noise`."""
        s = self.g_pre_net.stride[0]
        return (T + 2 * (s // 2) - 2 * s) // s + 1

    def _style_pool(self, z):
        """sqz_prior: one style vector attended from the latent sequence,
        broadcast over time."""
        q = self.query_proj(z.mean(dim=1, keepdim=True))  # [B, 1, L]
        k = self.key_proj(z)  # [B, T, L]
        v = self.value_proj(z)  # [B, T, H]
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)  # [B, 1, T]
        return (attn @ v).expand(z.shape[0], z.shape[1], v.shape[-1])

    def _decode(self, z, x_mask, g, out_len: int):
        if self.in_out_channels == 71:
            out = torch.cat([self.exp_decoder(z, x_mask, g), self.pose_decoder(z, x_mask, g)], dim=-1)
        else:
            out = self.decoder(z, x_mask, g)
        out = out[:, :out_len]  # fit the decoded length to the sequence's
        return F.pad(out, (0, 0, 0, out_len - out.shape[1]))

    def forward(self, x, x_mask, g, infer: bool = False, temperature: float = 1.0,
                noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """x [B, T, C_io] (None at inference); x_mask [B, T]; g [B, T, C_g].
        Training: `noise` is the encoder's eps [B, T_sqz, latent] ->
        (x_recon, loss_kl, z_p, m_q, logs_q). Inference: `noise` is the
        unit-normal z_p draw [B, T_sqz, latent] -> (x_recon, z_p)."""
        x_mask3 = x_mask[..., None]
        g_sqz = channels_first(self.g_pre_net(channels_first(g)))

        if not infer:
            z_q, m_q, logs_q, mask_sqz = self.encoder(x, x_mask3, g_sqz, noise, generator)
            dec_in = self._style_pool(z_q) if self.sqz_prior else z_q
            x_recon = self._decode(dec_in, x_mask3, g, out_len=x_mask.shape[1])
            logqx = normal_logprob(z_q, m_q, logs_q)
            if self.use_prior_flow:
                z_p = self.prior_flow(z_q, mask_sqz, g=g_sqz, reverse=False)
                logpx = normal_logprob(z_p, 0.0, torch.zeros_like(z_p))
                loss_kl = ((logqx - logpx) * mask_sqz).sum() / mask_sqz.sum() / self.latent_size
            else:
                # analytic KL(N(m, s) || N(0, 1)), summed as the reference does
                kl = 0.5 * (torch.exp(2 * logs_q) + m_q ** 2 - 1.0) - logs_q
                loss_kl = (kl * mask_sqz).sum() / mask_sqz.sum() / self.latent_size
                z_p = z_q
            return x_recon, loss_kl, z_p, m_q, logs_q

        shape = (g.shape[0], g_sqz.shape[1], self.latent_size)
        if temperature == 0.0 and noise is None:  # the deterministic mode: no draw
            z_p = g.new_zeros(shape)
        else:
            z_p = unit_normal(shape, g.device, noise, generator) * temperature
        if self.use_prior_flow:
            z_p = self.prior_flow(z_p, None, g=g_sqz, reverse=True)
        dec_in = self._style_pool(z_p) if self.sqz_prior else z_p
        x_recon = self._decode(dec_in, None, g, out_len=x_mask.shape[1])
        return x_recon, z_p
