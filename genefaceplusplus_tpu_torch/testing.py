"""Seeded stand-ins for checking the port without downloads: a reference
audio-to-motion checkpoint in the released layout (for the converter) and a
small CPU `GeneFaceInfer` (for the writer and the app). Used by the tests and
by `chip_smoke.py`."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def reference_a2m_state(hp: Mapping, seed: int) -> Dict[str, np.ndarray]:
    """A torch-named a2m state dict in the reference's layout (its
    PitchContourVAEModel: the mel and pitch ConvStacks with BatchNorm
    statistics, the embeddings, cond_proj, the FVAE with weight-normed
    WaveNet stacks and the prior flow) at `hp`'s widths, seeded: weight-norm
    gains and statistics away from their initial values."""
    rng = np.random.RandomState(seed)
    feat, latent, s = 128, 16, {}
    hidden, flow = hp.get("a2m_hidden_channels", 256), hp.get("a2m_flow_hidden", 64)

    def conv(name, out, inp, k, bias=True):
        s[f"{name}.weight"] = (rng.randn(out, inp, k) * 0.05).astype(np.float32)
        if bias:
            s[f"{name}.bias"] = (rng.randn(out) * 0.01).astype(np.float32)

    def wn_stack(prefix, h, n, k):
        for name, out, inp, kk in ([(f"{prefix}.cond_layer", 2 * h * n, feat, 1)]
                                   + [(f"{prefix}.in_layers.{i}", 2 * h, h, k) for i in range(n)]
                                   + [(f"{prefix}.res_skip_layers.{i}", 2 * h if i < n - 1 else h, h, 1)
                                      for i in range(n)]):
            v = (rng.randn(out, inp, kk) * 0.05).astype(np.float32)
            s[f"{name}.weight_v"] = v
            s[f"{name}.weight_g"] = (np.linalg.norm(v.reshape(out, -1), axis=1).reshape(out, 1, 1)
                                     * rng.uniform(0.5, 1.5, (out, 1, 1))).astype(np.float32)
            s[f"{name}.bias"] = (rng.randn(out) * 0.01).astype(np.float32)

    s["blink_embed.weight"] = rng.randn(2, feat).astype(np.float32)
    s["pitch_embed.weight"] = rng.randn(300, feat).astype(np.float32)
    for enc, c_in in (("mel_encoder", hp.get("audio_in_dim", 1024)), ("pitch_encoder", feat)):
        conv(f"{enc}.0", feat, c_in, 3, bias=False)
        conv(f"{enc}.3", feat, feat, 3, bias=False)
        s[f"{enc}.1.weight"] = rng.uniform(0.5, 1.5, feat).astype(np.float32)
        s[f"{enc}.1.bias"] = (rng.randn(feat) * 0.1).astype(np.float32)
        s[f"{enc}.1.running_mean"] = (rng.randn(feat) * 0.1).astype(np.float32)
        s[f"{enc}.1.running_var"] = rng.uniform(0.5, 1.5, feat).astype(np.float32)
    s["mouth_amp_embed"] = rng.randn(feat).astype(np.float32)
    s["cond_proj.weight"] = (rng.randn(feat, 4 * feat) * 0.02).astype(np.float32)
    s["cond_proj.bias"] = (rng.randn(feat) * 0.01).astype(np.float32)
    conv("vae.g_pre_net.0", feat, feat, 8)
    conv("vae.encoder.pre_net.0", hidden, 64, 8)
    wn_stack("vae.encoder.wn", hidden, hp.get("a2m_enc_layers", 8), 5)
    conv("vae.encoder.out_proj", 2 * latent, hidden, 1)
    s["vae.decoder.pre_net.0.weight"] = (rng.randn(latent, hidden, 4) * 0.05).astype(np.float32)
    s["vae.decoder.pre_net.0.bias"] = (rng.randn(hidden) * 0.01).astype(np.float32)
    wn_stack("vae.decoder.wn", hidden, hp.get("a2m_dec_layers", 4), 5)
    conv("vae.decoder.out_proj", 64, hidden, 1)
    for i in range(hp.get("a2m_flow_blocks", 4)):
        conv(f"vae.prior_flow.flows.{2 * i}.pre", flow, latent // 2, 1)
        conv(f"vae.prior_flow.flows.{2 * i}.post", latent // 2, flow, 1)
        wn_stack(f"vae.prior_flow.flows.{2 * i}.enc", flow, 4, 3)
    return s


def save_reference_ckpt(path: str, state: Mapping[str, np.ndarray], global_step: int = 400_000) -> None:
    """Write `state` as the reference's trainer saves a checkpoint: torch's
    legacy serialization of `{epoch, global_step, optimizer_states,
    state_dict: {model: ...}}`."""
    torch.save({"epoch": 320, "global_step": global_step,
                "optimizer_states": [{"state": {0: {"step": global_step, "exp_avg": torch.zeros(4),
                                                    "exp_avg_sq": torch.zeros(4)}},
                                      "param_groups": [{"lr": 5e-4}]}],
                "state_dict": {"model": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}}},
               path, _use_new_zipfile_serialization=False)


def tiny_infer():
    """A CPU `GeneFaceInfer` at 16^2 with a small a2m, from seeded port
    modules over a synthetic dataset of 12 frames."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig

    a2m = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32,
           "a2m_enc_layers": 2, "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
    cfg = RADNeRFConfig.from_hparams({"with_sr": False, "grid_size": 16, "smo_win_size": 3, "cond_win_size": 1,
                                      "individual_embedding_num": 16, "add_eye_blink_cond": True})
    g = torch.Generator().manual_seed(0)
    ds = RADNeRFDataset(synthetic(num_frames=12, H=16, W=16), smo_win_size=3, with_sr=False)
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, 16)] * 3), indexing="ij")
    occupancy = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16
    return GeneFaceInfer(cfg, RADNeRF(cfg, generator=g).state_dict(), ds, occupancy, device="cpu",
                         a2m_hparams=a2m, a2m_params=a2m_model_from_hparams(a2m, generator=g).state_dict())
