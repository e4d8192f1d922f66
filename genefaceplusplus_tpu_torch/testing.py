"""Seeded stand-ins for checking the port without downloads: the
reference's audio-to-motion, grid-head and discriminator checkpoints in
their released layout (for the converter), a HuBERT snapshot in the
released facebook/hubert-large-ls960-ft layout (for the weight reader), a
small CPU `GeneFaceInfer` (for the writer and the app) and a synthetic
audio-mouth clip (for the sync scorer). Used by the tests and by
`chip_smoke.py`."""

from __future__ import annotations

import json
import os
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


# the reference's module names of the port's condition encoders and MLPs
_REFERENCE_NAMES = (("cond_prenet.convs.", lambda i: f"cond_prenet.encoder_conv.{2 * i}"),
                    ("cond_prenet.dense.", lambda i: f"cond_prenet.encoder_fc1.{2 * i}"),
                    ("cond_att_net.convs.", lambda i: f"cond_att_net.attentionConvNet.{2 * i}"),
                    ("cond_att_net.dense.", lambda i: f"cond_att_net.attentionNet.{i}"),
                    ("ambient_net.dense.", lambda i: f"ambient_net.net.{i}"),
                    ("sigma_net.dense.", lambda i: f"sigma_net.net.{i}"),
                    ("color_net.dense.", lambda i: f"color_net.net.{i}"))


def reference_head_state(hp: Mapping, seed: int, occupancy: np.ndarray) -> Dict[str, np.ndarray]:
    """A torch-named RADNeRF state dict in the reference's layout for a grid
    head (`hp`'s `grid_type` 'tiledgrid' or 'hashgrid', its widths), seeded:
    the condition encoders (AudioNet `encoder_conv`/`encoder_fc1`,
    AudioAttNet `attentionConvNet`/`attentionNet`), the blink encoder, the
    grid tables, the bias-free MLPs (`*.net.i`), the individual codes, and
    the renderer's buffers: `density_grid` [1, H^3] and `density_bitfield`
    (the spatial `occupancy` [H, H, H] packed in morton order, LSB first),
    `aabb_train`, `aabb_infer`, `step_counter` and the tables' `offsets`.
    Weights are drawn at fan-in scale and the tables at +-0.5, so the field
    varies in space and with the condition."""
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
    from genefaceplusplus_tpu_torch.ops import morton

    cfg = RADNeRFConfig.from_hparams(hp)
    H = cfg.grid_size
    if np.shape(occupancy) != (H, H, H):
        raise ValueError(f"occupancy {np.shape(occupancy)} is not the config's grid [{H}, {H}, {H}]")
    rng = np.random.RandomState(seed)
    s: Dict[str, np.ndarray] = {}
    shapes = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).state_dict()  # the port's names and shapes
    for key, t in shapes.items():
        for prefix, name in _REFERENCE_NAMES:
            if key.startswith(prefix):
                i, leaf = key[len(prefix):].split(".")
                key = f"{name(int(i))}.{leaf}"
        if key.endswith("embeddings") and "individual" not in key:
            s[key] = rng.uniform(-0.5, 0.5, t.shape).astype(np.float32)
        elif key.endswith(".bias"):
            s[key] = (rng.randn(*t.shape) * 0.05).astype(np.float32)
        elif "embedding" in key:  # the individual codes, the blink embedding
            s[key] = (rng.randn(*t.shape) * 0.1).astype(np.float32)
        else:  # an [out, in(, k)] weight
            s[key] = (rng.randn(*t.shape) / np.sqrt(np.prod(t.shape[1:]))).astype(np.float32)
    occ = torch.from_numpy(np.asarray(occupancy, bool))[None]
    density = np.where(occupancy, 20.0, 0.0) + rng.uniform(0.0, 5.0, occupancy.shape)
    s["density_grid"] = morton.spatial_to_morton(torch.from_numpy(density.astype(np.float32))[None]).numpy()
    s["density_bitfield"] = morton.occupancy_to_bitfield(occ).numpy()
    s["aabb_train"] = np.array([-1, -0.5, -1, 1, 0.5, 1], np.float32) * cfg.bound
    s["aabb_infer"] = s["aabb_train"].copy()
    s["step_counter"] = np.zeros((16, 2), np.int32)
    for enc, spec in (("position_embedder", cfg.position_grid_spec()), ("ambient_embedder", cfg.ambient_grid_spec())):
        s[f"{enc}.offsets"] = np.asarray(spec.offsets, np.int32)
    return s


def reference_disc_state(seed: int, img_resolution: int = 512, channel_base: int = 32768, channel_max: int = 512,
                         mapping_layers: int = 8, camera_dim: int = 25) -> Dict[str, np.ndarray]:
    """A torch-named state dict of the reference's `disc` sub-model (the EG3D
    dual discriminator of eg3d_baseline_run2) at the given widths, seeded:
    `b{res}.{fromrgb,conv0,conv1,skip}` (conv weights [out, in, k, k] ~ N(0,
    1), the skip without bias), `mapping.embed` and `mapping.fc{i}` ([out,
    in], the fc layers ~ N(0, 1) / 0.01, their lr multiplier), `b4.{conv,
    fc,out}`, biases ~ N(0, 0.1^2), and the buffers the converter ignores
    (each resampling layer's `resample_filter`, `mapping.w_avg`)."""
    rng = np.random.RandomState(seed)
    block_res = [2 ** i for i in range(int(np.log2(img_resolution)), 2, -1)]
    ch = {r: min(channel_base // r, channel_max) for r in block_res + [4]}
    fir = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0
    s: Dict[str, np.ndarray] = {}

    def layer(name, out_c, in_shape, bias=True, scale=1.0):
        s[f"{name}.weight"] = (rng.randn(out_c, *in_shape) * scale).astype(np.float32)
        if bias:
            s[f"{name}.bias"] = (rng.randn(out_c) * 0.1).astype(np.float32)

    for i, r in enumerate(block_res):
        t, o = ch[r], ch[r // 2]
        if i == 0:
            layer(f"b{r}.fromrgb", t, (6, 1, 1))
        layer(f"b{r}.conv0", t, (t, 3, 3))
        layer(f"b{r}.conv1", o, (t, 3, 3))
        layer(f"b{r}.skip", o, (t, 1, 1), bias=False)
        for buf in (f"b{r}.resample_filter", f"b{r}.conv1.resample_filter", f"b{r}.skip.resample_filter"):
            s[buf] = fir.copy()
    cmap = ch[4]
    layer("mapping.embed", cmap, (camera_dim,))
    for i in range(mapping_layers):
        layer(f"mapping.fc{i}", cmap, (cmap,), scale=100.0)
    s["mapping.w_avg"] = np.zeros(cmap, np.float32)
    layer("b4.conv", cmap, (cmap + 1, 3, 3))
    layer("b4.fc", cmap, (cmap * 16,))
    layer("b4.out", cmap, (cmap,))
    return s


def sync_clip(T: int = 240, seed: int = 0, audio_dim: int = 64):
    """tests/test_sync_scorer.py's clip for the sync scorer: (hubert [2T,
    audio_dim] at 50 Hz, lms [T, 68, 2]) with the mouth opening on a latent
    jaw signal and the audio features a noisy, nuisance-laden projection of
    that signal and its derivative."""
    rng = np.random.RandomState(seed)
    tt = np.arange(T) / 25.0
    jaw = np.clip(0.5 + 0.5 * np.sin(2 * np.pi * 2.3 * tt) * np.sin(2 * np.pi * 0.37 * tt + 1.0), 0, 1)
    base = rng.rand(68, 2) * 0.2  # lm68: eyes 36:48, nose 27:36, mouth 48:68
    base[36:42] = [0.35, 0.35] + rng.rand(6, 2) * 0.02
    base[42:48] = [0.65, 0.35] + rng.rand(6, 2) * 0.02
    base[27:36] = [0.5, 0.45] + rng.rand(9, 2) * 0.02
    base[48:68] = [0.5, 0.7] + rng.rand(20, 2) * 0.05
    lms = np.repeat(base[None], T, 0).copy()
    lms[:, 48:68, 1] += 0.08 * jaw[:, None] * np.linspace(0, 1, 20)[None]
    lms[:, 48:68, 0] += 0.03 * np.sin(2 * np.pi * 0.9 * tt)[:, None]
    jaw50 = np.interp(np.linspace(0, T - 1, 2 * T), np.arange(T), jaw)
    feats = np.stack([jaw50, np.gradient(jaw50)], -1)
    nuis = rng.randn(2 * T, 3) * 0.5
    proj = rng.randn(5, audio_dim) / np.sqrt(5)
    hubert = np.tanh(np.concatenate([feats, nuis], -1) @ proj) + 0.05 * rng.randn(2 * T, audio_dim)
    return hubert.astype(np.float32), lms.astype(np.float32)


def save_reference_ckpt(path: str, state: Mapping[str, np.ndarray], global_step: int = 400_000,
                        sub_model: str = "model") -> None:
    """Write `state` as the reference's trainer saves a checkpoint: torch's
    legacy serialization of `{epoch, global_step, optimizer_states,
    state_dict: {<sub_model>: ...}}`."""
    torch.save({"epoch": 320, "global_step": global_step,
                "optimizer_states": [{"state": {0: {"step": global_step, "exp_avg": torch.zeros(4),
                                                    "exp_avg_sq": torch.zeros(4)}},
                                      "param_groups": [{"lr": 5e-4}]}],
                "state_dict": {sub_model: {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}}},
               path, _use_new_zipfile_serialization=False)


def tiny_infer(size: int = 16, mesh=None):
    """A CPU `GeneFaceInfer` at `size`^2 with a small a2m, from seeded port
    modules over a synthetic dataset of 12 frames, over `mesh` where given."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig

    a2m = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32,
           "a2m_enc_layers": 2, "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
    cfg = RADNeRFConfig.from_hparams({"with_sr": False, "grid_size": 16, "smo_win_size": 3, "cond_win_size": 1,
                                      "individual_embedding_num": 16, "add_eye_blink_cond": True})
    g = torch.Generator().manual_seed(0)
    ds = RADNeRFDataset(synthetic(num_frames=12, H=size, W=size), smo_win_size=3, with_sr=False)
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, 16)] * 3), indexing="ij")
    occupancy = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16
    return GeneFaceInfer(cfg, RADNeRF(cfg, generator=g).state_dict(), ds, occupancy, device="cpu",
                         a2m_hparams=a2m, a2m_params=a2m_model_from_hparams(a2m, generator=g).state_dict(),
                         mesh=mesh)


def reference_hubert_state(config: Mapping, seed: int) -> Dict[str, torch.Tensor]:
    """A HubertForCTC state dict of `config` (a HuBERT config.json dict) in
    the layout of facebook/hubert-large-ls960-ft's pytorch_model.bin,
    seeded: every key under `hubert.`, the positional convolution's weight
    norm as `weight_g` [1, 1, K] and `weight_v`, `masked_spec_embed`, and
    the CTC head `lm_head`. Linear weights N(0, 0.02) (transformers' init),
    convolutions Kaiming normal, the norms' gains and every bias drawn
    away from 1 and 0, the weight-norm gains from the norm of `weight_v`
    times U(0.5, 1.5)."""
    from genefaceplusplus_tpu_torch.models.hubert import HubertConfig, HubertModel
    from genefaceplusplus_tpu_torch.utils.hf_snapshot import POS_CONV

    cfg = HubertConfig.from_json(config)
    with torch.device("meta"):
        model = HubertModel(cfg)
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            value = torch.randn(p.shape, generator=g) * 0.02
        elif "norm" in name:
            value = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
        elif p.dim() == 3:  # a convolution: Kaiming normal over its fan-in
            value = torch.randn(p.shape, generator=g) * (2.0 / (p.shape[1] * p.shape[2])) ** 0.5
        else:
            value = torch.randn(p.shape, generator=g) * 0.02
        if name == f"{POS_CONV}.weight":  # weight norm over all dims but 2
            state[f"hubert.{POS_CONV}.weight_v"] = value
            norm = value.square().sum(dim=(0, 1), keepdim=True).sqrt()
            state[f"hubert.{POS_CONV}.weight_g"] = norm * (0.5 + torch.rand(norm.shape, generator=g))
        else:
            state[f"hubert.{name}"] = value
    state["hubert.masked_spec_embed"] = torch.rand(cfg.hidden_size, generator=g)
    vocab = config.get("vocab_size", 32)
    state["lm_head.weight"] = torch.randn(vocab, cfg.hidden_size, generator=g) * 0.02
    state["lm_head.bias"] = torch.zeros(vocab)
    return state


def hub_snapshot(cache: str, model_name: str, revision: str = "0" * 40) -> str:
    """An empty snapshot directory of `model_name` as the Hugging Face hub
    cache `cache` lays it out (`models--<org>--<name>/refs/main` naming
    `snapshots/<revision>/`). Returns the snapshot directory."""
    repo = os.path.join(cache, "models--" + model_name.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", revision)
    os.makedirs(snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(revision)
    return snap


def write_hubert_snapshot(cache: str, model_name: str, config: Mapping, preprocessor: Mapping, seed: int) -> str:
    """`reference_hubert_state(config, seed)` as the hub cache `cache`
    holds `model_name` (`hub_snapshot`: config.json,
    preprocessor_config.json and pytorch_model.bin). Returns the snapshot
    directory."""
    snap = hub_snapshot(cache, model_name)
    for name, content in (("config.json", config), ("preprocessor_config.json", preprocessor)):
        with open(os.path.join(snap, name), "w") as f:
            json.dump(dict(content), f, indent=2)
    torch.save(reference_hubert_state(config, seed), os.path.join(snap, "pytorch_model.bin"))
    return snap


EP_SEED, EP_QP = 33, 16  # found by a seeded search over small frames


def emulation_prevention_frames() -> np.ndarray:
    """Two 32^2 frames of black-and-white noise (seed EP_SEED) whose slices
    at QP EP_QP hold `00 00 0x` three times: framing them inserts three
    emulation-prevention bytes."""
    return (np.random.RandomState(EP_SEED).randint(0, 2, (2, 32, 32, 3)) * 255).astype(np.uint8)


WIDE = 4096  # past the 3,808 pixels whose slice words fit the kernel's shared memory on an H100


def wide_frames(width: int = WIDE, seed: int = 4) -> np.ndarray:
    """One 48 x `width` frame: smooth ramps (CAVLC macroblocks) with every
    fourth macroblock column noise (the I_PCM escape at QP 4; coded at the
    default QP)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:48, :width]
    f = np.stack([(x * 255 // max(width - 1, 1)), (y * 5 + x // 7) % 256, 128 + 60 * np.sin(x / 37.0 + y / 11.0)], -1)
    f = f + rs.randint(-3, 4, f.shape)
    noisy = (x // 16) % 4 == 3
    f[noisy] = rs.randint(0, 256, (int(noisy.sum()), 3))
    return np.clip(f, 0, 255).astype(np.uint8)[None]
