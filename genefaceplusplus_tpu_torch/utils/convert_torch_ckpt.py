"""The reference's (GeneFace++'s) PyTorch checkpoints -> flax-layout trees
(the port's copy of the numpy mappings of
`genefaceplusplus_tpu/utils/convert_torch_ckpt.py`).

The reference saves `{epoch, global_step, optimizer_states, state_dict:
{model: <torch state dict>}}` with torch's legacy serialization. These maps
turn its tensors into the JAX package's flax trees, on purpose: a converted
work dir is then JAX's own format, which both packages load (the port
through `utils/convert_jax.py`, which flips `ConvTranspose` kernels and
carries `batch_stats`).

  * Conv1d weight [out, in, k]      -> flax Conv kernel [k, in, out]
  * ConvTranspose1d [in, out, k]    -> flax ConvTranspose kernel [k, in, out],
    reversed along k
  * Linear weight [out, in]         -> flax Dense kernel [in, out]
  * torch weight_norm (weight_g [out, 1, 1] + weight_v) is folded into one
    kernel g * v / ||v|| (the WN and coupling convs)
  * BatchNorm1d weight/bias/running_mean/var -> scale/bias + batch_stats
  * Embedding weight -> Embed embedding
  * Conv2d [out, in, kh, kw]        -> flax HWIO (the VGG towers)
  * grid-encoder tables copy as they are (the row layout is the same by
    construction); density_grid / density_bitfield go from morton to
    spatial order (`ops/morton.py`)

The audio-to-motion model (`convert_pitch_contour_vae`), the VGG towers
(`convert_vgg19`, `convert_vggface`), the grid-encoder head
(`convert_radnerf_grid`) and the EG3D dual discriminator
(`convert_eg3d_disc`) are mapped.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_state_dict(path: str, sub_model: str = "model") -> Tuple[Dict[str, np.ndarray], int]:
    """The `sub_model` state dict of a reference checkpoint as numpy arrays,
    and the checkpoint's `global_step` (0 where it has none), from one read.
    The file is unpickled with `weights_only=True`: tensors, containers and
    numbers only (a checkpoint is input from outside the program)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    if sub_model in state:
        state = state[sub_model]
    return {k: _np(v) for k, v in state.items()}, int(ckpt.get("global_step", 0))


def fold_weight_norm(state: Dict[str, np.ndarray], prefix: str, dim: int = 0) -> np.ndarray:
    """g * v / ||v|| with the norm over all dims but `dim` (torch
    weight_norm's `dim`: 0 for the WN convs, 2 for HuBERT's positional
    convolution)."""
    g = state[f"{prefix}.weight_g"]
    v = state[f"{prefix}.weight_v"]
    axes = tuple(a for a in range(v.ndim) if a != dim % v.ndim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def conv1d_to_flax(w: np.ndarray) -> np.ndarray:
    """[out, in, k] -> [k, in, out]."""
    return np.transpose(w, (2, 1, 0))


def convtranspose1d_to_flax(w: np.ndarray) -> np.ndarray:
    """[in, out, k] -> [k, in, out], reversed along k (torch's ConvTranspose
    is the convolution's gradient: its kernel runs the other way to flax's
    fractionally strided convolution)."""
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def linear_to_flax(w: np.ndarray) -> np.ndarray:
    """[out, in] -> [in, out]."""
    return w.T


def _conv_entry(state, torch_prefix, weight_norm=False, transpose=False):
    if weight_norm:
        w = fold_weight_norm(state, torch_prefix)
    else:
        w = state[f"{torch_prefix}.weight"]
    kernel = convtranspose1d_to_flax(w) if transpose else conv1d_to_flax(w)
    out = {"kernel": kernel}
    b = state.get(f"{torch_prefix}.bias")
    if b is not None:
        out["bias"] = b
    return out


def convert_wn(state: Dict[str, np.ndarray], prefix: str, n_layers: int) -> Dict[str, Any]:
    """The WaveNet stack (WN: a weight-normed conditioning conv, then per
    layer a weight-normed dilated conv and a res/skip conv) -> WN params."""
    out: Dict[str, Any] = {}
    if f"{prefix}.cond_layer.weight_g" in state:
        out["cond_layer"] = _conv_entry(state, f"{prefix}.cond_layer", weight_norm=True)
    for i in range(n_layers):
        out[f"in_layer_{i}"] = _conv_entry(state, f"{prefix}.in_layers.{i}", weight_norm=True)
        out[f"res_skip_layer_{i}"] = _conv_entry(state, f"{prefix}.res_skip_layers.{i}", weight_norm=True)
    return out


def convert_coupling_block(state: Dict[str, np.ndarray], prefix: str,
                           n_flows: int = 4, wn_layers: int = 4) -> Dict[str, Any]:
    """ResidualCouplingBlock (torch's ModuleList puts a Flip at each odd
    index)."""
    out: Dict[str, Any] = {}
    for i in range(n_flows):
        t = f"{prefix}.flows.{2 * i}"
        out[f"flow_{i}"] = {
            "pre": _conv_entry(state, f"{t}.pre"),
            "post": _conv_entry(state, f"{t}.post"),
            "enc": convert_wn(state, f"{t}.enc", wn_layers),
        }
    return out


def _conv_stack(state, p0, p1, pbn):
    """ConvStack (Conv-BN-GELU-Conv): (params, batch_stats)."""
    params = {
        "Conv_0": {"kernel": conv1d_to_flax(state[f"{p0}.weight"])},
        "Conv_1": {"kernel": conv1d_to_flax(state[f"{p1}.weight"])},
        "BatchNorm_0": {"scale": state[f"{pbn}.weight"], "bias": state[f"{pbn}.bias"]},
    }
    stats = {
        "BatchNorm_0": {"mean": state[f"{pbn}.running_mean"], "var": state[f"{pbn}.running_var"]},
    }
    return params, stats


def convert_fvae(state: Dict[str, np.ndarray], prefix: str = "vae",
                 enc_layers: int = 8, dec_layers: int = 4) -> Dict[str, Any]:
    """FVAE (encoder, decoder, prior flow) -> FVAE params."""
    p: Dict[str, Any] = {}
    p["g_pre_net"] = _conv_entry(state, f"{prefix}.g_pre_net.0")
    p["encoder"] = {
        "Conv_0": _conv_entry(state, f"{prefix}.encoder.pre_net.0"),
        "wn": convert_wn(state, f"{prefix}.encoder.wn", enc_layers),
        "Conv_1": _conv_entry(state, f"{prefix}.encoder.out_proj"),
    }
    if f"{prefix}.decoder.pre_net.0.weight" in state:
        p["decoder"] = {
            "ConvTranspose_0": _conv_entry(state, f"{prefix}.decoder.pre_net.0", transpose=True),
            "wn": convert_wn(state, f"{prefix}.decoder.wn", dec_layers),
            "Conv_0": _conv_entry(state, f"{prefix}.decoder.out_proj"),
        }
    if f"{prefix}.prior_flow.flows.0.pre.weight" in state:
        p["prior_flow"] = convert_coupling_block(state, f"{prefix}.prior_flow")
    return p


def convert_pitch_contour_vae(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PitchContourVAEModel torch state dict -> flax variables
    {'params', 'batch_stats'}."""
    mel_p, mel_s = _conv_stack(state, "mel_encoder.0", "mel_encoder.3", "mel_encoder.1")
    pit_p, pit_s = _conv_stack(state, "pitch_encoder.0", "pitch_encoder.3", "pitch_encoder.1")
    params: Dict[str, Any] = {
        "blink_embed": {"embedding": state["blink_embed.weight"]},
        "mel_encoder": mel_p,
        "pitch_embed": {"embedding": state["pitch_embed.weight"]},
        "pitch_encoder": pit_p,
        "cond_proj": {"kernel": linear_to_flax(state["cond_proj.weight"]),
                      "bias": state["cond_proj.bias"]},
        "vae": convert_fvae(state),
    }
    if "mouth_amp_embed" in state:
        params["mouth_amp_embed"] = state["mouth_amp_embed"]
    if "eye_amp_embed" in state:
        params["eye_amp_embed"] = state["eye_amp_embed"]
    batch_stats = {"mel_encoder": mel_s, "pitch_encoder": pit_s}
    return {"params": params, "batch_stats": batch_stats}


def conv2d_to_flax(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [out, in, kh, kw] -> flax HWIO [kh, kw, in, out]."""
    return np.transpose(w, (2, 3, 1, 0))


def convert_vgg19(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """torchvision vgg19 state dict -> the VGG19 tower's flax variables
    {'params': {Conv_i: ...}}. Takes torchvision's keys
    (features.{idx}.weight) or the bare conv_x_y naming."""
    tv_conv_idx = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
    names = [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3", "conv3_4",
        "conv4_1", "conv4_2", "conv4_3", "conv4_4",
        "conv5_1", "conv5_2", "conv5_3", "conv5_4",
    ]
    params: Dict[str, Any] = {}
    for i, (tv, nm) in enumerate(zip(tv_conv_idx, names)):
        if f"features.{tv}.weight" in state:
            w, b = state[f"features.{tv}.weight"], state[f"features.{tv}.bias"]
        else:
            w, b = state[f"{nm}.weight"], state[f"{nm}.bias"]
        params[f"Conv_{i}"] = {"kernel": conv2d_to_flax(np.asarray(w)),
                               "bias": np.asarray(b)}
    return {"params": params}


def convert_vggface(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """vgg_face_dag (VGG16, conv_x_y naming) or torchvision vgg16 state dict
    -> the VGGFace tower's flax variables."""
    tv_conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    names = [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3",
        "conv4_1", "conv4_2", "conv4_3",
        "conv5_1", "conv5_2", "conv5_3",
    ]
    params: Dict[str, Any] = {}
    for i, (tv, nm) in enumerate(zip(tv_conv_idx, names)):
        if f"{nm}.weight" in state:
            w, b = state[f"{nm}.weight"], state[f"{nm}.bias"]
        else:
            w, b = state[f"features.{tv}.weight"], state[f"features.{tv}.bias"]
        params[f"Conv_{i}"] = {"kernel": conv2d_to_flax(np.asarray(w)),
                               "bias": np.asarray(b)}
    return {"params": params}


def convert_eg3d_disc(state: Dict[str, np.ndarray], img_resolution: int = 512) -> Dict[str, Any]:
    """The reference's `disc` sub-model (eg3d_baseline_run2) -> the
    `EG3DDualDiscriminator` flax params and `n_mapping_layers`, the number
    of `mapping.fc{i}` layers the state holds.

    Torch layout: `b{res}.{fromrgb,conv0,conv1,skip}.{weight,bias}` with
    conv weights [out, in, k, k] (to HWIO), `mapping.embed` and
    `mapping.fc{i}` [out, in] (kept: `EqualDense` stores [out, in]),
    `b4.{conv,fc,out}`."""
    block_res = [2 ** i for i in range(int(np.log2(img_resolution)), 2, -1)]

    def conv(prefix, bias=True):
        out = {"weight": conv2d_to_flax(state[f"{prefix}.weight"])}
        if bias and f"{prefix}.bias" in state:
            out["bias"] = state[f"{prefix}.bias"]
        return out

    def dense(prefix):
        return {"weight": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}

    params: Dict[str, Any] = {}
    for i, r in enumerate(block_res):
        blk = {"conv0": conv(f"b{r}.conv0"), "conv1": conv(f"b{r}.conv1"), "skip": conv(f"b{r}.skip", bias=False)}
        if i == 0:
            blk["fromrgb"] = conv(f"b{r}.fromrgb")
        params[f"b{r}"] = blk
    mapping: Dict[str, Any] = {"embed": dense("mapping.embed")}
    i = 0
    while f"mapping.fc{i}.weight" in state:
        mapping[f"fc{i}"] = dense(f"mapping.fc{i}")
        i += 1
    params["mapping"] = mapping
    params["b4_conv"] = conv("b4.conv")
    params["b4_fc"] = dense("b4.fc")
    params["b4_out"] = dense("b4.out")
    return {"params": params, "n_mapping_layers": i}


def convert_radnerf_grid(state: Dict[str, np.ndarray], grid_size: int = 128) -> Dict[str, Any]:
    """The reference's RADNeRF (a tiled or hash grid head) torch state dict
    -> {'params': flax params, 'render_state': {'density_grid' [CAS, H, H,
    H] float32, 'occupancy' [H, H, H] bool (cascade 0)}} (each where the
    state has its buffer). The cond_prenet and att-net convs and linears,
    the blink encoder, the bias-free MLPs and the individual codes map as
    above, the grid tables verbatim; `aabb_*`, `step_counter` and the
    tables' `offsets` are derived from the config and ignored."""
    from genefaceplusplus_tpu_torch.ops import morton

    def mlp(prefix, n):
        return {f"Dense_{i}": {"kernel": linear_to_flax(state[f"{prefix}.net.{i}.weight"])} for i in range(n)}

    def dense(prefix):
        return {"kernel": linear_to_flax(state[f"{prefix}.weight"]), "bias": state[f"{prefix}.bias"]}

    def convs(prefix, ids):
        return {f"Conv_{j}": _conv_entry(state, f"{prefix}.{ci}") for j, ci in enumerate(ids)}

    params: Dict[str, Any] = {
        "cond_prenet": {**convs("cond_prenet.encoder_conv", (0, 2, 4, 6)),
                        "Dense_0": dense("cond_prenet.encoder_fc1.0"), "Dense_1": dense("cond_prenet.encoder_fc1.2")},
        "position_embedder": {"embeddings": state["position_embedder.embeddings"]},
        "ambient_embedder": {"embeddings": state["ambient_embedder.embeddings"]},
        "ambient_net": mlp("ambient_net", 3),
        "sigma_net": mlp("sigma_net", 3),
        "color_net": mlp("color_net", 2),
    }
    if "cond_att_net.attentionConvNet.0.weight" in state:
        params["cond_att_net"] = {**convs("cond_att_net.attentionConvNet", (0, 2, 4, 6, 8)),
                                  "Dense_0": dense("cond_att_net.attentionNet.0")}
    if "individual_embeddings" in state:
        params["individual_embeddings"] = state["individual_embeddings"]
    if "blink_embedding.weight" in state:
        params["blink_embedding"] = {"embedding": state["blink_embedding.weight"]}
        params["blink_encoder_0"] = dense("blink_encoder.0")
        params["blink_encoder_1"] = dense("blink_encoder.1")

    render_state: Dict[str, Any] = {}
    if "density_grid" in state:  # [CAS, H^3] in morton order
        g = torch.from_numpy(np.ascontiguousarray(state["density_grid"]))
        render_state["density_grid"] = morton.morton_to_spatial(g, grid_size).numpy()
    if "density_bitfield" in state:
        bits = torch.from_numpy(np.asarray(state["density_bitfield"]).astype(np.uint8))
        cas = bits.numel() * 8 // grid_size ** 3
        render_state["occupancy"] = morton.bitfield_to_occupancy(bits, cas, grid_size)[0].numpy()
    return {"params": params, "render_state": render_state}
