"""Serving: `GeneFaceInfer` (port of
`genefaceplusplus_tpu/inference/pipeline.py`).

Audio-driven: `prepare_batch_from_inp` reads a request's features (HuBERT
[2T, 1024] and f0 [2T] at 50 Hz, precomputed, or computed from a bare
16 kHz wav with the port's HuBERT on the infer device) and sets its
driving-pose schedule; `forward_audio2secc` samples the motion from the flow-VAE
audio-to-motion model, reconstructs the 68 landmarks through the 3DMM
basis, refines them with the pitch-conditioned postnet where one is
loaded, blends them onto the identity's landmarks (LLE), normalises,
clamps, injects blinks and gives the torso's 2D landmarks. The a2m, the
3DMM algebra, the postnet and the LLE run as tensors on the infer device; the
statistics, clamps and blinks are numpy on the host, as in JAX.

GT-driven: `prepare_gt_batch` fills the same batch from the dataset's own
landmarks.

Either batch (poses [T,4,4], the normalised landmark condition [T,1,204],
eye areas [T,1], 2D landmarks lm68 [T,68,2]) renders through
`forward_secc2video` with the production options (probe entry, 10 samples
per ray, T_thresh 1e-2): the fused field (the float32 field for a grid
head), [the torso field composited
behind the head, the 2x SR,] `frames_per_dispatch` frames per chunk,
quantised to uint8 on the device and copied one chunk at a time to the
host. `launch_secc2video` renders without copying (the frames stay on the
device) and `drain_frames` copies them: the stream (`serving.py`) renders
one chunk of audio while the last one's frames are drained.

With a `mesh` (`parallel/mesh.py`, JAX's `mesh` argument) each frame's
field points and torso pixels are split over the mesh's devices; the rest
of the frame, its uint8 quantisation and the copies stay on the main
device, which is the infer device.

`GeneFaceInfer.from_work_dirs` builds all of it from the JAX package's work
dirs (each a `config.yaml` and flax msgpack checkpoints), and `infer_once`
runs a request from features to a video file with the audio
(`data/video.py`): an H.264 mp4 whose frames are encoded on the device
chunk by chunk, or an uncompressed AVI.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from genefaceplusplus_tpu_torch.config import set_hparams
from genefaceplusplus_tpu_torch.data import audio as audio_lib
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.data.mp4 import mp4_bytes
from genefaceplusplus_tpu_torch.data.video import Mp4Writer, StreamingVideoWriter, avi_bytes, video_path
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
from genefaceplusplus_tpu_torch.data.landmarks import (
    INDEX_LM68_FROM_LM478, inject_blink_to_lm68, recompose_lm68_regions)
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams
from genefaceplusplus_tpu_torch.models.full_renderer import (
    auto_head_bbox, auto_head_crop, auto_sr_crop, auto_torso_crop, render_full_frame)
from genefaceplusplus_tpu_torch.models.postnet.lle import compute_lle_projection
from genefaceplusplus_tpu_torch.models.postnet.models import postnet_from_hparams
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, make_aabb
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.ops import raymarch
from genefaceplusplus_tpu_torch.parallel.mesh import Mesh, normalized_device, replicated
from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint, restore_into
from genefaceplusplus_tpu_torch.utils.convert_jax import flax_leaves, unwrap_train_state
from genefaceplusplus_tpu_torch.utils.device import resolve_device
from genefaceplusplus_tpu_torch.utils.lm_projection import calibrate_cano_to_world, project_cano_lm3d
from genefaceplusplus_tpu_torch.utils.rays import get_bg_coords, pixel_rays
from genefaceplusplus_tpu_torch.utils.smoothing import mirror_index, smooth_features_xd

_UNSET = object()
# (frames [n, H', W', 3] uint8 on the device, head-crop fits [n] bool or None, n)
Launched = Tuple[torch.Tensor, Optional[torch.Tensor], int]


def default_inp(**kw) -> Dict[str, Any]:
    """The inference CLI's flag defaults (genefacepp_infer.py:552-592)."""
    inp = {
        "drv_aud": "",
        "drv_pose": "nearest",  # static | <int idx> | <start-end> | nearest/mirror
        "blink_mode": "period",  # none | period
        "temperature": 0.2,
        "lle_percent": 0.2,
        "mouth_amp": 0.4,
        "out_name": "out.mp4",
        "fp16": True,
        "low_memory_usage": True,
        "T_thresh": 1e-2,
        "debug": False,
    }
    inp.update(kw)
    return inp


def resolve_crop(inp: Mapping[str, Any], key: str, auto_value):
    """'auto' (default) -> the load-time value, 'off'/'none'/None ->
    disabled, a list/tuple -> that rect; anything else raises."""
    val = inp.get(key, "auto")
    if isinstance(val, str):
        s = val.strip().lower()
        if s == "auto":
            return auto_value
        if s in ("off", "none", ""):
            return None
        raise ValueError(f"{key}={val!r}: expected 'auto', 'off', or an explicit rect "
                         f"(list/tuple of ints)")
    if val is None:
        return None
    if not isinstance(val, (list, tuple)):
        raise ValueError(f"{key}={val!r}: expected 'auto', 'off', or a list/tuple rect")
    return tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in val)


class GeneFaceInfer:
    """One identity's audio-to-motion model and renderer: the head [+ torso]
    [+ SR].

    cfg: the head config; params: a `RADNeRF` state_dict (random init, or
    converted from a JAX checkpoint by `utils.convert_jax`); dataset: the
    identity's poses, condition statistics and background (built with
    `with_sr=True` for an SR identity: SR doubles its render size);
    occupancy: [G,G,G] bool density grid. The torso renders when
    `torso_cfg` is given, from `torso_params` (a `TorsoField` state_dict),
    culled by `torso_occupancy_2d` [G2, G2] where given; SR runs when
    `sr_params` (a `Superresolution` state_dict, its `noise_const` buffers
    included) is given, in `sr_dtype` (bfloat16, the production `sr_dtype`,
    or float32). The audio path needs `a2m_params` (a `PitchContourVAEModel`
    or `VAEModel` state_dict, built from `a2m_hparams`: the audio2motion
    config's keys, JAX's defaults where absent); the 3DMM basis comes from
    `bfm_dir` (the stand-in basis where `BFM_model_front.mat` is absent), and
    the a2m's draws from a generator seeded with 42, JAX's key. The postnet
    refiner runs where `postnet_params` (a `PitchContourCNNPostNet`
    state_dict, built from `postnet_hparams`: `postnet_out_dim`,
    `postnet_hidden`, `postnet_layers`) is given. Everything lives on
    `device`: the CUDA card unless another device is named (raises when
    there is no card). With `mesh` (its main device `device`) every frame's
    field points and torso pixels are split over the mesh's devices, on
    replicas of the head, its fused-field weights and the torso made here,
    once. `from_work_dirs` builds one from JAX work dirs."""

    def __init__(self, cfg: RADNeRFConfig, params: Mapping[str, torch.Tensor],
                 dataset: RADNeRFDataset, occupancy, device=None, *,
                 torso_cfg: Optional[TorsoConfig] = None,
                 torso_params: Optional[Mapping[str, torch.Tensor]] = None,
                 torso_occupancy_2d=None, sr_params: Optional[Mapping[str, torch.Tensor]] = None,
                 sr_dtype: torch.dtype = torch.bfloat16,
                 a2m_hparams: Optional[Mapping[str, Any]] = None,
                 a2m_params: Optional[Mapping[str, torch.Tensor]] = None,
                 postnet_hparams: Optional[Mapping[str, Any]] = None,
                 postnet_params: Optional[Mapping[str, torch.Tensor]] = None,
                 bfm_dir: str = "deep_3drecon/BFM", head_crop_pad_px: int = 12,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.main != normalized_device(self.device):
            raise ValueError(f"the mesh's main device {mesh.main} is not the infer device {self.device}")
        self.mesh = mesh
        self.a2m_cfg = dict(a2m_hparams or {})
        self.a2m_model = None
        if a2m_params is not None:
            self.a2m_model = a2m_model_from_hparams(self.a2m_cfg)
            self.a2m_model.load_state_dict(a2m_params)
            self.a2m_model.to(self.device).eval()
        self.postnet_model = None
        if postnet_params is not None:
            self.postnet_model = postnet_from_hparams(postnet_hparams or {})
            self.postnet_model.load_state_dict(postnet_params)
            self.postnet_model.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self.face3d_helper = Face3DHelper.load(bfm_dir, keypoint_mode="mediapipe", device=self.device)
        self.bfm_dir = bfm_dir
        self._secc_renderer: Any = _UNSET  # made at the first --debug frame
        eaps = dataset.eye_area_percents
        self.opened_eye_area_percent = float(np.quantile(eaps, 0.97))
        self.closed_eye_area_percent = float(np.quantile(eaps, 0.03))
        self._cano_proj: Any = _UNSET  # calibrated on first use
        self.head_cfg = cfg
        self.head_model = RADNeRF(cfg)
        self.head_model.load_state_dict(params)
        self.head_model.to(self.device).eval()
        # a Fourier head's field runs as the fused kernel (B1); a grid head's
        # (tiledgrid / hashgrid, as the reference trains them) as the float32
        # RADNeRF.field, as JAX serves it
        self.field_weights = (ff.weights_from_params(self.head_model, bound=cfg.bound)
                              if cfg.grid_type == "fourier" else None)
        self.torso_cfg, self.torso_model = torso_cfg, None
        if torso_cfg is not None:
            if torso_params is None:
                raise ValueError("torso_cfg given without torso_params")
            self.torso_model = TorsoField(torso_cfg)
            self.torso_model.load_state_dict(torso_params)
            self.torso_model.to(self.device).eval()
        self.torso_occupancy_2d = (None if torso_occupancy_2d is None else
                                   torch.as_tensor(torso_occupancy_2d, dtype=torch.float32).to(self.device))
        self.sr_model = None
        if sr_params is not None:
            self.sr_model = Superresolution(channels=3, input_resolution=256, dtype=sr_dtype)
            self.sr_model.load_state_dict(sr_params)
            self.sr_model.to(self.device).eval()
        self.dataset = dataset
        self.occupancy = torch.as_tensor(occupancy, dtype=torch.bool).to(self.device)
        self.bg_color = torch.as_tensor(dataset.bg_img.reshape(-1, 3), dtype=torch.float32).to(self.device)
        self.bg_coords = get_bg_coords(dataset.H, dataset.W, device=self.device)[0]
        self.head_crop_pad_px = int(head_crop_pad_px)
        self.head_crop = self._auto_head_crop()
        # the torso's footprint is static in screen space: one rect at load,
        # at the render-time mask threshold (the mean density is 0 here)
        self.torso_crop = None
        if self.torso_model is not None and self.torso_occupancy_2d is not None:
            self.torso_crop = auto_torso_crop(self.torso_occupancy_2d, dataset.H, dataset.W,
                                              thr=torso_cfg.density_thresh_torso)
        self.sr_crop, self.sr_bg = self._auto_sr_crop()
        if mesh is not None:  # the replicas, once
            for obj in (self.head_model, self.field_weights, self.torso_model):
                if obj is not None:
                    replicated(mesh, obj)

    @classmethod
    def from_work_dirs(cls, audio2secc_dir: Optional[str] = None, head_model_dir: Optional[str] = None,
                       torso_model_dir: Optional[str] = None, postnet_dir: Optional[str] = None,
                       dataset: Optional[RADNeRFDataset] = None, bfm_dir: str = "deep_3drecon/BFM",
                       device=None, mesh: Optional[Mesh] = None) -> "GeneFaceInfer":
        """The identity of JAX work dirs, as JAX's `GeneFaceInfer.__init__`
        reads them (`genefaceplusplus_tpu/inference/pipeline.py:97-252`).

        Each dir holds `config.yaml` (with its `base_config` chain) and
        `model_ckpt_steps_N.ckpt` files, of which the newest is read. The
        head dir defaults to the torso config's `head_model_dir`. The head
        config's `with_sr` adds the SR (in its `sr_dtype`) from the head
        dir's checkpoint; the a2m comes from `audio2secc_dir` only (without
        it the instance is GT-driven); the dataset, unless given, from the
        head config's `binary_data_dir/video_id/trainval_dataset.npy`. The
        occupancy grid and the torso's 2D grid come from the checkpoints'
        `extra_state` (the head's grid all ones where absent); the postnet
        refiner from `postnet_dir`, its widths from that dir's config. A
        checkpoint that restores no tensor raises; a dir without a
        checkpoint keeps the port's initial weights (seed 0) and says so.
        `mesh` is the constructor's."""
        if not head_model_dir and torso_model_dir:
            head_model_dir = set_hparams(work_dir=torso_model_dir).get("head_model_dir", "") or None
        head_dir = head_model_dir or torso_model_dir
        if not head_dir:
            raise ValueError("from_work_dirs needs a head or a torso work dir")
        newest = {d: get_last_checkpoint(d) for d in {head_dir, torso_model_dir, audio2secc_dir, postnet_dir}
                  if d}
        head_raw = set_hparams(work_dir=head_dir)
        cfg = RADNeRFConfig.from_hparams(head_raw)
        params = _restore(RADNeRF(cfg, generator=_seed()), newest[head_dir], head_dir, "head")
        kw: Dict[str, Any] = {}
        if torso_model_dir:
            tcfg = TorsoConfig.from_hparams(set_hparams(work_dir=torso_model_dir))
            kw.update(torso_cfg=tcfg, torso_params=_restore(TorsoField(tcfg, generator=_seed()),
                                                            newest[torso_model_dir], torso_model_dir, "torso"))
            extra = (newest[torso_model_dir][0] or {}).get("extra_state", {})
            if "torso_grid" in extra:
                kw["torso_occupancy_2d"] = np.array(extra["torso_grid"], np.float32)
        if head_raw.get("with_sr", False):
            kw["sr_dtype"] = torch.bfloat16 if head_raw.get("sr_dtype", "bfloat16") == "bfloat16" else torch.float32
            kw["sr_params"] = _restore(Superresolution(3, 256, generator=_seed()), newest[head_dir], head_dir, "sr")
        if audio2secc_dir:
            a2m_hp = set_hparams(work_dir=audio2secc_dir).to_dict()
            kw.update(a2m_hparams=a2m_hp, a2m_params=_restore(
                a2m_model_from_hparams(a2m_hp, generator=_seed()), newest[audio2secc_dir], audio2secc_dir, None, "a2m"))
        if postnet_dir:
            pn_hp = set_hparams(work_dir=postnet_dir).to_dict()
            kw.update(postnet_hparams=pn_hp, postnet_params=_restore(
                postnet_from_hparams(pn_hp, generator=_seed()), newest[postnet_dir], postnet_dir, None, "postnet"))
        if dataset is None:
            ds_path = os.path.join(head_raw.get("binary_data_dir", ""), head_raw.get("video_id", ""),
                                   "trainval_dataset.npy")
            if not (head_raw.get("binary_data_dir") and os.path.exists(ds_path)):
                raise ValueError(f"no dataset: {ds_path} (the head config's binary_data_dir/video_id) does "
                                 "not exist; pass dataset=")
            dataset = RADNeRFDataset(ds_path, split="train", smo_win_size=cfg.smo_win_size,
                                     with_sr=head_raw.get("with_sr", True))
        extra = (newest[head_dir][0] or {}).get("extra_state", {})
        if "occupancy" in extra and np.asarray(extra["occupancy"]).ndim == 3:
            occupancy = np.asarray(extra["occupancy"]).astype(bool)
        else:
            print(f"| {head_dir}: no occupancy grid in the checkpoint; using an all-ones grid")
            occupancy = np.ones((cfg.grid_size,) * 3, bool)
        infer = cls(cfg, params, dataset, occupancy, device, bfm_dir=bfm_dir,
                    head_crop_pad_px=int(head_raw.get("head_crop_pad_px", 12)), mesh=mesh, **kw)
        infer.head_cfg_raw = head_raw
        return infer

    def _auto_head_crop(self):
        """Crop (ch, cw) covering the occupied AABB's projection across every
        dataset pose, or None when cropping would not pay. Re-run after
        replacing `occupancy` (then `_auto_sr_crop`, which reuses its bbox)."""
        ds = self.dataset
        poses = np.stack([ds.frame_pose(i) for i in range(len(ds))])
        self._head_bbox = auto_head_bbox(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                                         bound=self.head_cfg.bound)
        return auto_head_crop(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                              bound=self.head_cfg.bound, pad_px=self.head_crop_pad_px, bbox=self._head_bbox)

    @torch.no_grad()
    def _auto_sr_crop(self):
        """(sr_crop, sr_bg): the static SR rects (`auto_sr_crop`) and the SR
        of the background, [2H, 2W, 3], or (None, None) without SR or when
        the changing region nearly fills the frame."""
        ds = self.dataset
        if self.sr_model is None:
            return None, None
        if self.torso_model is None:
            torso_rect = None
        elif self.torso_crop is not None:
            torso_rect = self.torso_crop
        else:
            torso_rect = (0, 0, ds.H, ds.W)  # uncropped torso: alpha unbounded
        sr_crop = auto_sr_crop(self._head_bbox, torso_rect, ds.H, ds.W)
        if sr_crop is None:
            return None, None
        bg = self.bg_color.reshape(1, ds.H, ds.W, 3)
        return sr_crop, torch.clamp(self.sr_model(bg), 0.0, 1.0)[0]

    def prepare_batch_from_inp(self, inp: Mapping[str, Any]) -> Dict[str, Any]:
        """A request's features and driving-pose schedule. The features come
        from `inp['drv_aud_features']`, an .npy of {'hubert' [2T, C], 'f0'
        [2T][, 'wav16k']}, or from a bare wav (`inp['drv_aud']`): its mel
        (which pads the wav), F0, and HuBERT on the padded wav on this
        instance's device, from the local snapshot (`data/audio.py`; raises
        where none is found)."""
        batch: Dict[str, Any] = {}
        if inp.get("drv_aud_features"):
            feats = np.load(inp["drv_aud_features"], allow_pickle=True).tolist()
            hubert, f0 = np.asarray(feats["hubert"], np.float32), np.asarray(feats["f0"], np.float32)
            wav16k = feats.get("wav16k")
        else:
            wav16k = audio_lib.load_wav_16k(inp["drv_aud"])
            wav16k, mel = audio_lib.extract_mel(wav16k)
            f0 = audio_lib.extract_f0(wav16k, mel_len=len(mel))
            if not audio_lib.hubert_available():
                raise RuntimeError("HuBERT weights unavailable in this environment; pass "
                                   "inp['drv_aud_features'] = npy with {'hubert','f0'} instead.")
            hubert = audio_lib.get_hubert_from_16k_speech(wav16k, device=self.device)
        # trim to a multiple of 8 frames at 50 Hz, as the reference does
        t_x = hubert.shape[0] // 8 * 8
        hubert = hubert[:t_x]
        f0 = f0[:t_x] if len(f0) >= t_x else np.pad(f0, (0, t_x - len(f0)), mode="edge")
        if wav16k is None:
            wav16k = np.zeros(t_x * audio_lib.HOP_SIZE, np.float32)
        batch["hubert"] = hubert
        batch["f0"] = f0
        batch["wav16k"] = wav16k
        T_motion = t_x // 2
        batch["T"] = T_motion

        ds = self.dataset
        drv_pose = str(inp.get("drv_pose", "nearest"))
        n_ds = len(ds)
        if drv_pose == "static":
            pose_idx = [0] * T_motion
        elif drv_pose.isdigit():
            pose_idx = [min(int(drv_pose), n_ds - 1)] * T_motion
        elif "-" in drv_pose and all(p.isdigit() for p in drv_pose.split("-")):
            lo, hi = (int(p) for p in drv_pose.split("-"))
            span = list(range(lo, min(hi, n_ds)))
            pose_idx = [span[mirror_index(i, len(span))] for i in range(T_motion)]
        else:  # nearest / mirror: ping-pong over the whole dataset
            pose_idx = [mirror_index(i, n_ds) for i in range(T_motion)]
        batch["pose_idx"] = np.asarray(pose_idx)
        batch["poses"] = np.stack([ds.frame_pose(i) for i in pose_idx])
        batch["eulers"] = np.asarray(ds.ds["euler"])[pose_idx]
        batch["transs"] = np.asarray(ds.ds["trans"])[pose_idx]
        return batch

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    @torch.no_grad()
    def forward_audio2secc(self, batch: Dict[str, Any], inp: Mapping[str, Any],
                           noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Motion, landmark condition and torso landmarks for a prepared
        batch: adds 'cond' [T, 1, 204], 'eye_area_percent' [T, 1], 'lm68'
        [T, 68, 2], 'id_coeff', 'exp', and the a2m's output 'a2m_out' and
        unit-normal draw 'a2m_noise' (None at temperature 0). `noise`
        [1, T_sqz, 16] replaces the draw from this instance's generator."""
        if self.a2m_model is None:
            raise ValueError("no audio-to-motion weights: construct GeneFaceInfer with a2m_params")
        T = batch["T"]
        temp = float(inp.get("temperature", 0.2))
        if noise is None and temp != 0.0:
            noise = torch.randn((1, self.a2m_model.vae.latent_length(T), self.a2m_model.vae.latent_size),
                                generator=self.generator, device=self.device)
        a2m_in = a2m_batch(batch["hubert"], batch["f0"], float(inp.get("mouth_amp", 0.4)), self.device)
        pred_t, _ = self.a2m_model(a2m_in, train=False, temperature=temp, noise=noise)
        pred_t = pred_t[0]  # [T, 64] exp, 144 id + exp, or 204 idexp_lm3d
        pred = pred_t.cpu().numpy()
        batch["a2m_out"] = pred
        if isinstance(noise, torch.Tensor):
            noise = noise.cpu().numpy()
        batch["a2m_noise"] = None if noise is None else np.asarray(noise, np.float32)
        ds = self.dataset
        if pred.shape[-1] == 204:
            # direct landmark-space motion: pred is idexp_lm3d in the
            # binarizer's x10 convention; no id/exp coefficients exist
            idexp = pred.reshape(T, 68, 3)
            id_coeff = np.zeros((T, 80), np.float32)
            exp = np.zeros((T, 64), np.float32)
        else:
            if pred.shape[-1] == 144:
                id_coeff, exp = pred[:, :80], pred[:, 80:]
            else:
                ds_id = np.asarray(ds.ds["id"], np.float32)
                id_coeff = np.tile(ds_id.mean(0, keepdims=True), (T, 1))
                exp = pred
            idexp = self.face3d_helper.reconstruct_idexp_lm3d(
                self._tensor(id_coeff), self._tensor(exp)).cpu().numpy()
            if idexp.shape[1] >= 468:
                idexp = idexp[:, INDEX_LM68_FROM_LM478]

        # the dataset's own stored mean and std (the renderer's training
        # normalisation) and 3 % / 97 % quantile clamps
        ds_lm = np.asarray(ds.ds["idexp_lm3d"], np.float32).reshape(-1, 68, 3)
        mean = np.asarray(ds.idexp_lm3d_mean, np.float32).reshape(1, 68, 3)
        std = np.asarray(ds.idexp_lm3d_std, np.float32).reshape(1, 68, 3)
        norm_ds = (ds_lm - mean) / std
        lower = np.quantile(norm_ds, 0.03, axis=0)
        upper = np.quantile(norm_ds, 0.97, axis=0)

        flat = idexp.reshape(T, 68 * 3)
        if self.postnet_model is not None:  # refine the raw landmarks before the LLE blend
            f0n = (np.asarray(batch["f0"], np.float32) / 400.0).reshape(1, -1, 1)
            flat = self.postnet_model(self._tensor(flat[None]), self._tensor(f0n))[0].cpu().numpy()
        lle_percent = float(inp.get("lle_percent", 0.2))
        if lle_percent > 0:  # LLE blend onto the identity's landmarks, K capped by its frames
            fuse, _, _ = compute_lle_projection(self._tensor(flat), self._tensor(ds_lm.reshape(-1, 68 * 3)),
                                                K=min(10, ds_lm.shape[0]))
            flat = lle_percent * fuse.cpu().numpy() + (1 - lle_percent) * flat
        idexp = flat.reshape(T, 68, 3)
        normalized = np.clip((idexp - mean) / std, lower, upper)

        # canonical lm3d; optional periodic blink by direct editing
        key_mean = self.face3d_helper.key_mean_shape.cpu().numpy()
        if key_mean.shape[0] >= 468:
            key_mean = key_mean[INDEX_LM68_FROM_LM478]
        cano_lm3d = (mean + std * normalized) / 10.0 + key_mean[None]
        eye_area_percent = np.full((T, 1), self.opened_eye_area_percent, np.float32)
        if inp.get("blink_mode") == "period":
            cano_lm3d, eye_area_percent = inject_blink_to_lm68(
                cano_lm3d, self.opened_eye_area_percent, self.closed_eye_area_percent)
        normalized = ((cano_lm3d - key_mean[None]) * 10.0 - mean) / std
        normalized = np.clip(normalized, lower, upper)
        normalized = recompose_lm68_regions(normalized)
        if not np.isfinite(normalized).all():
            # a non-finite condition renders structured garbage: fail loudly
            bad = np.where(~np.isfinite(normalized).reshape(T, -1).all(axis=1))[0]
            raise FloatingPointError(f"non-finite driven condition at frames {bad.tolist()} — "
                                     "upstream a2m/LLE produced NaN/Inf")
        batch["eye_area_percent"] = eye_area_percent
        batch["cond"] = normalized.reshape(T, 1, 68 * 3).astype(np.float32)
        batch["id_coeff"] = np.asarray(id_coeff, np.float32)
        batch["exp"] = np.asarray(exp, np.float32)

        # smoothed head pose -> 2D landmarks for the torso condition
        smo_euler = self._tensor(smooth_features_xd(batch["eulers"]))
        smo_trans = self._tensor(smooth_features_xd(batch["transs"]))
        if pred.shape[-1] == 204:
            # direct drive: project the final driven landmarks through the
            # identity's calibrated camera map where it explains the
            # dataset's stored 2D landmarks, else the BFM convention
            cano_final = (mean + std * normalized) / 10.0 + key_mean[None]
            proj = self._cano_projection()
            if proj is not None:
                lm2d = project_cano_lm3d(proj, cano_final.astype(np.float32),
                                         np.asarray(batch["poses"], np.float32), ds.intrinsics, ds.H, ds.W)
            else:
                lm2d = self.face3d_helper.project_lm3d_nerf(
                    self._tensor(cano_final), smo_euler, smo_trans).cpu().numpy()
        else:
            lm2d = self.face3d_helper.reconstruct_lm2d_nerf(
                self._tensor(id_coeff), self._tensor(exp), smo_euler, smo_trans).cpu().numpy()
        if lm2d.shape[1] >= 468:
            lm2d = lm2d[:, INDEX_LM68_FROM_LM478]
        batch["lm68"] = lm2d.astype(np.float32)
        return batch

    def _cano_projection(self):
        """The identity's canonical -> world map for the direct-drive torso
        landmarks (`utils/lm_projection.py`), calibrated once; None when the
        dataset lacks stored 2D landmarks or the fit does not explain them."""
        if self._cano_proj is not _UNSET:
            return self._cano_proj
        out = None
        ds = self.dataset
        if len(ds) >= 2:
            lms = [s.get("lms") for s in ds.samples]
            if all(lm is not None for lm in lms):
                key_mean = self.face3d_helper.key_mean_shape.cpu().numpy()
                if key_mean.shape[0] >= 468:
                    key_mean = key_mean[INDEX_LM68_FROM_LM478]
                idexp = np.asarray(ds.ds["idexp_lm3d"], np.float32).reshape(-1, 68, 3)
                fids = np.clip(np.asarray(ds.frame_ids), 0, len(idexp) - 1)
                cano = idexp[fids] / 10.0 + key_mean[None]
                M, resid = calibrate_cano_to_world(cano, ds.poses, ds.intrinsics, np.stack(lms), ds.H, ds.W)
                if resid <= 0.02 * ds.W:
                    out = M
                    print(f"| lm2d projection: calibrated (residual {resid:.2f}px @ {ds.W})")
                else:
                    print(f"| WARNING: lm2d calibration residual {resid:.1f}px > {0.02 * ds.W:.1f} — "
                          "falling back to the BFM projection convention")
        self._cano_proj = out
        return out

    def prepare_gt_batch(self, frame_ids) -> Dict[str, Any]:
        """GT-driven request: the dataset frames' own poses, normalised
        landmark conditions and eye areas, under the keys of the JAX batch
        (`lm68` from the stored 2D landmarks, zeros where absent)."""
        ds = self.dataset
        ids = [int(i) for i in frame_ids]
        lms = [ds.samples[i].get("lms") for i in ids]
        lm68 = (np.stack(lms).astype(np.float32) if all(l is not None for l in lms)
                else np.zeros((len(ids), 68, 2), np.float32))
        return {
            "T": len(ids),
            "poses": np.stack([ds.frame_pose(i) for i in ids]).astype(np.float32),
            "cond": ds.conds[ids].astype(np.float32),  # [T, cond_win, 204]
            "eye_area_percent": ds.eye_area_percents[ids].astype(np.float32),  # [T, 1]
            "lm68": lm68,
        }

    def render_options(self, inp: Mapping[str, Any]) -> RenderOptions:
        """The production options (probe entry, S=10, T_thresh 1e-2) with
        the request's `color_topk` and `compact_frac`. `forward_secc2video`
        turns a `compact_frac` of "auto" into a measured budget; where "auto"
        reaches this unresolved (a stream, whose pose track is not known
        yet) compaction is off, as in JAX's stream."""
        cf = inp.get("compact_frac", 0.0)
        return RenderOptions(
            num_samples=int(inp.get("num_samples", 10)),
            T_thresh=float(inp.get("T_thresh", 1e-2)),
            entry_mode=str(inp.get("entry_mode", "probe")),
            color_topk=int(inp.get("color_topk", 0)),
            compact_frac=0.0 if str(cf) == "auto" else float(cf),
        )

    @torch.no_grad()
    def live_sample_counts(self, poses, opts: RenderOptions, image_hw: tuple, max_probe: int = 32) -> np.ndarray:
        """The marcher's live-sample count of the full (H, W) frame at up to
        `max_probe` evenly spaced poses of `poses` (interval march mode).
        The mask depends on the occupancy and the rays only, so a count is
        exact and needs no field. Reads the counts to the host once."""
        H, W = image_hw
        cfg, dev = self.head_cfg, self.device
        aabb = make_aabb(cfg.bound, device=dev)
        occ_box = raymarch.occupancy_aabb(self.occupancy, cfg.bound)
        T = len(poses)
        counts = []
        for i in np.unique(np.linspace(0, T - 1, min(T, max_probe)).astype(int)):
            pose = torch.as_tensor(np.asarray(poses[i]), dtype=torch.float32, device=dev)
            ro, rd = (x[0] for x in pixel_rays(pose[None], self.dataset.intrinsics, H, W))
            nears, fars = raymarch.near_far_from_aabb(ro, rd, aabb, cfg.min_near)
            t_entry = t_exit = None
            if opts.entry_mode == "probe":
                t_entry, t_exit = raymarch.entry_exit_depth_map(
                    ro, rd, self.occupancy, occ_box, cfg.bound, (H, W), stride=opts.probe_stride,
                    coarse_factor=opts.probe_coarse_factor, n_probe=opts.n_probe, min_near=cfg.min_near)
            m = raymarch.march_rays_interval(
                ro, rd, nears, fars, occ_box, bound=cfg.bound, max_steps=opts.max_steps,
                num_samples=opts.num_samples, min_near=cfg.min_near, grid_size=self.occupancy.shape[0],
                t_entry=t_entry, t_exit=t_exit)
            counts.append(m.mask.sum())
        return torch.stack(counts).cpu().numpy()

    def _auto_compact_frac(self, poses, opts: RenderOptions, image_hw: tuple, head_crop,
                           max_probe: int = 32, margin: float = 1.25) -> float:
        """A `compact_frac` that covers the live samples of these poses: the
        largest of `live_sample_counts`, times `margin` for the poses
        between the probed ones, over the head render's R*S slots (R the
        crop window's rays where `head_crop` is active: every live sample
        lies inside it), rounded up to the renderer's 512 slots. Returns 0.0
        (off) when it would not skip 10 % of the slots, or in grid march
        mode."""
        if opts.march_mode != "interval":
            return 0.0
        H, W = image_hw
        max_live = int(self.live_sample_counts(poses, opts, image_hw, max_probe).max())
        R = head_crop[0] * head_crop[1] if head_crop is not None else H * W
        N = R * opts.num_samples
        frac = min(max(margin * max_live / float(N), 1.0 / opts.num_samples), 1.0)
        # the renderer's budget M: equal budgets give equal options
        M = min(N, max(512, ((int(frac * N) + 511) // 512) * 512))
        frac = M / float(N)
        return 0.0 if frac >= 0.9 else float(frac)

    def render_frame(self, rays_o, rays_d, cond_window, eye_area_percent, lm68,
                     inp: Optional[Mapping[str, Any]] = None, fused_fn=ff.fused_field, *,
                     mesh: Optional[Mesh] = None):
        """One frame through `render_full_frame` with this identity's models,
        grids and load-time crops (each overridable in `inp` as 'auto',
        'off' or a rect), over `mesh` (this instance's by default). Returns
        its FrameOutput."""
        inp = dict(inp or {})
        ds = self.dataset
        sr_crop = resolve_crop(inp, "sr_crop", self.sr_crop)
        return render_full_frame(
            self.head_model, rays_o, rays_d, cond_window, self.occupancy, self.bg_color,
            self.render_options(inp), (ds.H, ds.W), eye_area_percent=eye_area_percent, index=0,
            head_crop=resolve_crop(inp, "head_crop", self.head_crop),
            field_weights=self.field_weights, fused_fn=fused_fn,
            torso_model=self.torso_model, bg_coords=self.bg_coords, lm68=lm68,
            occupancy_2d=self.torso_occupancy_2d, sr_model=self.sr_model,
            torso_crop=resolve_crop(inp, "torso_crop", self.torso_crop),
            sr_crop=sr_crop, sr_bg=self.sr_bg if sr_crop is not None else None,
            mesh=self.mesh if mesh is None else mesh)

    @torch.no_grad()
    def launch_secc2video(self, batch: Mapping[str, Any], inp: Optional[Mapping[str, Any]] = None,
                          start: int = 0, stop: Optional[int] = None, *,
                          mesh: Optional[Mesh] = None) -> List[Launched]:
        """Render frames [start, stop) of the batch (all by default),
        `frames_per_dispatch` a chunk, into uint8 tensors on the device,
        [2H, 2W, 3] with SR and [H, W, 3] without, and return them without
        copying (`drain_frames` copies them). `mesh` is `render_frame`'s."""
        inp = dict(inp or {})
        ds, dev = self.dataset, self.device
        H, W = ds.H, ds.W
        up = 2 if self.sr_model is not None else 1
        T = int(batch["T"])
        stop = T if stop is None else min(stop, T)
        chunk = max(1, min(int(inp.get("frames_per_dispatch", 8)), T))

        conds = torch.as_tensor(np.asarray(batch["cond"]), dtype=torch.float32, device=dev)
        cond_windows = get_audio_features_batch(
            conds, torch.arange(T, device=dev), self.head_cfg.smo_win_size)
        eye_areas = torch.as_tensor(np.asarray(batch["eye_area_percent"]),
                                    dtype=torch.float32, device=dev).reshape(T, 1)
        poses_all = torch.as_tensor(np.asarray(batch["poses"]), dtype=torch.float32, device=dev)
        lm68s = torch.as_tensor(np.asarray(batch["lm68"]), dtype=torch.float32, device=dev)
        launched = []
        for first in range(start, stop, chunk):
            n = min(chunk, stop - first)
            rays_o, rays_d = pixel_rays(poses_all[first:first + n], ds.intrinsics, H, W)
            imgs = torch.empty((n, up * H, up * W, 3), dtype=torch.uint8, device=dev)
            fits = None
            for j in range(n):
                t = first + j
                out = self.render_frame(rays_o[j], rays_d[j], cond_windows[t], eye_areas[t],
                                        lm68s[t][None], inp, mesh=mesh)
                img = out.sr_rgb_map if out.sr_rgb_map is not None else out.rgb_map.reshape(H, W, 3)
                imgs[j] = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
                if out.head_crop_fits is not None:
                    if fits is None:
                        fits = torch.ones(n, dtype=torch.bool, device=dev)
                    fits[j] = out.head_crop_fits
            launched.append((imgs, fits, n))
        return launched

    @staticmethod
    def watch_crop(launched: Iterable[Launched]) -> Iterator[Launched]:
        """Pass launched chunks through; at the end, warn where the head left
        the head crop."""
        frames = misses = 0
        for imgs, fits, n in launched:
            frames += n
            if fits is not None:
                misses += int((~fits).sum())
            yield imgs, fits, n
        if misses:
            print(f"| WARNING: head exceeded the auto head-crop window on {misses}/{frames} frames "
                  "(driving poses outside the dataset envelope); rerun with "
                  "head_crop='off' for these poses")

    @staticmethod
    def drain_frames(launched: Iterable[Launched]) -> Iterator[np.ndarray]:
        """Copy launched frames to the host, one chunk at a time, and yield
        them as uint8 arrays; warn where the head left the head crop."""
        for imgs, _, _ in GeneFaceInfer.watch_crop(launched):
            yield from imgs.cpu().numpy()

    def launch_all(self, batch: Mapping[str, Any], inp: Optional[Mapping[str, Any]] = None) -> Iterator[Launched]:
        """Launch the batch's frames one chunk at a time (`launch_secc2video`),
        the frames left on the device. A `compact_frac` of "auto" becomes
        the budget that `_auto_compact_frac` measures on the batch's poses;
        the active render options are printed first."""
        inp = dict(inp or {})
        ds = self.dataset
        T = int(batch["T"])
        chunk = max(1, min(int(inp.get("frames_per_dispatch", 8)), T))
        head_crop = resolve_crop(inp, "head_crop", self.head_crop)
        if str(inp.get("compact_frac", 0.0)) == "auto":  # a budget that covers this request's poses
            inp["compact_frac"] = self._auto_compact_frac(batch["poses"], self.render_options(inp),
                                                          (ds.H, ds.W), head_crop)
        opts = self.render_options(inp)
        print(f"| render: entry_mode={opts.entry_mode} num_samples={opts.num_samples} "
              f"color_topk={opts.color_topk} compact_frac={opts.compact_frac} T_thresh={opts.T_thresh} "
              f"head_crop={head_crop} torso_crop={resolve_crop(inp, 'torso_crop', self.torso_crop)} "
              f"sr_crop={'on' if resolve_crop(inp, 'sr_crop', self.sr_crop) else None}")
        for start in range(0, T, chunk):
            yield from self.launch_secc2video(batch, inp, start, start + chunk)

    def forward_secc2video(self, batch: Mapping[str, Any],
                           inp: Optional[Mapping[str, Any]] = None) -> Iterator[np.ndarray]:
        """Yield the batch's frames as uint8 arrays, [2H, 2W, 3] with SR and
        [H, W, 3] without, rendered through the head field one chunk at a
        time (`launch_all`) and copied to the host."""
        yield from self.drain_frames(self.launch_all(batch, inp))

    def secc_debug_frame(self, batch: Mapping[str, Any], i: int, size: int) -> np.ndarray:
        """The SECC panel [size, size, 3] uint8 of the request's frame i (the
        reference's --debug, genefacepp_infer.py:313-331): the BFM mesh
        rasterised with NCC vertex colours where `BFM_model_front.mat` is in
        `bfm_dir` (`data/bfm_render.py:SECCRenderer`), else an NCC-coloured
        splat of the driven key points (`data/secc.py`)."""
        from genefaceplusplus_tpu_torch.data.secc import ncc_colors, render_secc

        if self._secc_renderer is _UNSET:
            self._secc_renderer = None
            mat = os.path.join(self.bfm_dir, "BFM_model_front.mat")
            if os.path.exists(mat):
                from scipy.io import loadmat

                from genefaceplusplus_tpu_torch.data.bfm_render import SECCRenderer

                m = loadmat(mat)
                mean_shape = m["meanshape"].reshape(-1, 3).astype(np.float32)
                mean_shape -= mean_shape.mean(0, keepdims=True)
                self._secc_renderer = SECCRenderer(mean_shape, m["idBase"].astype(np.float32),
                                                   m["exBase"].astype(np.float32),
                                                   m["tri"].astype(np.int64) - 1, size=size)
        idc, exp = batch["id_coeff"][i], batch["exp"][i]
        euler, trans = batch["eulers"][i], batch["transs"][i]
        if self._secc_renderer is not None:
            _, secc = self._secc_renderer.render(idc, exp, euler, trans)
            return ((secc * 0.5 + 0.5) * 255).astype(np.uint8)
        lm3d_cam = self.face3d_helper.reconstruct_key_lm3d(
            self._tensor(idc[None]), self._tensor(exp[None]), self._tensor(euler[None]),
            self._tensor(trans[None]))[0].cpu().numpy()
        cano = self.face3d_helper.key_mean_shape.cpu().numpy()
        return render_secc(lm3d_cam, ncc_colors(cano), size=size, splat=max(2, size // 128))

    def debug_panel(self, batch: Mapping[str, Any], i: int, frame: np.ndarray) -> np.ndarray:
        """frame | SECC | lm68 overlay, side by side (the reference's debug
        layout, genefacepp_infer.py:313-331, 489-495): [S, 3S, 3] uint8."""
        from genefaceplusplus_tpu_torch.data.visualization import draw_landmarks, side_by_side

        size = frame.shape[0]
        panel = draw_landmarks(np.zeros_like(frame), batch["lm68"][i], color=(64, 255, 64),
                               radius=max(1, size // 128))
        return side_by_side(frame, self.secc_debug_frame(batch, i, size), panel)

    def infer_once(self, inp: Mapping[str, Any]) -> str:
        """One request, features to a video file: `prepare_batch_from_inp`,
        `forward_audio2secc`, then the frames written with the request's
        16 kHz audio (`batch['wav16k']`) as `video_path(out_name)` says: an
        `.mp4` as H.264 + PCM mp4, each launched chunk encoded on the
        device before anything is copied (only the bitstream reaches the
        host; the plain encoder on the CPU), an `.avi` as an uncompressed
        AVI 2.0 of the frames of `forward_secc2video`. With `debug` each
        frame is written as `debug_panel` (three times as wide; the
        rendered frame unchanged in the first panel), composed on the host
        and, for an mp4, encoded on the device. Returns the path written. A
        clip past the file's capacity raises before its first frame is
        rendered."""
        inp = default_inp(**inp)
        batch = self.prepare_batch_from_inp(inp)
        batch = self.forward_audio2secc(batch, inp)
        path, kind = video_path(inp["out_name"])
        debug = bool(inp.get("debug", False))
        up = 2 if self.sr_model is not None else 1
        T, H, W = int(batch["T"]), up * self.dataset.H, (3 if debug else 1) * up * self.dataset.W
        if kind == "mp4":
            mp4_bytes(T, H, W, len(batch["wav16k"]))  # raises past the capacity
            writer = Mp4Writer(path, fps=25, audio=batch["wav16k"], device=self.device)
        else:
            writer = StreamingVideoWriter(path, fps=25, audio=batch["wav16k"])
            avi_bytes(T, H, W, len(batch["wav16k"]), segment_bytes=writer.segment_bytes)
        if kind == "mp4" and not debug:
            for imgs, _, _ in self.watch_crop(self.launch_all(batch, inp)):
                writer.append_chunk(imgs)
        else:
            for i, frame in enumerate(self.forward_secc2video(batch, inp)):
                writer.append(self.debug_panel(batch, i, frame) if debug else frame)
        return writer.close()


def _seed() -> torch.Generator:
    """The initial weights of a work dir without a checkpoint."""
    return torch.Generator().manual_seed(0)


def _restore(model: torch.nn.Module, newest, work_dir: str, sub: Optional[str],
             label: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """`model`'s state dict with the tensors of `newest` (the work dir's
    newest (checkpoint, path)), its `sub` tree, matched by name and shape;
    `label` names the model in messages (default: `sub`)."""
    template = model.state_dict()
    ckpt, path = newest
    if ckpt is None:
        print(f"| {work_dir}: no checkpoint; the {label or sub} keeps the port's initial weights (seed 0)")
        return template
    loaded = {k: arr for k, (_, arr) in flax_leaves(unwrap_train_state(ckpt, sub)).items()}
    state, restored = restore_into(template, loaded)
    n = sum(not k.endswith("num_batches_tracked") for k in template)
    if not restored:
        raise ValueError(f"checkpoint at {path} matched no parameters (sub={sub}); 0/{n} tensors restored")
    if len(restored) < n:
        print(f"| ckpt {path} (sub={sub}): {len(restored)}/{n} tensors restored ({n - len(restored)} kept "
              "at the port's init: unmatched)")
    return state
