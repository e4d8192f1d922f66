"""Serving: the render half of `GeneFaceInfer` (port of
`genefaceplusplus_tpu/inference/pipeline.py`, GT-driven).

A request is a driven condition track, the batch `forward_audio2secc`
would produce: poses [T,4,4], the normalised landmark condition [T,1,204],
eye areas [T,1] and 2D landmarks lm68 [T,68,2]. `prepare_gt_batch` fills
it from the dataset's own landmarks. `forward_secc2video` renders it with
the production options (probe entry, 10 samples per ray, T_thresh 1e-2)
through the fused field, [the torso field composited behind the head, the
2x SR,] `frames_per_dispatch` frames per chunk, quantises each chunk to
uint8 on the device and copies one chunk at a time to the host.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.models.full_renderer import (
    auto_head_bbox, auto_head_crop, auto_sr_crop, auto_torso_crop, render_full_frame)
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
from genefaceplusplus_tpu_torch.utils.device import resolve_device
from genefaceplusplus_tpu_torch.utils.rays import get_bg_coords, pixel_rays


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
    """Renderer for one identity: the head [+ torso] [+ SR].

    cfg: the head config; params: a `RADNeRF` state_dict (random init, or
    converted from a JAX checkpoint by `utils.convert_jax`); dataset: the
    identity's poses, condition statistics and background (built with
    `with_sr=True` for an SR identity: SR doubles its render size);
    occupancy: [G,G,G] bool density grid. The torso renders when
    `torso_cfg` is given, from `torso_params` (a `TorsoField` state_dict),
    culled by `torso_occupancy_2d` [G2, G2] where given; SR runs when
    `sr_params` (a `Superresolution` state_dict, its `noise_const` buffers
    included) is given, in `sr_dtype` (bfloat16, the production `sr_dtype`,
    or float32). Everything lives on `device`: the CUDA card unless another
    device is named (raises when there is no card)."""

    def __init__(self, cfg: RADNeRFConfig, params: Mapping[str, torch.Tensor],
                 dataset: RADNeRFDataset, occupancy, device=None, *,
                 torso_cfg: Optional[TorsoConfig] = None,
                 torso_params: Optional[Mapping[str, torch.Tensor]] = None,
                 torso_occupancy_2d=None, sr_params: Optional[Mapping[str, torch.Tensor]] = None,
                 sr_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.head_cfg = cfg
        self.head_model = RADNeRF(cfg)
        self.head_model.load_state_dict(params)
        self.head_model.to(self.device).eval()
        self.field_weights = ff.weights_from_params(self.head_model, bound=cfg.bound)
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
        self.head_crop = self._auto_head_crop()
        # the torso's footprint is static in screen space: one rect at load,
        # at the render-time mask threshold (the mean density is 0 here)
        self.torso_crop = None
        if self.torso_model is not None and self.torso_occupancy_2d is not None:
            self.torso_crop = auto_torso_crop(self.torso_occupancy_2d, dataset.H, dataset.W,
                                              thr=torso_cfg.density_thresh_torso)
        self.sr_crop, self.sr_bg = self._auto_sr_crop()

    def _auto_head_crop(self):
        """Crop (ch, cw) covering the occupied AABB's projection across every
        dataset pose, or None when cropping would not pay. Re-run after
        replacing `occupancy` (then `_auto_sr_crop`, which reuses its bbox)."""
        ds = self.dataset
        poses = np.stack([ds.frame_pose(i) for i in range(len(ds))])
        self._head_bbox = auto_head_bbox(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                                         bound=self.head_cfg.bound)
        return auto_head_crop(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                              bound=self.head_cfg.bound, bbox=self._head_bbox)

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
        """The production options (probe entry, S=10, T_thresh 1e-2)."""
        return RenderOptions(
            num_samples=int(inp.get("num_samples", 10)),
            T_thresh=float(inp.get("T_thresh", 1e-2)),
            entry_mode=str(inp.get("entry_mode", "probe")),
            color_topk=int(inp.get("color_topk", 0)),
            compact_frac=float(inp.get("compact_frac", 0.0)),
        )

    def render_frame(self, rays_o, rays_d, cond_window, eye_area_percent, lm68,
                     inp: Optional[Mapping[str, Any]] = None, fused_fn=ff.fused_field):
        """One frame through `render_full_frame` with this identity's models,
        grids and load-time crops (each overridable in `inp` as 'auto',
        'off' or a rect). Returns its FrameOutput."""
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
            sr_crop=sr_crop, sr_bg=self.sr_bg if sr_crop is not None else None)

    @torch.no_grad()
    def forward_secc2video(self, batch: Mapping[str, Any],
                           inp: Optional[Mapping[str, Any]] = None) -> Iterator[np.ndarray]:
        """Yield the batch's frames as uint8 arrays, [2H, 2W, 3] with SR and
        [H, W, 3] without, rendered through the fused field."""
        inp = dict(inp or {})
        ds, dev = self.dataset, self.device
        H, W = ds.H, ds.W
        up = 2 if self.sr_model is not None else 1
        T = int(batch["T"])
        chunk = max(1, min(int(inp.get("frames_per_dispatch", 8)), T))

        conds = torch.as_tensor(np.asarray(batch["cond"]), dtype=torch.float32, device=dev)
        cond_windows = get_audio_features_batch(
            conds, torch.arange(T, device=dev), self.head_cfg.smo_win_size)
        eye_areas = torch.as_tensor(np.asarray(batch["eye_area_percent"]),
                                    dtype=torch.float32, device=dev).reshape(T, 1)
        poses_all = torch.as_tensor(np.asarray(batch["poses"]), dtype=torch.float32, device=dev)
        lm68s = torch.as_tensor(np.asarray(batch["lm68"]), dtype=torch.float32, device=dev)
        crop_misses = 0
        for start in range(0, T, chunk):
            n = min(chunk, T - start)
            rays_o, rays_d = pixel_rays(poses_all[start:start + n], ds.intrinsics, H, W)
            imgs = torch.empty((n, up * H, up * W, 3), dtype=torch.uint8, device=dev)
            for j in range(n):
                t = start + j
                out = self.render_frame(rays_o[j], rays_d[j], cond_windows[t], eye_areas[t],
                                        lm68s[t][None], inp)
                img = out.sr_rgb_map if out.sr_rgb_map is not None else out.rgb_map.reshape(H, W, 3)
                imgs[j] = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
                if out.head_crop_fits is not None:
                    crop_misses += int(not bool(out.head_crop_fits))
            yield from imgs.cpu().numpy()
        if crop_misses:
            print(f"| WARNING: head exceeded the auto head-crop window on {crop_misses}/{T} frames "
                  "(driving poses outside the dataset envelope); rerun with "
                  "head_crop='off' for these poses")
