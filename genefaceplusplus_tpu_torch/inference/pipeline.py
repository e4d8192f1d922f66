"""Serving: the render half of `GeneFaceInfer` (port of
`genefaceplusplus_tpu/inference/pipeline.py`, head-only, GT-driven).

A request is a driven condition track, the batch `forward_audio2secc`
would produce: poses [T,4,4], the normalised landmark condition [T,1,204]
and eye areas [T,1]. `prepare_gt_batch` fills it from the dataset's own
landmarks. `forward_secc2video` renders it with the production options
(probe entry, 10 samples per ray, T_thresh 1e-2) through the fused field,
`frames_per_dispatch` frames per chunk, quantises each chunk to uint8 on
the device and copies one chunk at a time to the host.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.models.full_renderer import (
    auto_head_bbox, auto_head_crop, render_full_frame)
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
from genefaceplusplus_tpu_torch.utils.device import resolve_device
from genefaceplusplus_tpu_torch.utils.rays import pixel_rays


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
    """Head-only renderer for one identity.

    cfg: the head config; params: a `RADNeRF` state_dict (random init, or
    converted from a JAX checkpoint by `utils.convert_jax`); dataset: the
    identity's poses, condition statistics and background; occupancy:
    [G,G,G] bool density grid. Everything lives on `device`: the CUDA card
    unless another device is named (raises when there is no card)."""

    def __init__(self, cfg: RADNeRFConfig, params: Mapping[str, torch.Tensor],
                 dataset: RADNeRFDataset, occupancy, device=None):
        self.device = resolve_device(device)
        self.head_cfg = cfg
        self.head_model = RADNeRF(cfg)
        self.head_model.load_state_dict(params)
        self.head_model.to(self.device).eval()
        self.field_weights = ff.weights_from_params(self.head_model, bound=cfg.bound)
        self.dataset = dataset
        self.occupancy = torch.as_tensor(occupancy, dtype=torch.bool).to(self.device)
        self.bg_color = torch.as_tensor(dataset.bg_img.reshape(-1, 3), dtype=torch.float32).to(self.device)
        self.head_crop = self._auto_head_crop()

    def _auto_head_crop(self):
        """Crop (ch, cw) covering the occupied AABB's projection across every
        dataset pose, or None when cropping would not pay. Re-run after
        replacing `occupancy`."""
        ds = self.dataset
        poses = np.stack([ds.frame_pose(i) for i in range(len(ds))])
        self._head_bbox = auto_head_bbox(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                                         bound=self.head_cfg.bound)
        return auto_head_crop(self.occupancy, poses, ds.intrinsics, ds.H, ds.W,
                              bound=self.head_cfg.bound, bbox=self._head_bbox)

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

    @torch.no_grad()
    def forward_secc2video(self, batch: Mapping[str, Any],
                           inp: Optional[Mapping[str, Any]] = None) -> Iterator[np.ndarray]:
        """Yield the batch's frames as uint8 [H, W, 3] arrays, rendered
        through the fused field."""
        inp = dict(inp or {})
        ds, dev = self.dataset, self.device
        H, W = ds.H, ds.W
        T = int(batch["T"])
        opts = self.render_options(inp)
        chunk = max(1, min(int(inp.get("frames_per_dispatch", 8)), T))
        head_crop = resolve_crop(inp, "head_crop", self.head_crop)

        conds = torch.as_tensor(np.asarray(batch["cond"]), dtype=torch.float32, device=dev)
        cond_windows = get_audio_features_batch(
            conds, torch.arange(T, device=dev), self.head_cfg.smo_win_size)
        eye_areas = torch.as_tensor(np.asarray(batch["eye_area_percent"]),
                                    dtype=torch.float32, device=dev).reshape(T, 1)
        poses_all = torch.as_tensor(np.asarray(batch["poses"]), dtype=torch.float32, device=dev)
        crop_misses = 0
        for start in range(0, T, chunk):
            n = min(chunk, T - start)
            rays_o, rays_d = pixel_rays(poses_all[start:start + n], ds.intrinsics, H, W)
            imgs = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
            for j in range(n):
                out = render_full_frame(
                    self.head_model, rays_o[j], rays_d[j], cond_windows[start + j],
                    self.occupancy, self.bg_color, opts, (H, W),
                    eye_area_percent=eye_areas[start + j], index=0,
                    head_crop=head_crop, field_weights=self.field_weights)
                imgs[j] = (torch.clamp(out.rgb_map, 0.0, 1.0) * 255.0).to(torch.uint8).reshape(H, W, 3)
                if out.head_crop_fits is not None:
                    crop_misses += int(not bool(out.head_crop_fits))
            yield from imgs.cpu().numpy()
        if crop_misses:
            print(f"| WARNING: head exceeded the auto head-crop window on {crop_misses}/{T} "
                  "frames (driving poses outside the dataset envelope); rerun with "
                  "head_crop='off' for these poses")
