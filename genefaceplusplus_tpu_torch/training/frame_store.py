"""Device-resident per-frame store for the training tasks (port of
`genefaceplusplus_tpu/training/frame_store.py`): batches are gathered on
the device from it, so a step moves only the sampled indices.

  * `quantize_u8` — the uint8 storage quantisation, bit-identical to the
    dataset's image cache, so device-gathered gt equals host-loaded gt.
  * `device_cond_window` — the smoothing-window gather over the full
    timeline (`RADNeRFDataset.frame_cond_window` semantics).
  * `base_device_frames` — the entries every task needs
    (gt/poses/conds_all/frame_ids/eye).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.rays import pixel_rays


def quantize_u8(img) -> np.ndarray:
    """Image -> uint8, matching the dataset's cache quantisation."""
    img = np.asarray(img)[..., :3]
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def base_device_frames(ds, device=None) -> Dict[str, torch.Tensor]:
    """Per-frame gt (uint8), poses, the full condition timeline, frame ids
    and eye-area percents, on `device`."""
    gt_l, pose_l = [], []
    for i in range(len(ds)):
        gt = ds.load_image(i, "gt")
        gt_l.append(quantize_u8(ds.bg_img if gt is None else gt))
        pose_l.append(ds.frame_pose(i))
    return {
        "gt": torch.from_numpy(np.stack(gt_l)).to(device),
        "poses": torch.from_numpy(np.stack(pose_l).astype(np.float32)).to(device),
        "conds_all": torch.from_numpy(np.asarray(ds.conds_all, np.float32)).to(device),
        "frame_ids": torch.from_numpy(np.asarray(ds.frame_ids, np.int64)).to(device),
        "eye": torch.from_numpy(np.asarray(ds.eye_area_percents, np.float32)).to(device),
    }


def device_cond_window(frames: Dict, idx, smo: int, T_all: int) -> torch.Tensor:
    """Condition smoothing window [smo, cond_win, C] for frame `idx`, from
    the device-resident timeline; equivalent to
    `RADNeRFDataset.frame_cond_window`."""
    g = frames["frame_ids"][idx]
    rel = torch.arange(smo, device=g.device) - smo // 2
    offs = torch.clamp(g + rel, 0, T_all - 1)
    valid = ((g + rel) >= 0) & ((g + rel) < T_all)
    return frames["conds_all"][offs] * valid[:, None, None]


def device_frame_rays(frames: Dict, idx, intr, H: int, W: int,
                      inds: Optional[torch.Tensor] = None):
    """Rays [N, 3] of frame `idx` from the pose store; `inds` selects a
    pixel subset, None renders the full frame."""
    sel = None if inds is None else inds[None]
    rays_o, rays_d = pixel_rays(frames["poses"][idx][None], intr, H, W, sel)
    return rays_o[0], rays_d[0]
