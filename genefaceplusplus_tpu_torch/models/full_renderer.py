"""Full-frame renderer, head-only branch (port of
`genefaceplusplus_tpu/models/full_renderer.py`: `head_crop_offset`,
`auto_head_bbox`, `auto_head_crop` and `render_full_frame` without torso or
SR; those arrive with ROADMAP's torso + SR item).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.ops.raymarch import near_far_from_aabb, occupancy_aabb


def head_crop_offset(rays_o, rays_d, occ_aabb, image_hw: tuple, crop_hw: tuple,
                     min_near: float = 0.05):
    """Top-left (row, col) of a crop_hw window covering every ray that
    intersects the occupied AABB, clamped inside the image, and `fits`
    (the hit extent fits the crop). Returned as 0-d tensors."""
    H, W = image_hw
    ch, cw = crop_hw
    n2, f2 = near_far_from_aabb(rays_o, rays_d, occ_aabb, min_near)
    hit = (f2 > n2).reshape(H, W)
    rows = hit.any(dim=1)
    cols = hit.any(dim=0)
    ridx = torch.arange(H, dtype=torch.int64, device=hit.device)
    cidx = torch.arange(W, dtype=torch.int64, device=hit.device)
    big = 10 ** 6
    r_min = torch.where(rows, ridx, torch.full_like(ridx, big)).amin()
    r_max = torch.where(rows, ridx, torch.full_like(ridx, -1)).amax()
    c_min = torch.where(cols, cidx, torch.full_like(cidx, big)).amin()
    c_max = torch.where(cols, cidx, torch.full_like(cidx, -1)).amax()
    any_hit = rows.any()
    r0 = torch.clamp(torch.div(r_min + r_max + 1 - ch, 2, rounding_mode="floor"), 0, H - ch)
    c0 = torch.clamp(torch.div(c_min + c_max + 1 - cw, 2, rounding_mode="floor"), 0, W - cw)
    r0 = torch.where(any_hit, r0, torch.zeros_like(r0))
    c0 = torch.where(any_hit, c0, torch.zeros_like(c0))
    fits = (r_max - r_min < ch) & (c_max - c_min < cw)
    return r0, c0, fits


def auto_head_bbox(occupancy, poses, intrinsics, H: int, W: int, bound: float = 1.0):
    """(r_lo, r_hi, c_lo, c_hi) screen bbox of the occupied AABB's projection
    across every pose, or None when degenerate. Host-side, once at load."""
    occ = torch.as_tensor(occupancy)
    if not bool(occ.any()):
        return None
    box = occupancy_aabb(occ, bound).cpu().numpy()
    corners = np.stack(np.meshgrid(box[[0, 3]], box[[1, 4]], box[[2, 5]], indexing="ij"),
                       axis=-1).reshape(8, 3)
    fx, fy, cx, cy = intrinsics
    poses = np.asarray(poses).reshape(-1, 4, 4)
    r_lo, r_hi, c_lo, c_hi = H, 0.0, W, 0.0
    for pose in poses:
        R, t = pose[:3, :3], pose[:3, 3]
        cam = (corners - t) @ R
        z = cam[:, 2]
        if np.any(z <= 1e-3):
            return None  # the box reaches behind the camera: keep the full frame
        col = cx + fx * cam[:, 0] / z
        row = cy + fy * cam[:, 1] / z
        r_lo, r_hi = min(r_lo, row.min()), max(r_hi, row.max())
        c_lo, c_hi = min(c_lo, col.min()), max(c_hi, col.max())
    return (r_lo, r_hi, c_lo, c_hi)


def auto_head_crop(occupancy, poses, intrinsics, H: int, W: int, bound: float = 1.0,
                   pad_px: int = 12, multiple: int = 16, max_area_frac: float = 0.85,
                   bbox=None):
    """Crop (ch, cw) covering the occupied AABB's projection across every
    pose, padded and rounded up; None when cropping would not pay."""
    if bbox is None:
        bbox = auto_head_bbox(occupancy, poses, intrinsics, H, W, bound)
    if bbox is None:
        return None
    r_lo, r_hi, c_lo, c_hi = bbox
    ch = int(np.clip(r_hi - r_lo, 0, H) + 2 * pad_px)
    cw = int(np.clip(c_hi - c_lo, 0, W) + 2 * pad_px)
    ch = min(H, int(np.ceil(ch / multiple)) * multiple)
    cw = min(W, int(np.ceil(cw / multiple)) * multiple)
    if ch * cw >= max_area_frac * H * W:
        return None
    return (ch, cw)


class FrameOutput(NamedTuple):
    rgb_map: torch.Tensor  # [H*W, 3] composited image
    depth_map: torch.Tensor  # [H*W]
    weights_sum: torch.Tensor  # [H*W]
    head_crop_fits: Optional[torch.Tensor] = None  # 0-d bool, or None without a crop


def render_full_frame(head_model: RADNeRF, rays_o, rays_d, cond_window, occupancy,
                      bg_color, opts: RenderOptions, image_hw: tuple,
                      eye_area_percent=None, index=0, head_crop: Optional[tuple] = None,
                      field_weights: Optional[ff.FieldWeights] = None,
                      fused_fn=ff.fused_field) -> FrameOutput:
    """One head-only frame: the head composited over `bg_color`.

    With `field_weights` (from `fused_field.weights_from_params`) the field
    is `fused_fn` (`fused_field`, or `fused_field_plain` to compare) with
    the frame's bias rows computed once; without, it is `RADNeRF.field`.
    With `head_crop` the head renders on a (ch, cw) window at a per-frame
    offset and is pasted into a zero canvas (lossless while the window
    covers the hit set). The offset is read to the host once per frame to
    slice the rays."""
    cfg = head_model.cfg
    cond_feat = head_model.cal_cond_feat(cond_window, eye_area_percent)
    ind_code = head_model.get_individual_code(index)
    if field_weights is None:
        def field_fn(xyz, dirs):
            return head_model.field(xyz, dirs, cond_feat, ind_code)
    else:
        amb_bias, col_bias = ff.bias_rows(cond_feat, ind_code, field_weights)

        def field_fn(xyz, dirs):
            return fused_fn(xyz, dirs, amb_bias, col_bias, field_weights,
                            amb_dim=cfg.ambient_coord_dim)

    H, W = image_hw
    crop_fits = None
    if head_crop is not None and tuple(head_crop) != (H, W):
        ch, cw = head_crop
        occ_box = occupancy_aabb(occupancy, cfg.bound)
        r0, c0, crop_fits = head_crop_offset(rays_o, rays_d, occ_box, image_hw, head_crop, cfg.min_near)
        r0, c0 = int(r0), int(c0)  # host sync: the slice needs the offset
        ro_c = rays_o.reshape(H, W, 3)[r0:r0 + ch, c0:c0 + cw].reshape(-1, 3)
        rd_c = rays_d.reshape(H, W, 3)[r0:r0 + ch, c0:c0 + cw].reshape(-1, 3)
        out = render_rays(field_fn, ro_c, rd_c, occupancy, bound=cfg.bound,
                          min_near=cfg.min_near, bg_color=0.0, opts=opts, image_hw=(ch, cw))

        def paste(a, c):
            canvas = torch.zeros((H, W, c), dtype=a.dtype, device=a.device)
            canvas[r0:r0 + ch, c0:c0 + cw] = a.reshape(ch, cw, c)
            return canvas.reshape(H * W, c)

        head_image = paste(out.head_image, 3)
        weights_sum = paste(out.weights_sum[:, None], 1)[:, 0]
        depth_map = paste(out.depth_map[:, None], 1)[:, 0]
    else:
        out = render_rays(field_fn, rays_o, rays_d, occupancy, bound=cfg.bound,
                          min_near=cfg.min_near, bg_color=0.0, opts=opts, image_hw=image_hw)
        head_image, weights_sum, depth_map = out.head_image, out.weights_sum, out.depth_map
    image = torch.clamp(head_image + (1.0 - weights_sum)[..., None] * bg_color, 0.0, 1.0)
    return FrameOutput(rgb_map=image, depth_map=depth_map, weights_sum=weights_sum,
                       head_crop_fits=crop_fits)
