"""Full-frame renderer: head NeRF [+ torso field] [+ 2x super-resolution]
(port of `genefaceplusplus_tpu/models/full_renderer.py`): the raw head
render, the torso composited behind it, SR to twice the raw size. The crop
helpers run on the host once at load; `render_full_frame` runs one frame.

Under a mesh (`parallel/mesh.py`) the frame stays on the main device: the
probe prepass, the head crop's offset, the march, the compaction's budget
and ranks, the compositing and the SR need all of its rays. Only the
field's points are split, the head's (fused, grid or split field) and the
torso's pixels, each block evaluated on its shard's device by that
device's replica; the outputs come back in order, so the frame is the
unsharded one up to each device's float32 summation order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
from genefaceplusplus_tpu_torch.models.radnerf_torso import (
    TorsoField, TorsoOutput, composite_head_torso, sample_occupancy_2d)
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
from genefaceplusplus_tpu_torch.ops.raymarch import near_far_from_aabb, occupancy_aabb
from genefaceplusplus_tpu_torch.parallel.mesh import Mesh, broadcast, map_blocks, replicated


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


def auto_torso_crop(occupancy_2d, H: int, W: int, thr: float = 0.01, pad_px: int = 8,
                    multiple: int = 16, max_area_frac: float = 0.9):
    """Static (r0, c0, ch, cw) screen rect holding every pixel whose 2D
    torso-occupancy sample can exceed `thr` (one grid cell of bilinear
    margin), or None when cropping would not pay. Host-side, once at load:
    the torso's culling grid does not depend on the pose. `thr` must be <=
    the render-time mask threshold, or the crop cuts real torso alpha."""
    g2 = torch.as_tensor(occupancy_2d).cpu().numpy()
    occ = g2 > thr
    if not occ.any():
        return None
    G = g2.shape[0]
    rows = np.where(occ.any(axis=1))[0]
    cols = np.where(occ.any(axis=0))[0]
    # one grid cell of bilinear margin on each side (sample_occupancy_2d)
    r_lo = max(0, rows.min() - 1) / max(G - 1, 1) * (H - 1)
    r_hi = min(G - 1, rows.max() + 1) / max(G - 1, 1) * (H - 1)
    c_lo = max(0, cols.min() - 1) / max(G - 1, 1) * (W - 1)
    c_hi = min(G - 1, cols.max() + 1) / max(G - 1, 1) * (W - 1)
    r0 = max(0, int(r_lo) - pad_px)
    c0 = max(0, int(c_lo) - pad_px)
    ch = min(H - r0, int(np.ceil((r_hi - r0 + pad_px) / multiple)) * multiple)
    cw = min(W - c0, int(np.ceil((c_hi - c0 + pad_px) / multiple)) * multiple)
    if ch * cw >= max_area_frac * H * W:
        return None
    return (r0, c0, ch, cw)


def auto_sr_crop(head_bbox, torso_rect, H: int, W: int, pad_px: int = 4, margin: int = 16,
                 multiple: int = 16, max_area_frac: float = 0.9):
    """((outer), (inner)) rects at raw resolution for cropped SR, or None.

    Outside the union of the head's all-pose screen bbox and the torso
    footprint the raw composite equals the static background exactly, so
    full-frame SR differs from the precomputed SR(bg) only within `margin`
    (>= the SR receptive field) of that union: per frame, SR only `outer`
    and paste `inner` (union + margin) into the SR(bg) canvas. Host-side,
    once at load. Pass torso_rect=(0, 0, H, W) for a torso rendered without
    2D-occupancy culling (its alpha is then unbounded)."""
    if head_bbox is None:
        return None
    r_lo, r_hi, c_lo, c_hi = head_bbox
    r0 = max(0, int(np.floor(r_lo)) - pad_px)
    r1 = min(H, int(np.ceil(r_hi)) + pad_px)
    c0 = max(0, int(np.floor(c_lo)) - pad_px)
    c1 = min(W, int(np.ceil(c_hi)) + pad_px)
    if torso_rect is not None:
        tr0, tc0, th, tw = torso_rect
        r0, c0 = min(r0, tr0), min(c0, tc0)
        r1, c1 = max(r1, tr0 + th), max(c1, tc0 + tw)
    ir0, ic0 = max(0, r0 - margin), max(0, c0 - margin)
    ir1, ic1 = min(H, r1 + margin), min(W, c1 + margin)
    er0, ec0 = max(0, ir0 - margin), max(0, ic0 - margin)
    er1, ec1 = min(H, ir1 + margin), min(W, ic1 + margin)
    eh = min(H - er0, int(np.ceil((er1 - er0) / multiple)) * multiple)
    ew = min(W - ec0, int(np.ceil((ec1 - ec0) / multiple)) * multiple)
    if eh * ew >= max_area_frac * H * W:
        return None
    return ((er0, ec0, eh, ew), (ir0, ic0, ir1 - ir0, ic1 - ic0))


def sr_apply_batched(sr_model: Superresolution, raws, sr_crop=None, sr_bg=None):
    """SR over a chunk of raw frames: [B, H, W, 3] -> [B, 2H, 2W, 3]. With
    sr_crop and sr_bg (the SR of the background, [2H, 2W, 3]) only the outer
    rect is super-resolved and its inner rect pasted into sr_bg."""
    if sr_crop is None or sr_bg is None:
        return torch.clamp(sr_model(raws), 0.0, 1.0)
    (orr, orc, oh, ow), (ir, ic, ih, iw) = sr_crop
    sr_c = sr_model(raws[:, orr:orr + oh, orc:orc + ow], noise_offset=(orr, orc))
    dy, dx = 2 * (ir - orr), 2 * (ic - orc)
    out = sr_bg.to(sr_c.dtype)[None].repeat(raws.shape[0], 1, 1, 1)
    out[:, 2 * ir:2 * (ir + ih), 2 * ic:2 * (ic + iw)] = torch.clamp(
        sr_c[:, dy:dy + 2 * ih, dx:dx + 2 * iw], 0.0, 1.0)
    return out


class FrameOutput(NamedTuple):
    rgb_map: torch.Tensor  # [H*W, 3] raw-resolution composited image
    sr_rgb_map: Optional[torch.Tensor]  # [2H, 2W, 3] super-resolved, or None
    depth_map: torch.Tensor  # [H*W]
    weights_sum: torch.Tensor  # [H*W]
    torso_alpha: Optional[torch.Tensor] = None  # [H*W, 1]
    torso_rgb: Optional[torch.Tensor] = None  # [H*W, 3] torso over background
    head_crop_fits: Optional[torch.Tensor] = None  # 0-d bool, or None without a crop


def render_full_frame(head_model: RADNeRF, rays_o, rays_d, cond_window, occupancy,
                      bg_color, opts: RenderOptions, image_hw: tuple,
                      eye_area_percent=None, index=0, head_crop: Optional[tuple] = None,
                      field_weights: Optional[ff.FieldWeights] = None,
                      fused_fn=ff.fused_field,
                      torso_model: Optional[TorsoField] = None, bg_coords=None, lm68=None,
                      occupancy_2d=None, sr_model: Optional[Superresolution] = None,
                      torso_crop: Optional[tuple] = None, sr_crop: Optional[tuple] = None,
                      sr_bg=None, density_thresh_torso: Optional[float] = None,
                      stop_head_gradient: bool = False, mesh: Optional[Mesh] = None) -> FrameOutput:
    """One frame: the head over [the torso over] `bg_color` [, then SR].

    With `field_weights` (from `fused_field.weights_from_params`) the field
    is `fused_fn` (`fused_field`, or `fused_field_plain` to compare) with
    the frame's bias rows computed once; without, it is `RADNeRF.field`.
    `opts.compact_frac` runs that field on the compact buffer;
    `opts.color_topk` runs the float32 `RADNeRF.field_sigma` and
    `field_color` instead (the top-K colour path). With `head_crop` the head renders on a (ch, cw) window at a per-frame
    offset and is pasted into a zero canvas (lossless while the window
    covers the hit set). The offset is read to the host once per frame to
    slice the rays.

    With `stop_head_gradient` the head renders without autograd (JAX's
    stop_gradient on its image and weights: the torso task trains the
    torso behind a frozen head); the torso and SR stay differentiable.

    `torso_model` needs `bg_coords` [H*W, 2] and `lm68` [1, 68, 2]; its
    alpha is masked by `occupancy_2d` [G, G] where given (at
    `density_thresh_torso`, by default the torso config's), and with
    `torso_crop` (r0, c0, ch, cw) it runs on that static rect only
    (lossless: the mask is zero outside it). `sr_model` super-resolves the
    composite; with `sr_crop` and `sr_bg` (auto_sr_crop, the SR of the
    background) only the rect that changes is super-resolved.

    With `mesh` (its main device the frame's) the field's points and the
    torso's pixels are split over the mesh's devices (module docstring)."""
    H, W = image_hw
    if mesh is not None and mesh.main != rays_o.device:
        raise ValueError(f"the mesh's main device is {mesh.main}, the frame's rays are on {rays_o.device}")
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_head_gradient):
        head_image, weights_sum, depth_map, crop_fits = _render_head(
            head_model, rays_o, rays_d, cond_window, occupancy, opts, image_hw, eye_area_percent,
            index, head_crop, field_weights, fused_fn, mesh)

    torso_alpha = torso_rgb = None
    if torso_model is not None:
        if bg_coords is None:
            raise ValueError("the torso needs bg_coords")
        thr = torso_model.cfg.density_thresh_torso if density_thresh_torso is None else density_thresh_torso
        aware = torso_model.cfg.torso_head_aware
        t_ind = torso_model.get_individual_code(index)
        if torso_crop is not None and occupancy_2d is not None and tuple(torso_crop[2:]) != (H, W):
            # the torso's footprint is static across frames: run the field on
            # the rect only; the occupancy mask zeroes alpha outside it
            tr0, tc0, tch, tcw = torso_crop

            def sel(a, c):
                return a.reshape(H, W, c)[tr0:tr0 + tch, tc0:tc0 + tcw].reshape(-1, c)

            coords = sel(bg_coords, 2)
            t_out = _torso(torso_model, coords, lm68, t_ind, sel(head_image, 3) if aware else None,
                           sel(weights_sum[:, None], 1) if aware else None, mesh)
            alpha_c = t_out.alpha * (sample_occupancy_2d(occupancy_2d, coords) > thr)[:, None]
            alpha = _paste(alpha_c, (H, W), torso_crop)
            color = _paste(t_out.color, (H, W), torso_crop)
        else:
            t_out = _torso(torso_model, bg_coords, lm68, t_ind, head_image if aware else None,
                           weights_sum[:, None] if aware else None, mesh)
            alpha, color = t_out.alpha, t_out.color
            if occupancy_2d is not None:  # 2D occupancy culling as a mask
                alpha = alpha * (sample_occupancy_2d(occupancy_2d, bg_coords) > thr)[:, None]
        image, torso_rgb = composite_head_torso(head_image, weights_sum, alpha, color, bg_color)
        torso_alpha = alpha
    else:
        image = torch.clamp(head_image + (1.0 - weights_sum)[..., None] * bg_color, 0.0, 1.0)

    sr_image = None
    if sr_model is not None:
        raw = image.reshape(1, H, W, 3)
        sr_image = sr_apply_batched(sr_model, raw, sr_crop, sr_bg)[0]
    return FrameOutput(rgb_map=image, sr_rgb_map=sr_image, depth_map=depth_map,
                       weights_sum=weights_sum, torso_alpha=torso_alpha, torso_rgb=torso_rgb,
                       head_crop_fits=crop_fits)


def _field_fns(head_model: RADNeRF, cond_feat, ind_code, field_weights, fused_fn, mesh: Optional[Mesh]):
    """The head's (field, sigma, colour) functions of the points for one
    frame's condition: the field is `fused_fn` with the frame's bias rows
    where `field_weights` is given, else the float32 `RADNeRF.field`; sigma
    and colour are the float32 split field of `opts.color_topk`, as in JAX
    (the top-K path runs no fused kernel). With `mesh` each splits its
    points over the mesh, every block evaluated by its device's replicas."""
    amb_dim = head_model.cfg.ambient_coord_dim
    if field_weights is not None:
        amb_bias, col_bias = ff.bias_rows(cond_feat, ind_code, field_weights)
    if mesh is None:
        models, consts = [head_model], [(cond_feat, ind_code)]
        if field_weights is not None:
            weights, biases = [field_weights], [(amb_bias, col_bias)]
    else:
        models, consts = replicated(mesh, head_model), broadcast(mesh, cond_feat, ind_code)
        if field_weights is not None:
            weights, biases = replicated(mesh, field_weights), broadcast(mesh, amb_bias, col_bias)

    def field_one(i, xyz, dirs):
        if field_weights is None:
            return models[i].field(xyz, dirs, *consts[i])
        return fused_fn(xyz, dirs, *biases[i], weights[i], amb_dim=amb_dim)

    def sigma_one(i, xyz):
        return models[i].field_sigma(xyz, consts[i][0])

    def color_one(i, geo_feat, dirs):
        return models[i].field_color(geo_feat, dirs, consts[i][1])

    if mesh is None:
        return (lambda *a: field_one(0, *a), lambda *a: sigma_one(0, *a), lambda *a: color_one(0, *a))
    return (lambda *a: map_blocks(mesh, field_one, *a), lambda *a: map_blocks(mesh, sigma_one, *a),
            lambda *a: map_blocks(mesh, color_one, *a))


def _torso(torso_model: TorsoField, coords, lm68, t_ind, head_rgb, head_ws, mesh: Optional[Mesh]) -> TorsoOutput:
    """`torso_model` on the pixels `coords` [, `head_rgb`, `head_ws`], the
    pixels split over `mesh` where one is given."""
    if mesh is None:
        return torso_model(coords, lm68, t_ind, head_rgb, head_ws)
    torsos, consts = replicated(mesh, torso_model), broadcast(mesh, lm68, t_ind)

    def one(i, *pixels):  # (coords[, head_rgb, head_ws]) of shard i
        return tuple(torsos[i](pixels[0], *consts[i], *pixels[1:]))

    return TorsoOutput(*map_blocks(mesh, one, *((coords,) if head_rgb is None else (coords, head_rgb, head_ws))))


def _render_head(head_model: RADNeRF, rays_o, rays_d, cond_window, occupancy, opts: RenderOptions,
                 image_hw: tuple, eye_area_percent, index, head_crop, field_weights, fused_fn,
                 mesh: Optional[Mesh] = None):
    """(head image, weights sum, depth, crop fits) of `render_full_frame`'s
    head stage, over a zero background."""
    cfg = head_model.cfg
    cond_feat = head_model.cal_cond_feat(cond_window, eye_area_percent)
    ind_code = head_model.get_individual_code(index)
    field_fn, sigma_fn, color_fn = _field_fns(head_model, cond_feat, ind_code, field_weights, fused_fn, mesh)

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
                          min_near=cfg.min_near, bg_color=0.0, opts=opts, image_hw=(ch, cw),
                          sigma_fn=sigma_fn, color_fn=color_fn)
        head_image = _paste(out.head_image, (H, W), (r0, c0, ch, cw))
        weights_sum = _paste(out.weights_sum[:, None], (H, W), (r0, c0, ch, cw))[:, 0]
        depth_map = _paste(out.depth_map[:, None], (H, W), (r0, c0, ch, cw))[:, 0]
    else:
        out = render_rays(field_fn, rays_o, rays_d, occupancy, bound=cfg.bound,
                          min_near=cfg.min_near, bg_color=0.0, opts=opts, image_hw=image_hw,
                          sigma_fn=sigma_fn, color_fn=color_fn)
        head_image, weights_sum, depth_map = out.head_image, out.weights_sum, out.depth_map

    return head_image, weights_sum, depth_map, crop_fits


def _paste(a, image_hw: tuple, rect: tuple):
    """a [ch*cw, c] into a zero [H*W, c] canvas at rect (r0, c0, ch, cw)."""
    H, W = image_hw
    r0, c0, ch, cw = rect
    c = a.shape[-1]
    canvas = torch.zeros((H, W, c), dtype=a.dtype, device=a.device)
    canvas[r0:r0 + ch, c0:c0 + cw] = a.reshape(ch, cw, c)
    return canvas.reshape(H * W, c)
