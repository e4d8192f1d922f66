"""Volume rendering of a ray batch (port of
`genefaceplusplus_tpu/models/renderer.py`).

near/far slab -> march -> field on the R*S sample slots -> masked composite
with T_thresh -> background blend. The march is the interval marcher (with
the probe prepass where `entry_mode` is 'probe'; the serving default) or,
with `march_mode` 'grid', the reference's per-cell occupancy test over
`num_coarse` lattice points a ray.

Two options cut the field's work, both off by default:

- `compact_frac` f in (0, 1): the field runs on a buffer of
  M = min(N, max(512, ceil512(f * N))) slots (N = R*S) that holds the live
  (marcher-mask) samples in flat order, and its outputs are scattered back
  to their N slots. M is a function of f and N only, so a frame reads
  nothing back to the host. Exact while the live count fits M; past it
  the flat-order tail is dropped.
- `color_topk` K in (0, S), with `sigma_fn` and `color_fn` given: the
  geometry runs on all S samples, the colour only on the K of highest
  composite weight a ray, and the image is renormalised by the weight
  those K capture.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from genefaceplusplus_tpu_torch.ops import composite as composite_ops
from genefaceplusplus_tpu_torch.ops import raymarch


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render hyper-parameters: the JAX fields and defaults (the module
    docstring says what `color_topk` and `compact_frac` do)."""

    max_steps: int = 16  # sets the lattice's dt_min
    num_coarse: int = 48  # lattice points examined a ray ('grid' mode)
    num_samples: int = 16
    dt_gamma: float = 0.00390625  # 1/256 ('grid' mode's step growth)
    T_thresh: float = 1e-4
    march_mode: str = "interval"  # 'interval' | 'grid'
    entry_mode: str = "aabb"
    probe_stride: int = 4
    probe_coarse_factor: int = 4
    n_probe: int = 32
    color_topk: int = 0
    compact_frac: float = 0.0
    perturb: bool = False  # training: the caller passes `noise` to render_rays


class RenderOutput(NamedTuple):
    rgb_map: torch.Tensor  # [R, 3] composited over bg
    depth_map: torch.Tensor  # [R]
    weights_sum: torch.Tensor  # [R]
    ambient_sum: torch.Tensor  # [R]
    weights: torch.Tensor  # [R, S]
    ambient_pos: torch.Tensor  # [R*S, D_amb]
    head_image: torch.Tensor  # [R, 3] before the background


def make_aabb(bound: float, device=None) -> torch.Tensor:
    """Face-shaped AABB: y half-height."""
    return torch.tensor([-bound, -bound / 2, -bound, bound, bound / 2, bound],
                        dtype=torch.float32, device=device)


def compact_slots(mask, compact_frac: float):
    """The live-sample compaction of `compact_frac` for the march mask
    [R, S]: (src [M], rank [N], dest [M]).

    Slot j of the compact buffer evaluates sample src[j]: the j-th live
    sample in flat order, or sample 0 where fewer than M are live (the pad
    slots). rank [N] is each sample's position among the live ones.
    dest [M] is where slot j's value goes among the N slots, or N (dropped)
    for all but the last of the slots that evaluate one sample: a sample
    written from several slots (sample 0, from the pad slots) gets its value
    once and hands its gradient back to one slot only, as JAX's
    `.at[src].set` does."""
    N = mask.numel()
    M = min(N, max(512, ((int(compact_frac * N) + 511) // 512) * 512))
    flat = mask.reshape(N)
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    slot = torch.where(flat & (rank < M), rank, torch.full_like(rank, M))  # dead/overflow -> dropped
    src = torch.zeros(M + 1, dtype=torch.int64, device=mask.device).scatter_(
        0, slot, torch.arange(N, device=mask.device))[:M]
    j = torch.arange(M, device=mask.device)
    last = torch.full((N,), -1, dtype=torch.int64, device=mask.device).scatter_reduce_(0, src, j, "amax")
    dest = torch.where(last[src] == j, src, torch.full_like(src, N))
    return src, rank, dest


def scatter_slots(vals, dest, n: int):
    """The compact buffer's values [M, ...] in their n slots (zeros where
    nothing is written); the gradient of slot i goes to the one entry of
    `dest` that names it."""
    out = vals.new_zeros((n + 1,) + tuple(vals.shape[1:]))
    return out.index_copy(0, dest, vals)[:n]


def render_rays(field_fn, rays_o, rays_d, occupancy, bound: float, min_near: float,
                bg_color, opts: RenderOptions, noise: Optional[torch.Tensor] = None,
                image_hw: Optional[tuple] = None, sigma_fn=None, color_fn=None) -> RenderOutput:
    """Render rays [R, 3] through `field_fn(xyz [M,3], dirs [M,3]) ->
    (sigma [M], rgb [M,3], amb [M,D])`, which closes over the per-frame
    condition. `noise` [R] in [0, 1) perturbs the sample lattice (training);
    `image_hw` enables `entry_mode='probe'`. `sigma_fn(xyz) -> (sigma,
    geo_feat, amb)` and `color_fn(geo_feat, dirs) -> rgb`, the split field
    (`RADNeRF.field_sigma` / `field_color` closures), enable `color_topk`;
    without them it is ignored."""
    R = rays_o.shape[0]
    S = opts.num_samples
    aabb = make_aabb(bound, device=rays_o.device)
    nears, fars = raymarch.near_far_from_aabb(rays_o, rays_d, aabb, min_near)

    if opts.march_mode == "interval":
        occ_box = raymarch.occupancy_aabb(occupancy, bound)
        t_entry = t_exit = None
        if opts.entry_mode == "probe" and image_hw is not None:
            t_entry, t_exit = raymarch.entry_exit_depth_map(
                rays_o, rays_d, occupancy, occ_box, bound, image_hw,
                stride=opts.probe_stride, coarse_factor=opts.probe_coarse_factor,
                n_probe=opts.n_probe, min_near=min_near)
        m = raymarch.march_rays_interval(
            rays_o, rays_d, nears, fars, occ_box, bound=bound, max_steps=opts.max_steps,
            num_samples=S, noise=noise, min_near=min_near, grid_size=occupancy.shape[0],
            t_entry=t_entry, t_exit=t_exit)
    else:  # JAX takes any other mode for 'grid'
        m = raymarch.march_rays(rays_o, rays_d, nears, fars, occupancy, bound=bound, dt_gamma=opts.dt_gamma,
                                max_steps=opts.max_steps, num_coarse=opts.num_coarse, num_samples=S,
                                noise=noise)

    N = R * S
    xyz = m.xyzs.reshape(N, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(N, 3)
    src = None
    if 0.0 < opts.compact_frac < 1.0:
        src, rank, dest = compact_slots(m.mask, opts.compact_frac)

    K = opts.color_topk
    if 0 < K < S and sigma_fn is not None and color_fn is not None:
        if src is not None:
            sigma_c, geo_c, amb_c = sigma_fn(xyz[src])
            sigma = scatter_slots(sigma_c, dest, N).reshape(R, S)
            ambient_pos = scatter_slots(amb_c, dest, N)
        else:
            sigma, geo_feat, ambient_pos = sigma_fn(xyz)
            sigma = sigma.reshape(R, S)
        amb_abs = ambient_pos.abs().sum(-1).reshape(R, S)
        w_full, keep = composite_ops.composite_weights(sigma, m.deltas, m.mask, T_thresh=opts.T_thresh)
        # jax.lax.top_k's order: ties go to the lower index first
        w_sorted, order = torch.sort(w_full, dim=-1, descending=True, stable=True)
        w_k, idx_k = w_sorted[:, :K], order[:, :K]
        if src is not None:
            # a picked sample with weight > 0 is live, so rank[] is its compact
            # slot; a zero-weight pick reads some finite row that w_k kills
            n_flat = (torch.arange(R, device=idx_k.device)[:, None] * S + idx_k).reshape(-1)
            geo_k = geo_c[rank[n_flat].clamp(0, src.shape[0] - 1)]
        else:
            geo_k = torch.gather(geo_feat.reshape(R, S, -1), 1,
                                 idx_k[..., None].expand(R, K, geo_feat.shape[-1])).reshape(R * K, -1)
        dirs_k = rays_d[:, None, :].expand(R, K, 3).reshape(R * K, 3)
        rgb_k = color_fn(geo_k, dirs_k).reshape(R, K, 3)
        weights_sum = w_full.sum(dim=-1)
        capture = w_k.sum(dim=-1)
        scale = torch.where(capture > 1e-8, weights_sum / torch.clamp(capture, min=1e-8),
                            torch.zeros_like(capture))
        comp = composite_ops.CompositeResult(
            weights_sum=weights_sum, ambient_sum=(amb_abs * keep).sum(dim=-1),
            depth=(w_full * m.ts).sum(dim=-1),
            image=(w_k[..., None] * rgb_k).sum(dim=-2) * scale[..., None], weights=w_full)
    else:
        if src is not None:
            sigma_c, rgb_c, amb_c = field_fn(xyz[src], dirs[src])
            sigma = scatter_slots(sigma_c, dest, N)
            rgb = scatter_slots(rgb_c, dest, N)
            ambient_pos = scatter_slots(amb_c, dest, N)
        else:
            sigma, rgb, ambient_pos = field_fn(xyz, dirs)
        amb_abs = ambient_pos.abs().sum(-1).reshape(R, S)
        comp = composite_ops.composite_rays(
            sigma.reshape(R, S), rgb.reshape(R, S, 3), amb_abs, m.deltas, m.ts, m.mask,
            T_thresh=opts.T_thresh)

    image = composite_ops.blend_background(comp.image, comp.weights_sum, bg_color)
    depth = composite_ops.normalize_depth(comp.depth, nears, fars)
    return RenderOutput(rgb_map=image, depth_map=depth, weights_sum=comp.weights_sum,
                        ambient_sum=comp.ambient_sum, weights=comp.weights,
                        ambient_pos=ambient_pos, head_image=comp.image)
