"""Volume rendering of a ray batch, full-slot (port of
`genefaceplusplus_tpu/models/renderer.py`).

near/far slab -> march -> field on all R*S sample slots -> masked composite
with T_thresh -> background blend. The march is the interval marcher (with
the probe prepass where `entry_mode` is 'probe'; the serving default) or,
with `march_mode` 'grid', the reference's per-cell occupancy test over
`num_coarse` lattice points a ray.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from genefaceplusplus_tpu_torch.ops import composite as composite_ops
from genefaceplusplus_tpu_torch.ops import raymarch


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render hyper-parameters: the JAX fields and defaults. `color_topk >
    0` and `0 < compact_frac < 1` are default-off approximations not ported
    yet (ROADMAP queue A item 4), and raise."""

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


def render_rays(field_fn, rays_o, rays_d, occupancy, bound: float, min_near: float,
                bg_color, opts: RenderOptions, noise: Optional[torch.Tensor] = None,
                image_hw: Optional[tuple] = None) -> RenderOutput:
    """Render rays [R, 3] through `field_fn(xyz [M,3], dirs [M,3]) ->
    (sigma [M], rgb [M,3], amb [M,D])`, which closes over the per-frame
    condition. `noise` [R] in [0, 1) perturbs the sample lattice (training);
    `image_hw` enables `entry_mode='probe'`."""
    if 0 < opts.color_topk < opts.num_samples:
        raise NotImplementedError("color_topk is not ported (ROADMAP queue A item 4)")
    if 0.0 < opts.compact_frac < 1.0:
        raise NotImplementedError("compact_frac is not ported (ROADMAP queue A item 4)")
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
