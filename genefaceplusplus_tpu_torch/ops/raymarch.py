"""Interval ray marching with the probe entry/exit prepass (port of the
interval path of `genefaceplusplus_tpu/ops/raymarch.py`).

Ported: `near_far_from_aabb`, `occupancy_lookup`, `occupancy_aabb`,
`coarsen_occupancy`, `probe_entry_exit`, `entry_exit_depth_map` and
`march_rays_interval` (with training's `noise`). The grid-mode marcher and
the entry-only probe are on neither the serving nor the training path
(ROADMAP queue A, items 2 and 7).

Conversions from JAX: `lax.reduce_window` SAME 3x3 max is
`max_pool2d(3, 1, padding=1)`; the ones-kernel dilation conv is
`max_pool3d(3, 1, padding=1)`; `argmax` over a bool array is an argmax over
its integer cast, which keeps first-occurrence semantics.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

SQRT3 = math.sqrt(3.0)


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.05):
    """Ray/AABB slab test. rays_o/d: [..., 3]; aabb: [6] (xyzmin|xyzmax).

    Returns (nears, fars) [...]; rays that miss get far == near."""
    inv_d = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp(tmin, min=min_near)
    far = torch.maximum(tmax, near)
    return near, far


class MarchResult(NamedTuple):
    xyzs: torch.Tensor  # [R, S, 3] sample positions (clamped to bound)
    deltas: torch.Tensor  # [R, S] dt of each sample
    ts: torch.Tensor  # [R, S] t after the step (for depth)
    mask: torch.Tensor  # [R, S] bool, sample is real


def step_size(grid_size: int, cascade: int, max_steps: int):
    dt_max = 2.0 * SQRT3 * (1 << (cascade - 1)) / grid_size
    dt_min = min(dt_max, 2.0 * SQRT3 / max_steps)
    return dt_min, dt_max


def occupancy_lookup(occupancy: torch.Tensor, xyz: torch.Tensor, bound: float) -> torch.Tensor:
    """Occupancy bits [H,H,H] bool at positions xyz [..., 3] in [-bound, bound]."""
    H = occupancy.shape[0]
    n = torch.clamp(0.5 * (xyz / bound + 1.0) * H, 0.0, H - 1).to(torch.int64)
    idx = (n[..., 0] * H + n[..., 1]) * H + n[..., 2]
    return occupancy.reshape(-1)[idx]


def occupancy_aabb(occupancy: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
    """Tight world-space AABB [6] of the occupied cells of [H,H,H]."""
    H = occupancy.shape[0]
    idx = torch.arange(H, dtype=torch.float32, device=occupancy.device)
    lo_edge = (2.0 * idx / H - 1.0) * bound
    hi_edge = (2.0 * (idx + 1.0) / H - 1.0) * bound
    mins, maxs = [], []
    for axis in range(3):
        any_ax = occupancy.movedim(axis, 0).reshape(H, -1).any(dim=1)
        mins.append(torch.where(any_ax, lo_edge, torch.full_like(lo_edge, bound)).amin())
        maxs.append(torch.where(any_ax, hi_edge, torch.full_like(hi_edge, -bound)).amax())
    return torch.stack(mins + maxs)


def coarsen_occupancy(occupancy: torch.Tensor, factor: int = 4, dilate: bool = True) -> torch.Tensor:
    """Conservative coarse occupancy [H,H,H] -> [H/f]^3, optionally dilated
    by one coarse cell."""
    H = occupancy.shape[0]
    if H % factor:
        raise ValueError(f"grid {H} is not a multiple of coarse factor {factor}")
    h = H // factor
    coarse = (occupancy.reshape(h, factor, h, factor, h, factor)
              .permute(0, 2, 4, 1, 3, 5).reshape(h, h, h, -1).any(dim=-1))
    if dilate:
        f = F.max_pool3d(coarse.float()[None, None], 3, stride=1, padding=1)[0, 0]
        coarse = f > 0.0
    return coarse


def _first_true(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(hit.to(torch.int32), dim=-1)


def probe_entry_exit(rays_o, rays_d, t0, t1, occ_coarse, bound: float,
                     n_probe: int = 24, probe_dt: Optional[float] = None):
    """(t_first, t_last) of the occupied probe span per ray; rays with no
    probe hit fall back to the full (t0, t1) slab."""
    h = occ_coarse.shape[0]
    if probe_dt is None:
        probe_dt = 2.0 * bound / h
    steps = torch.arange(n_probe, dtype=torch.float32, device=rays_o.device)
    ts = t0[:, None] + steps[None, :] * probe_dt  # [Rc, P]
    xyz = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(occ_coarse, torch.clamp(xyz, -bound, bound), bound)
    hit = occ & (ts < t1[:, None])
    any_hit = hit.any(dim=-1)
    idx_first = _first_true(hit).float()
    idx_last = (n_probe - 1) - _first_true(hit.flip(-1)).float()
    t_first = torch.maximum(t0 + idx_first * probe_dt - probe_dt, t0)
    t_last = torch.minimum(t0 + idx_last * probe_dt + 2.0 * probe_dt, t1)
    t_first = torch.where(any_hit, t_first, t0)
    t_last = torch.where(any_hit, t_last, t1)
    return t_first, t_last


def entry_exit_depth_map(rays_o, rays_d, occupancy, occ_aabb, bound: float,
                         image_hw: tuple, stride: int = 4, coarse_factor: int = 4,
                         n_probe: int = 24, min_near: float = 0.05):
    """Per-ray (t_entry, t_exit) maps [H*W] from a strided coarse-ray probe:
    entry 3x3 min-pooled, exit 3x3 max-pooled, nearest-upsampled."""
    H, W = image_hw
    ro = rays_o.reshape(H, W, 3)[::stride, ::stride].reshape(-1, 3)
    rd = rays_d.reshape(H, W, 3)[::stride, ::stride].reshape(-1, 3)
    hc, wc = H // stride, W // stride
    n2, f2 = near_far_from_aabb(ro, rd, occ_aabb, min_near)
    occ_coarse = coarsen_occupancy(occupancy, coarse_factor, dilate=True)
    t_first, t_last = probe_entry_exit(ro, rd, n2, f2, occ_coarse, bound, n_probe=n_probe)
    ent = -F.max_pool2d(-t_first.reshape(1, 1, hc, wc), 3, stride=1, padding=1)
    ext = F.max_pool2d(t_last.reshape(1, 1, hc, wc), 3, stride=1, padding=1)

    def up(m):
        m = m[0, 0].repeat_interleave(stride, dim=0).repeat_interleave(stride, dim=1)
        return m.reshape(H * W)

    return up(ent), up(ext)


def march_rays_interval(rays_o, rays_d, nears, fars, occ_aabb, bound: float = 1.0,
                        max_steps: int = 16, num_samples: int = 16,
                        noise: Optional[torch.Tensor] = None, min_near: float = 0.05,
                        grid_size: int = 128, t_entry: Optional[torch.Tensor] = None,
                        t_exit: Optional[torch.Tensor] = None) -> MarchResult:
    """Place `num_samples` lattice samples per ray over the occupied
    interval; with `t_exit` the per-ray spacing stretches over the probed
    span (dt_ray = max(dt_min, (t_exit - t0) / S)). `noise` [R] in [0, 1)
    shifts each ray's lattice by noise * dt_ray (training's perturb)."""
    R = rays_o.shape[0]
    dt_min, _ = step_size(grid_size, 1, max_steps)
    n2, f2 = near_far_from_aabb(rays_o, rays_d, occ_aabb, min_near)
    t0 = torch.maximum(nears, n2)
    t1 = torch.minimum(fars, f2)
    if t_entry is not None:
        t0 = torch.minimum(torch.maximum(t_entry, t0), t1)
    # an unoccupied grid gives an inverted box: mask it explicitly
    empty = torch.any(occ_aabb[:3] > occ_aabb[3:])
    t1 = torch.where(empty, t0, t1)
    if t_exit is not None:
        te = torch.minimum(torch.maximum(t_exit, t0), t1)
        dt_ray = torch.clamp((te - t0) / float(num_samples), min=dt_min)[:, None]
    else:
        dt_ray = torch.full((R, 1), dt_min, dtype=rays_o.dtype, device=rays_o.device)
    if noise is not None:
        t0 = t0 + dt_ray[:, 0] * noise
    steps = torch.arange(num_samples, dtype=torch.float32, device=rays_o.device)
    t_start = t0[:, None] + steps[None, :] * dt_ray  # [R, S]
    t_end = t_start + dt_ray
    mask = t_start < t1[:, None]
    xyz = rays_o[:, None, :] + t_start[..., None] * rays_d[:, None, :]
    xyz = torch.clamp(xyz, -bound, bound)
    deltas = dt_ray.expand(R, num_samples)
    return MarchResult(xyzs=xyz, deltas=deltas, ts=t_end, mask=mask)
