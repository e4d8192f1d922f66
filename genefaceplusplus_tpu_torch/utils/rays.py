"""Ray generation from camera poses (port of `get_bg_coords` and
`pixel_rays` in `genefaceplusplus_tpu/utils/rays.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


def get_bg_coords(H: int, W: int, device=None) -> torch.Tensor:
    """Normalised per-pixel coords [1, H*W, 2] in [-1, 1] (row-major, x=row)."""
    xs = torch.arange(H, dtype=torch.float32, device=device) / (H - 1) * 2 - 1
    ys = torch.arange(W, dtype=torch.float32, device=device) / (W - 1) * 2 - 1
    xx, yy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)[None]


def pixel_rays(poses: torch.Tensor, intrinsics: Tuple[float, float, float, float],
               H: int, W: int):
    """Rays through every pixel, row-major.

    poses: [B, 4, 4] c2w; intrinsics: (fx, fy, cx, cy).
    Returns rays_o, rays_d [B, H*W, 3]."""
    fx, fy, cx, cy = intrinsics
    inds = torch.arange(H * W, dtype=torch.int32, device=poses.device)
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    zs = torch.ones_like(i)
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = torch.stack([xs, ys, zs], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    rays_d = torch.einsum("nc,brc->bnr", directions, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d
