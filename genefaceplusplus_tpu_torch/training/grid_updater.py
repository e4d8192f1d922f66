"""Density-grid maintenance (port of `grid_cell_centers`,
`update_density_grid`, `mark_untrained_grid` and `update_torso_grid` in
`genefaceplusplus_tpu/training/grid_updater.py`):

  * every update_extra_interval steps: sigma at jittered cell centres with
    a random condition, 6-neighbourhood dilation, EMA
    grid = max(grid * decay, tmp) on trained cells, threshold
    min(mean_density, density_thresh) -> occupancy
  * mark_untrained_grid: cells no training camera sees get -1 (never
    occupied)
  * update_torso_grid: the torso's 2D alpha grid, alpha at jittered cell
    centres, 5x5 max-pool dilation, EMA max

Grids are spatial [H, H, H] tensors; the sigma sweep runs in chunks to
bound memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genefaceplusplus_tpu_torch.ops.morton import dilate6


def grid_cell_centers(grid_size: int, device=None) -> torch.Tensor:
    """[H^3, 3] cell-centre coordinates in [-1, 1] (x-major order)."""
    lin = 2.0 * torch.arange(grid_size, dtype=torch.float32, device=device) / (grid_size - 1) - 1.0
    x, y, z = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def update_density_grid(density_fn, density_grid: torch.Tensor,
                        generator: Optional[torch.Generator] = None, bound: float = 1.0,
                        decay: float = 0.95, density_thresh: float = 10.0, chunk: int = 262144,
                        jitter: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One EMA refresh. density_fn: [N, 3] -> sigma [N]. The cell jitter is
    uniform in [-bound/H, bound/H) from `generator`, or given as `jitter`
    [H^3, 3].

    Returns (new_grid, occupancy bool [H, H, H], mean_density scalar)."""
    H = density_grid.shape[0]
    dev = density_grid.device
    pts = grid_cell_centers(H, dev)
    half = bound / H
    if jitter is None:
        jitter = (torch.rand(pts.shape, generator=generator, device=dev) * 2.0 - 1.0) * half
    pts = pts * (bound - half) + jitter
    with torch.no_grad():
        tmp = torch.cat([density_fn(pts[s:s + chunk]).reshape(-1)
                         for s in range(0, pts.shape[0], chunk)]).reshape(H, H, H)
    tmp = dilate6(tmp[None].float())[0]
    valid = (density_grid >= 0) & (tmp >= 0)
    new_grid = torch.where(valid, torch.maximum(density_grid * decay, tmp), density_grid)
    mean_density = torch.mean(torch.clamp(new_grid, min=0.0))
    occupancy = new_grid > torch.clamp(mean_density, max=density_thresh)
    return new_grid, occupancy, mean_density


def mark_untrained_grid(density_grid: torch.Tensor, poses: np.ndarray, intrinsics,
                        bound: float = 1.0, chunk: int = 32768) -> torch.Tensor:
    """Cells outside every training camera's frustum -> -1. Chunked over
    cells: the [B poses, H^3 cells, 3] broadcast is ~10 GB at B=400, H=128."""
    H = density_grid.shape[0]
    dev = density_grid.device
    fx, fy, cx, cy = intrinsics
    pts = grid_cell_centers(H, dev) * (bound - bound / H)
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    half = bound / H
    seen = []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        # world -> camera: (p - t) @ R
        cam = (p[None, :, :] - poses[:, None, :3, 3]) @ poses[:, :3, :3]
        mask_z = cam[..., 2] > 0
        mask_x = torch.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
        mask_y = torch.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
        seen.append((mask_z & mask_x & mask_y).any(dim=0))
    seen = torch.cat(seen).reshape(H, H, H)
    return torch.where(seen, density_grid, torch.full_like(density_grid, -1.0))


def update_torso_grid(alpha_fn, grid2d: torch.Tensor, generator: Optional[torch.Generator] = None,
                      decay: float = 0.95, jitter: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torso 2D alpha-grid refresh. alpha_fn: [N, 2] -> alpha [N]. The cell
    jitter is uniform in [-1/H, 1/H) from `generator`, or given as `jitter`
    [H^2, 2]. Returns (new grid [H, H], its mean)."""
    H = grid2d.shape[0]
    dev = grid2d.device
    lin = 2.0 * torch.arange(H, dtype=torch.float32, device=dev) / (H - 1) - 1.0
    x, y = torch.meshgrid(lin, lin, indexing="ij")
    pts = torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)
    half = 1.0 / H
    if jitter is None:
        jitter = (torch.rand(pts.shape, generator=generator, device=dev) * 2.0 - 1.0) * half
    pts = pts * (1 - half) + jitter
    with torch.no_grad():
        alphas = alpha_fn(pts).reshape(H, H).float()
    dil = F.max_pool2d(alphas[None, None], 5, stride=1, padding=2)[0, 0]  # 5x5 'SAME'
    new_grid = torch.maximum(grid2d * decay, dil)
    return new_grid, torch.mean(new_grid)
