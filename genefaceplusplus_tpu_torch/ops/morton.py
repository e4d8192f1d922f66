"""Occupancy-grid dilation (port of `dilate6` in
`genefaceplusplus_tpu/ops/morton.py`). Morton codes and the packed
bitfield serve the reference checkpoint format and are not ported yet
(ROADMAP)."""

from __future__ import annotations

import torch


def dilate6(grid: torch.Tensor) -> torch.Tensor:
    """6-neighbourhood max dilation of [CAS, H, H, H]; an out-of-range
    neighbour is skipped, i.e. the edge value is replicated."""
    out = grid
    for axis in (1, 2, 3):
        n = grid.shape[axis]
        fwd = torch.cat([grid.narrow(axis, 1, n - 1), grid.narrow(axis, n - 1, 1)], dim=axis)
        bwd = torch.cat([grid.narrow(axis, 0, 1), grid.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.maximum(out, torch.maximum(fwd, bwd))
    return out
