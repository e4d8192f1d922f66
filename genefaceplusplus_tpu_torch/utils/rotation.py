"""Rotation math (port of `genefaceplusplus_tpu/utils/rotation.py`):
`nerf_matrix_to_ngp` in numpy, and the BFM fitting rotation
`compute_bfm_rotation` (with `_axis_rotation`) as tensor functions."""

from __future__ import annotations

import numpy as np
import torch


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 4.0, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL NeRF c2w -> instant-NGP axis convention (y,z,x cycle, flip)."""
    pose = np.asarray(pose)
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _axis_rotation(angle: torch.Tensor, axis: str) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] about a named axis for angles [...]."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == "X":
        rows = ((one, zero, zero), (zero, c, -s), (zero, s, c))
    elif axis == "Y":
        rows = ((c, zero, s), (zero, one, zero), (-s, zero, c))
    elif axis == "Z":
        rows = ((c, -s, zero), (s, c, zero), (zero, zero, one))
    else:
        raise ValueError(axis)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def compute_bfm_rotation(angles: torch.Tensor) -> torch.Tensor:
    """BFM fitting rotation (deep_3drecon bfm.py:200-235): angles [B, 3]
    (x, y, z radians) -> R [B, 3, 3] with R = (Rz @ Ry @ Rx)^T."""
    rx = _axis_rotation(angles[..., 0], "X")
    ry = _axis_rotation(angles[..., 1], "Y")
    rz = _axis_rotation(angles[..., 2], "Z")
    return (rz @ ry @ rx).transpose(-1, -2)
