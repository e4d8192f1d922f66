"""Pose conversion (numpy copy of `nerf_matrix_to_ngp` in
`genefaceplusplus_tpu/utils/rotation.py`, whose module imports jax)."""

from __future__ import annotations

import numpy as np


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
