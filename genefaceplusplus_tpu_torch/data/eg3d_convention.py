"""EG3D's camera convention (port of
`genefaceplusplus_tpu/data/eg3d_convention.py`): BFM euler angles and
translations -> the 25-d camera label that conditions the dual
discriminator (a flattened 4x4 camera-to-world pose, then the normalised
3x3 intrinsics), with the reference's radius normalisation (x0.27) and y/z
offsets. Host numpy over the port's `compute_bfm_rotation`."""

from __future__ import annotations

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.rotation import compute_bfm_rotation


def _fix_intrinsics() -> np.ndarray:
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = 2985.29 / 700
    K[1, 1] = 2985.29 / 700
    K[0, 2] = 0.5
    K[1, 2] = 0.5
    return K


def _fix_rot(pose: np.ndarray) -> np.ndarray:
    """EG3D's axis flip (y and z negated)."""
    rot = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    out = pose.copy()
    out[:3, :3] = pose[:3, :3] @ rot
    return out


def eg3d_camera_from_euler_trans(euler: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """euler [T, 3], trans [T, 3] -> camera labels [T, 25] (float32)."""
    T = len(euler)
    R = compute_bfm_rotation(torch.from_numpy(np.asarray(euler, np.float32))).numpy()  # [T, 3, 3]
    out = np.zeros((T, 25), np.float32)
    K = _fix_intrinsics().reshape(-1)
    for t in range(T):
        tr = np.array(trans[t], np.float64, copy=True)
        tr[2] += -10.0
        c = -R[t] @ tr
        c *= 0.27
        c[1] += 0.006
        c[2] += 0.161
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R[t]
        pose[:3, 3] = c
        pose = _fix_rot(pose)
        out[t, :16] = pose.reshape(-1)
        out[t, 16:] = K
    return out
