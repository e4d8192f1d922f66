"""Pose-schedule looping and eval-camera smoothing (copies of
`mirror_index`, `smooth_features_xd` and `smooth_camera_sequence` in
`genefaceplusplus_tpu/utils/smoothing.py`)."""

import numpy as np
from scipy.spatial.transform import Rotation


def mirror_index(index: int, size: int) -> int:
    """Ping-pong looping: 0,1,...,n-1,n-2,...,1,0,1,... for driving poses."""
    turn = index // (size - 1) if size > 1 else 0
    res = index % (size - 1) if size > 1 else 0
    return res if turn % 2 == 0 else size - 1 - res


def smooth_features_xd(feats: np.ndarray, kernel_size: int = 7) -> np.ndarray:
    """Reflect-padded moving-average smoothing along axis 0 of [T, ...]."""
    T = len(feats)
    # reflect padding needs pad <= T-1 taps on each side; clamp the window
    # for very short sequences (e.g. a tiny val split's camera path)
    kernel_size = min(kernel_size, max(1, 2 * T - 1))
    if kernel_size <= 1:
        return feats
    pad_l = kernel_size // 2
    pad_r = kernel_size - 1 - pad_l
    padded = np.concatenate(
        [feats[1: pad_l + 1][::-1], feats, feats[-pad_r - 1: -1][::-1]], axis=0)
    kernel = np.ones(kernel_size) / kernel_size
    out = np.apply_along_axis(lambda x: np.convolve(x, kernel, mode="valid"), 0, padded)
    return out.astype(feats.dtype)


def smooth_camera_sequence(poses: np.ndarray, kernel_size: int = 7) -> np.ndarray:
    """Smooth a c2w pose sequence [T, 4, 4]: translations by moving average,
    rotations by quaternion mean over the window."""
    T = poses.shape[0]
    if kernel_size <= 1 or T < 2:
        return poses
    out = poses.copy()
    out[:, :3, 3] = smooth_features_xd(poses[:, :3, 3], kernel_size)
    rots = Rotation.from_matrix(poses[:, :3, :3])
    half = kernel_size // 2
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        out[t, :3, :3] = Rotation.from_quat(rots[lo:hi].as_quat()).mean().as_matrix()
    return out
