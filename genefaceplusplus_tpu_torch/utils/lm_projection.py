"""Per-identity calibrated canonical-landmark -> image projection (numpy
copy of `genefaceplusplus_tpu/utils/lm_projection.py`).

Why this exists: the reference projects predicted landmarks to the image
through the BFM/deep3d camera (`data_util/face3d_helper.py:126-169`,
consumed at `inference/genefacepp_infer.py:425-429`) — valid only for
identities whose dataset was fit with that 3DMM convention. The
direct-drive path (motion_type=idexp_lm3d) exists precisely for
identities WITHOUT a BFM-consistent fit, so their canonical->image
mapping is unknown a priori. But in the RAD-NeRF data model the head is
static in world space and ALL motion lives in the per-frame camera pose
(tasks/radnerfs/dataset_utils.py builds c2w per frame), so a fixed map
from canonical landmarks to world exists per identity. This module
recovers it from the dataset itself — a DLT-style linear least-squares
fit of the stored per-frame 2D landmarks against the canonical
landmarks reprojected through the dataset camera — and applies it at
drive time. Convention-free: works for any identity that stores
(idexp_lm3d, c2w poses, intrinsics, 2D lms), which the binarizer schema
guarantees (data/binarizer.py).

Model: world_k = L @ cano_k + b_k with a SHARED linear L [3,3] and a
PER-LANDMARK bias b [K,3]. The per-landmark bias is load-bearing: the
pipeline's canonical landmarks include the BFM mean shape (cano =
idexp/10 + key_mean_k), and any identity-specific static component
(key_mean under one convention, a rigid placement of the mean face
under another) is a per-landmark constant that a single affine cannot
absorb — fitting without it left a 36 px residual on a dataset whose
geometry is exact by construction.

Camera model (matches utils/rays.py:pixel_rays and the binarizer's ngp
poses): vc = R^T (w - t); px = fx*vc0/vc2 + cx - 0.5, py analogous;
normalised u = px / W, v = py / H.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def calibrate_cano_to_world(
    cano_lm3d: np.ndarray,   # [N, K, 3] canonical landmarks per frame
    poses: np.ndarray,       # [N, 4, 4] ngp c2w poses
    intrinsics,              # (fx, fy, cx, cy)
    lms_norm: np.ndarray,    # [N, K, 2] stored landmarks, normalised (x, y)
    H: int,
    W: int,
    max_frames: int = 64,
) -> Tuple[Tuple[np.ndarray, np.ndarray], float]:
    """Solve world_k = L @ cano_k + b_k (L [3,3] shared, b [K,3]) by DLT.

    For each observation: a = u*W - cx + 0.5, b2 = v*H - cy + 0.5,
      fx*vc0 - a*vc2 = 0 and fy*vc1 - b2*vc2 = 0,
    with vc = B(L x + b_k) - B t, B = R^T — linear in (L, b).

    Returns ((L, b), mean reprojection residual in pixels at (W, H) scale).
    """
    N = len(cano_lm3d)
    sel = np.unique(np.linspace(0, N - 1, min(N, max_frames)).astype(int))
    x = np.asarray(cano_lm3d, np.float64)[sel]          # [n, K, 3]
    P = np.asarray(poses, np.float64)[sel]
    uv = np.asarray(lms_norm, np.float64)[sel]
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    n, K, _ = x.shape

    B = np.swapaxes(P[:, :3, :3], 1, 2)                 # [n, 3, 3] = R^T
    c = np.einsum("nij,nj->ni", B, P[:, :3, 3])         # [n, 3] = B t
    a = uv[..., 0] * W - cx + 0.5                       # [n, K]
    b2 = uv[..., 1] * H - cy + 0.5

    # row coefficient vectors over world coords: for eq-x it is
    # fx*B[0,:] - a*B[2,:]; the world point is L x + b_k, so the unknown
    # coefficients are  coeff_w[r] * x[s]  for L[r, s]  and  coeff_w[r]
    # (placed in landmark k's bias slot) for b[k, r].
    cw_x = fx * B[:, 0, :][:, None, :] - a[..., None] * B[:, 2, :][:, None, :]   # [n,K,3]
    cw_y = fy * B[:, 1, :][:, None, :] - b2[..., None] * B[:, 2, :][:, None, :]  # [n,K,3]

    nK = n * K
    nL = 9
    nb = 3 * K
    G = np.zeros((2 * nK, nL + nb))
    # L block: [n,K, 3(world r), 3(cano s)] -> 9
    G[:nK, :nL] = (cw_x[..., :, None] * x[..., None, :]).reshape(nK, 9)
    G[nK:, :nL] = (cw_y[..., :, None] * x[..., None, :]).reshape(nK, 9)
    # b block: sparse per-landmark
    kk = np.tile(np.arange(K), n)
    rows = np.arange(nK)
    for r in range(3):
        G[rows, nL + kk * 3 + r] = cw_x.reshape(nK, 3)[:, r]
        G[nK + rows, nL + kk * 3 + r] = cw_y.reshape(nK, 3)[:, r]
    rhs = np.concatenate([
        (fx * c[:, 0][:, None] - a * c[:, 2][:, None]).reshape(-1),
        (fy * c[:, 1][:, None] - b2 * c[:, 2][:, None]).reshape(-1),
    ])
    theta, *_ = np.linalg.lstsq(G, rhs, rcond=None)
    L = theta[:nL].reshape(3, 3)
    bias = theta[nL:].reshape(K, 3)

    proj = project_cano_lm3d((L, bias), x, P, intrinsics, H, W)
    resid = np.linalg.norm((proj - uv) * np.asarray([W, H]), axis=-1).mean()
    return (L.astype(np.float32), bias.astype(np.float32)), float(resid)


def project_cano_lm3d(proj, cano_lm3d, poses, intrinsics, H: int, W: int):
    """Project canonical landmarks through the calibrated map + camera.

    proj = (L [3,3], b [K,3]); cano_lm3d [T, K, 3]; poses [T, 4, 4] ->
    normalised lm2d [T, K, 2], numpy arrays.
    """
    L, bias = proj
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    w = cano_lm3d @ L.T + bias[None]                      # [T, K, 3] world
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    vc = np.einsum("tkj,tji->tki", w - t[:, None, :], R)  # R^T (w - t)
    z = vc[..., 2]
    z = np.where(np.abs(z) < 1e-6, 1e-6, z)
    px = fx * vc[..., 0] / z + cx - 0.5
    py = fy * vc[..., 1] / z + cy - 0.5
    return np.stack([px / W, py / H], -1)
