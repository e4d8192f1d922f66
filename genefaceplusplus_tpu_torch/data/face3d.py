"""BFM09 3DMM helper: landmark reconstruction from id + exp coefficients
(port of `genefaceplusplus_tpu/data/face3d.py`).

- `reconstruct_idexp_lm3d`: (id_base @ id + exp_base @ exp) * 10;
- `reconstruct_key_lm3d` / `reconstruct_lm2d` / `reconstruct_lm2d_nerf`:
  rotate and translate, z -> 10 - z, perspective projection (focal 1015,
  centre 112), y flipped, / 224; the NeRF variant flips x and y;
- `project_lm3d_nerf`: the same projection of given canonical landmarks.

The basis lives as float32 tensors on `device`; the reconstructions are
tensor functions there. Without `BFM_model_front.mat` (not
redistributable), `load` gives the deterministic stand-in basis,
`synthetic`, whose arrays are JAX's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.rotation import compute_bfm_rotation

N_VERTS = 35709
N_ID, N_EXP = 80, 64


def perspective_projection(focal: float = 1015.0, center: float = 112.0) -> np.ndarray:
    """[3, 3] transposed intrinsics: points @ P."""
    P = np.array([[focal, 0, center], [0, focal, center], [0, 0, 1]], np.float32)
    return P.T


def _flip_last(x: torch.Tensor, index: int, around: float) -> torch.Tensor:
    """x with x[..., index] replaced by `around - x[..., index]`."""
    x = x.clone()
    x[..., index] = around - x[..., index]
    return x


class Face3DHelper:
    """The key-point subset of the BFM basis, as tensors on `device`."""

    def __init__(self, key_mean_shape: np.ndarray, key_id_base: np.ndarray, key_exp_base: np.ndarray,
                 keypoint_mode: str = "lm68", device="cpu"):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        self.keypoint_mode = keypoint_mode
        self.key_mean_shape = t(key_mean_shape)  # [K, 3]
        self.key_id_base = t(key_id_base)  # [3K, 80]
        self.key_exp_base = t(key_exp_base)  # [3K, 64]
        self.persc_proj = t(perspective_projection())
        self.n_keypoints = self.key_mean_shape.shape[0]

    @classmethod
    def from_mat(cls, bfm_dir: str, keypoint_mode: str = "lm68", device="cpu") -> "Face3DHelper":
        from scipy.io import loadmat

        model = loadmat(os.path.join(bfm_dir, "BFM_model_front.mat"))
        mean_shape = model["meanshape"].reshape(-1, 3).astype(np.float32)
        mean_shape = mean_shape - mean_shape.mean(0, keepdims=True)
        id_base = model["idBase"].astype(np.float32)  # [3N, 80]
        exp_base = model["exBase"].astype(np.float32)  # [3N, 64]
        if keypoint_mode == "mediapipe":
            kp = np.load(os.path.join(bfm_dir, "index_mp468_from_mesh35709.npy")).astype(np.int64)
            kp[kp < 0] = 0
        else:
            kp = model["keypoints"].squeeze().astype(np.int64)
        key_mean = mean_shape[kp]
        key_id = id_base.reshape(-1, 3, N_ID)[kp].reshape(-1, N_ID)
        key_exp = exp_base.reshape(-1, 3, N_EXP)[kp].reshape(-1, N_EXP)
        return cls(key_mean, key_id, key_exp, keypoint_mode, device)

    @classmethod
    def synthetic(cls, keypoint_mode: str = "lm68", seed: int = 0, device="cpu") -> "Face3DHelper":
        """Deterministic stand-in basis: JAX's arrays (same RandomState calls)."""
        K = {"lm68": 68, "lm131": 131, "lm468": 468, "mediapipe": 468}[keypoint_mode]
        rng = np.random.RandomState(seed)
        key_mean = rng.randn(K, 3).astype(np.float32) * 0.3
        key_id = (rng.randn(3 * K, N_ID) * 0.01).astype(np.float32)
        key_exp = (rng.randn(3 * K, N_EXP) * 0.01).astype(np.float32)
        return cls(key_mean, key_id, key_exp, keypoint_mode, device)

    @classmethod
    def load(cls, bfm_dir: str = "deep_3drecon/BFM", keypoint_mode: str = "lm68", device="cpu") -> "Face3DHelper":
        if os.path.exists(os.path.join(bfm_dir, "BFM_model_front.mat")):
            return cls.from_mat(bfm_dir, keypoint_mode, device)
        return cls.synthetic(keypoint_mode, device=device)

    def reconstruct_idexp_lm3d(self, id_coeff: torch.Tensor, exp_coeff: torch.Tensor) -> torch.Tensor:
        """[T, 80], [T, 64] -> identity + expression landmark offsets [T, K, 3] x 10."""
        diff = id_coeff @ self.key_id_base.T + exp_coeff @ self.key_exp_base.T  # [T, 3K]
        return diff.reshape(diff.shape[0], -1, 3) * 10.0

    def reconstruct_key_lm3d(self, id_coeff, exp_coeff, euler, trans, to_camera: bool = True):
        """Posed key-point landmarks in camera space [T, K, 3]."""
        diff = id_coeff @ self.key_id_base.T + exp_coeff @ self.key_exp_base.T
        face = self.key_mean_shape.reshape(1, -1, 3) + diff.reshape(diff.shape[0], -1, 3)
        lm3d = face @ compute_bfm_rotation(euler) + trans[:, None, :]
        return _flip_last(lm3d, -1, 10.0) if to_camera else lm3d

    def _project(self, lm3d: torch.Tensor) -> torch.Tensor:
        proj = lm3d @ self.persc_proj
        lm2d = proj[..., :2] / proj[..., 2:]
        return _flip_last(lm2d, 1, 224.0) / 224.0

    def reconstruct_lm2d(self, id_coeff, exp_coeff, euler, trans, to_camera: bool = True):
        """Projected 2D landmarks in [0, 1]^2 (origin top-left, / 224)."""
        btc = id_coeff.ndim == 3
        if btc:
            b, t = id_coeff.shape[:2]
            id_coeff, exp_coeff = id_coeff.reshape(b * t, -1), exp_coeff.reshape(b * t, -1)
            euler, trans = euler.reshape(b * t, -1), trans.reshape(b * t, -1)
        lm2d = self._project(self.reconstruct_key_lm3d(id_coeff, exp_coeff, euler, trans, to_camera))
        return lm2d.reshape(b, t, -1, 2) if btc else lm2d

    def reconstruct_lm2d_nerf(self, id_coeff, exp_coeff, euler, trans):
        """NeRF-convention 2D landmarks: both axes flipped."""
        return 1.0 - self.reconstruct_lm2d(id_coeff, exp_coeff, euler, trans, to_camera=False)

    def project_lm3d_nerf(self, lm3d, euler, trans):
        """NeRF-convention projection of given canonical landmarks [T, K, 3]
        (the direct-drive path, which has no id/exp coefficients)."""
        posed = lm3d @ compute_bfm_rotation(euler) + trans[:, None, :]
        return 1.0 - self._project(posed)
