"""Inference subset of the RAD-NeRF dataset (port of
`genefaceplusplus_tpu/data/dataset.py`, which imports jax through
`utils/rotation.py`).

Kept: the binarizer record format, ngp poses, the normalised landmark
conditions, eye-area percents, the background and `synthetic()`, for the
train split at full resolution (the JAX class with `split="train",
with_sr=False`). Image loading, the eval split's smoothed camera path and
the half-resolution SR background need cv2 or serve training and SR; they
arrive with later PRs (ROADMAP).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from genefaceplusplus_tpu_torch.utils.rotation import nerf_matrix_to_ngp


class RADNeRFDataset:
    """Train split of a binarized identity (`ds` dict or .npy path)."""

    def __init__(self, ds: Dict | str, camera_scale: float = 4.0,
                 camera_offset=(0.0, 0.0, 0.0), cond_win_size: int = 1, smo_win_size: int = 3):
        if isinstance(ds, str):
            ds = np.load(ds, allow_pickle=True).tolist()
        self.ds = ds
        self.H = int(ds["H"])
        self.W = int(ds["W"])
        self.focal = float(ds["focal"])
        self.intrinsics = (self.focal, self.focal, float(ds["cx"]), float(ds["cy"]))
        self.samples: List[Dict] = ds["train_samples"]
        self.cond_win_size = cond_win_size
        self.smo_win_size = smo_win_size

        c2ws = np.stack([s["c2w"] for s in self.samples])
        self.poses = np.stack([
            nerf_matrix_to_ngp(c, scale=camera_scale, offset=camera_offset) for c in c2ws
        ]).astype(np.float32)

        lm = np.asarray(ds["idexp_lm3d"], np.float32)  # [T, 204]
        self.idexp_lm3d_mean = np.asarray(ds.get("idexp_lm3d_mean", lm.mean(0)), np.float32)
        self.idexp_lm3d_std = np.asarray(ds.get("idexp_lm3d_std", lm.std(0) + 1e-8), np.float32)
        normalized = (lm - self.idexp_lm3d_mean) / self.idexp_lm3d_std
        self.frame_ids = np.asarray([s.get("idx", k) for k, s in enumerate(self.samples)], np.int64)
        self.conds_all = normalized.reshape(len(lm), cond_win_size, -1).astype(np.float32)
        self.conds = self.conds_all[np.clip(self.frame_ids, 0, len(lm) - 1)]

        eye_all = np.asarray(ds.get("eye_area_percent", np.full((len(lm), 1), 0.25)),
                             np.float32).reshape(len(lm), 1)
        self.eye_area_percents = eye_all[np.clip(self.frame_ids, 0, len(lm) - 1)]

        self.bg_img = np.asarray(ds["bg_img"], np.float32)
        if self.bg_img.max() > 1.5:
            self.bg_img = self.bg_img / 255.0
        if self.bg_img.shape[:2] != (self.H, self.W):
            raise ValueError(f"bg_img is {self.bg_img.shape[:2]}, expected {(self.H, self.W)}")

    def __len__(self):
        return len(self.samples)

    def frame_pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def frame_cond_window(self, i: int) -> np.ndarray:
        """Centred smo window of conds [smo_win, cond_win, C] over the full
        timeline, zero outside it."""
        T = len(self.conds_all)
        left = int(self.frame_ids[i]) - self.smo_win_size // 2
        offs = np.arange(self.smo_win_size) + left
        valid = (offs >= 0) & (offs < T)
        win = self.conds_all[np.clip(offs, 0, T - 1)].copy()
        win[~valid] = 0.0
        return win


def synthetic(num_frames: int = 24, H: int = 64, W: int = 64, seed: int = 0) -> Dict:
    """Deterministic miniature ds_dict with the binarizer schema. Makes the
    same numpy RNG calls in the same order as the JAX package's
    `synthetic()` (random gt frames), so equal arguments give identical
    arrays."""
    rng = np.random.RandomState(seed)
    T = num_frames
    lm = rng.randn(T, 204).astype(np.float32) * 0.1
    theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    base_lms = np.stack([0.5 + 0.2 * np.cos(theta), 0.5 + 0.25 * np.sin(theta)], -1)
    lms = (base_lms[None] + rng.randn(T, 68, 2) * 0.005).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32)[None], (T, 1, 1))
    c2w[:, 2, 3] = 0.6  # camera in front of the face
    c2w[:, 0, 3] = 0.05 * np.sin(np.linspace(0, 2 * np.pi, T))

    samples = [
        {
            "idx": i,
            "c2w": c2w[i],
            "face_rect": [H // 4, 3 * H // 4, W // 4, 3 * W // 4],
            "lip_rect": [H // 2, 3 * H // 4, W // 3, 2 * W // 3],
            "lms": lms[i],
            "gt_img": rng.rand(H, W, 3).astype(np.float32),
        }
        for i in range(T)
    ]
    n_train = T // 11 * 10 if T >= 11 else max(1, T - 2)
    return {
        "bg_img": (rng.rand(H, W, 3) * 255).astype(np.uint8),
        "H": H,
        "W": W,
        "focal": 1015.0 * H / 224.0,
        "cx": W / 2.0,
        "cy": H / 2.0,
        "id": rng.randn(T, 80).astype(np.float32) * 0.1,
        "exp": rng.randn(T, 64).astype(np.float32) * 0.1,
        "euler": rng.randn(T, 3).astype(np.float32) * 0.05,
        "trans": rng.randn(T, 3).astype(np.float32) * 0.05,
        "eye_area_percent": np.full((T, 1), 0.25, np.float32),
        "idexp_lm3d": lm,
        "idexp_lm3d_mean": lm.mean(0),
        "idexp_lm3d_std": lm.std(0) + 1e-3,
        "hubert": rng.randn(2 * T, 1024).astype(np.float32),
        "mel": rng.randn(2 * T, 80).astype(np.float32),
        "f0": np.abs(rng.randn(2 * T)).astype(np.float32) * 100 + 100,
        "train_samples": samples[:n_train],
        "val_samples": samples[n_train:],
    }
