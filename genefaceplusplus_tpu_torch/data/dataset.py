"""RAD-NeRF dataset (port of `genefaceplusplus_tpu/data/dataset.py`, which
imports jax through `utils/rotation.py` and cv2 for images).

Kept: the binarizer record format, ngp poses (the eval split's smoothed
camera path included), the normalised landmark conditions, eye-area
percents, the background, images from the files the record names (the
binarizer's `com_imgs/*.jpg`, `head_imgs/*.png`, `inpaint_torso_imgs/*.png`,
decoded by `data/image_io.py` as cv2 decodes them) or from its in-memory
`*_img` arrays, at the render size or with `full_res` at the stored size
(the SR task's 2x targets), behind JAX's 1 GiB LRU cache; the
torso-composited background, the convex-hull face mask (numpy, no cv2),
`synthetic()`, and `with_sr=True`: the SR models' half-resolution render
size, with scaled intrinsics and the background and images resized
bilinearly (`resize_bilinear`, where cv2.INTER_LINEAR samples).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from genefaceplusplus_tpu_torch.data.image_io import read_image
from genefaceplusplus_tpu_torch.utils.rotation import nerf_matrix_to_ngp
from genefaceplusplus_tpu_torch.utils.smoothing import smooth_camera_sequence


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Counter-clockwise convex hull (monotone chain) of integer points [P, 2]
    (x, y), collinear points dropped."""
    p = sorted(set(map(tuple, pts.tolist())))
    if len(p) <= 2:
        return np.asarray(p, np.int64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def get_boundary_mask(lm2d: np.ndarray, H: int, W: int) -> np.ndarray:
    """Filled convex hull of the normalised 2D landmarks -> bool [H, W] face
    mask (the JAX version's cv2.convexHull + cv2.fillConvexPoly, in numpy):
    each pixel row between the hull's top and bottom vertex is filled from
    the rounded left to the rounded right crossing of the hull's edges."""
    pts = np.clip((lm2d * np.asarray([W, H])).astype(np.int32), 0, [W - 1, H - 1])
    hull = _convex_hull(pts).astype(np.float64)
    mask = np.zeros((H, W), bool)
    y0, y1 = int(hull[:, 1].min()), int(hull[:, 1].max())
    ys = np.arange(y0, y1 + 1, dtype=np.float64)
    left = np.full(ys.shape, np.inf)
    right = np.full(ys.shape, -np.inf)
    for a, b in zip(hull, np.roll(hull, -1, axis=0)):
        lo, hi = min(a[1], b[1]), max(a[1], b[1])
        on = (ys >= lo) & (ys <= hi)
        if a[1] == b[1]:
            xa, xb = np.full(ys.shape, min(a[0], b[0])), np.full(ys.shape, max(a[0], b[0]))
        else:
            xa = xb = a[0] + (ys - a[1]) * (b[0] - a[0]) / (b[1] - a[1])
        left = np.where(on, np.minimum(left, xa), left)
        right = np.where(on, np.maximum(right, xb), right)
    xs = np.arange(W)
    lo = np.floor(left + 0.5)[:, None]
    hi = np.floor(right + 0.5)[:, None]
    mask[y0:y1 + 1] = (xs[None, :] >= lo) & (xs[None, :] <= hi)
    return mask


def resize_bilinear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, c] float image -> [H, W, c]: bilinear with half-pixel centres
    and no antialiasing, sampling where cv2.resize's INTER_LINEAR does."""
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).numpy()


class RADNeRFDataset:
    """A split of a binarized identity (`ds` dict or .npy path)."""

    def __init__(self, ds: Dict | str, split: str = "train", camera_scale: float = 4.0,
                 camera_offset=(0.0, 0.0, 0.0), smooth_eval_camera: bool = True,
                 camera_smooth_kernel: int = 7, cond_win_size: int = 1,
                 smo_win_size: int = 3, with_sr: bool = False):
        if isinstance(ds, str):
            ds = np.load(ds, allow_pickle=True).tolist()
        self.ds = ds
        self.split = split
        self.H = int(ds["H"])
        self.W = int(ds["W"])
        if with_sr:  # SR models render at half resolution (dataset_utils.py:187-190)
            self.H //= 2
            self.W //= 2
        self.focal = float(ds["focal"])
        scale = self.H / int(ds["H"])
        self.intrinsics = (self.focal * scale, self.focal * scale,
                           float(ds["cx"]) * scale, float(ds["cy"]) * scale)
        self.samples: List[Dict] = ds[f"{split}_samples"]
        self.cond_win_size = cond_win_size
        self.smo_win_size = smo_win_size
        # decoded images, uint8 at their target size, least recently used
        # first; evicted past img_cache_mb as in JAX
        self._img_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._img_cache_bytes = 0
        self.img_cache_mb = 1024

        c2ws = np.stack([s["c2w"] for s in self.samples])
        poses = np.stack([
            nerf_matrix_to_ngp(c, scale=camera_scale, offset=camera_offset) for c in c2ws
        ])
        if split != "train" and smooth_eval_camera:
            poses = smooth_camera_sequence(poses, camera_smooth_kernel)
        self.poses = poses.astype(np.float32)

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
        if self.bg_img.shape[0] != self.H:
            self.bg_img = resize_bilinear(self.bg_img, self.H, self.W)

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

    def _cache_put(self, key, u8: np.ndarray):
        self._img_cache[key] = u8
        self._img_cache_bytes += u8.nbytes
        cap = self.img_cache_mb * 2 ** 20
        while self._img_cache_bytes > cap and self._img_cache:
            _, old = self._img_cache.popitem(last=False)
            self._img_cache_bytes -= old.nbytes

    def load_image(self, i: int, kind: str = "gt", with_alpha: bool = False,
                   full_res: bool = False) -> Optional[np.ndarray]:
        """gt/head/torso image of frame i as float [H, W, 3] in [0, 1] (or
        [H, W, 4] with `with_alpha` when the stored image has alpha). The
        file the record names as `{kind}_img_fname` wins when it exists
        (`read_image`: PNG or baseline JPEG, as cv2 decodes them); else the
        record's `{kind}_img` array; else None. Divided by 255 when its max
        exceeds 1.5, resized bilinearly when its height is not the target's,
        quantised through uint8 and kept in the LRU cache (`img_cache_mb`),
        as the JAX dataset does. With `full_res` the image keeps the
        record's stored size (ds['H'], ds['W']) instead of the render size."""
        target_h = int(self.ds["H"]) if full_res else self.H
        target_w = int(self.ds["W"]) if full_res else self.W
        key = (i, kind, full_res)
        u8 = self._img_cache.get(key)
        if u8 is not None:
            self._img_cache.move_to_end(key)
        else:
            fname = self.samples[i].get(f"{kind}_img_fname")
            if fname is not None and os.path.exists(fname):
                img = read_image(fname).astype(np.float32)
            else:
                arr = self.samples[i].get(f"{kind}_img")
                if arr is None:
                    return None
                img = np.asarray(arr, np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            if img.shape[0] != target_h:
                img = resize_bilinear(img, target_h, target_w)
            u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
            self._cache_put(key, u8)
        img = u8.astype(np.float32) / 255.0
        return img if (with_alpha and img.shape[-1] == 4) else img[..., :3]

    def frame_bg_torso(self, i: int) -> Optional[np.ndarray]:
        """Inpainted-torso image composited over the static background (the
        head task's per-frame render background); None without torso
        images."""
        t = self.load_image(i, "torso", with_alpha=True)
        if t is None or t.shape[-1] != 4:
            return None
        alpha = t[..., 3:]
        return t[..., :3] * alpha + self.bg_img * (1.0 - alpha)


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
