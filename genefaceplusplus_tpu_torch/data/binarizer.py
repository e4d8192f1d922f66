"""Binarizer: processed video dir -> one trainval_dataset.npy (port of
`genefaceplusplus_tpu/data/binarizer.py`).

Packs the background, the intrinsics, the fitted 3DMM coefficients,
idexp_lm3d (+ mean / std), hubert / mel / f0, and per-frame samples with
face and lip rects, normalised lm68 and the deep3d -> NeRF c2w; 10/11
train, 1/11 val (binarizer_nerf.py:197-339). The record's keys, file names
and split are JAX's, so the port's `RADNeRFDataset` and `training/run.py`,
and JAX's, read what this writes. The basis reconstructions run on
`device` (the card unless named).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import get_face_rect
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
from genefaceplusplus_tpu_torch.data.image_io import read_image
from genefaceplusplus_tpu_torch.data.landmarks import INDEX_LM68_FROM_LM478, get_eye_area_percent
from genefaceplusplus_tpu_torch.utils.device import resolve_device
from genefaceplusplus_tpu_torch.utils.rotation import compute_bfm_rotation


def get_lip_rect(lm68: np.ndarray, H: int, W: int, margin: float = 0.05):
    """Lip bounding rect [top, bottom, left, right] from the mouth landmarks
    (binarizer_nerf.py:98)."""
    mouth = lm68[48:68]
    xs = mouth[:, 0] * W if mouth.max() <= 1.5 else mouth[:, 0]
    ys = mouth[:, 1] * H if mouth.max() <= 1.5 else mouth[:, 1]
    mx = max(4.0, (xs.max() - xs.min()) * margin)
    my = max(4.0, (ys.max() - ys.min()) * margin)
    return [
        int(max(0, ys.min() - my)), int(min(H, ys.max() + my)),
        int(max(0, xs.min() - mx)), int(min(W, xs.max() + mx)),
    ]


def deep3d_to_nerf_c2w(euler: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """deep3drecon pose -> NeRF / OpenGL c2w [T, 4, 4] (binarizer_nerf.py:249-266):
    undo to_camera (z -> 10 - z), transpose, flip z, scale / 10, invert."""
    T = len(euler)
    rots = compute_bfm_rotation(torch.as_tensor(np.asarray(euler, np.float32))).numpy()  # [T, 3, 3], pts @ rot
    trans = np.array(trans, copy=True)
    trans[:, 2] = 10.0 - trans[:, 2]
    rots = rots.transpose(0, 2, 1)
    trans[:, 2] = -trans[:, 2]
    trans = trans / 10.0
    rots_inv = rots.transpose(0, 2, 1)
    trans_inv = -np.einsum("tij,tj->ti", rots_inv, trans)
    pose = np.tile(np.eye(4, dtype=np.float32)[None], (T, 1, 1))
    pose[:, :3, :3] = rots_inv
    pose[:, :3, 3] = trans_inv
    return pose


def binarize(
    processed_dir: str,
    out_path: Optional[str] = None,
    bfm_dir: str = "deep_3drecon/BFM",
    device=None,
) -> Dict:
    """Pack a processed dir (bg.jpg, aud_hubert.npy, aud_mel_f0.npy,
    coeff_fit_mp.npy, lms_2d.npy, {head,com,inpaint_torso}_imgs/) into the
    binarized dataset dict; writes `out_path` when given."""
    helper = Face3DHelper.load(bfm_dir, keypoint_mode="lm68", device=resolve_device(device))
    ret: Dict = {}

    bg = read_image(os.path.join(processed_dir, "bg.jpg"))[..., :3]
    ret["bg_img"] = bg
    H, W = bg.shape[:2]
    ret["H"], ret["W"] = H, W
    ret["focal"], ret["cx"], ret["cy"] = 1015.0, 112.0, 112.0

    coeff = np.load(os.path.join(processed_dir, "coeff_fit_mp.npy"), allow_pickle=True).tolist()
    ret["id"], ret["exp"] = coeff["id"].astype(np.float32), coeff["exp"].astype(np.float32)
    ret["euler"], ret["trans"] = coeff["euler"].astype(np.float32), coeff["trans"].astype(np.float32)
    T = len(ret["exp"])

    def t(k):
        return torch.as_tensor(ret[k]).to(helper.key_mean_shape)

    idexp = helper.reconstruct_idexp_lm3d(t("id"), t("exp")).cpu().numpy()
    if idexp.shape[1] >= 468:
        idexp = idexp[:, INDEX_LM68_FROM_LM478]
    idexp = idexp.reshape(T, -1)
    ret["idexp_lm3d"] = idexp
    ret["idexp_lm3d_mean"] = idexp.mean(0)
    ret["idexp_lm3d_std"] = idexp.std(0) + 1e-8

    lm2d_path = os.path.join(processed_dir, "lms_2d.npy")
    if os.path.exists(lm2d_path):
        lm2d = np.load(lm2d_path)
        if lm2d.shape[1] in (468, 478):
            lm2d = lm2d[:, INDEX_LM68_FROM_LM478]
    else:  # the fitted landmarks, reprojected
        lm2d = helper.reconstruct_lm2d(t("id"), t("exp"), t("euler"), t("trans")).cpu().numpy() * np.asarray([W, H])

    cano = idexp.reshape(T, 68, 3) / 10.0 + helper.key_mean_shape.cpu().numpy()[None, :68]
    ret["eye_area_percent"] = get_eye_area_percent(cano).reshape(T, 1).astype(np.float32)

    for key, fname in [("hubert", "aud_hubert.npy"), ("mel_f0", "aud_mel_f0.npy")]:
        p = os.path.join(processed_dir, fname)
        if os.path.exists(p):
            data = np.load(p, allow_pickle=True)
            if key == "mel_f0":
                d = data.tolist()
                ret["mel"], ret["f0"] = d["mel"], d["f0"]
            else:
                ret["hubert"] = data

    c2w = deep3d_to_nerf_c2w(ret["euler"], ret["trans"])
    n_train = T // 11 * 10 if T >= 11 else max(1, T - 1)
    splits = {"train_samples": range(n_train), "val_samples": range(n_train, T)}
    for split, indices in splits.items():
        samples = []
        for idx in indices:
            samples.append({
                "idx": idx,
                "head_img_fname": os.path.join(processed_dir, "head_imgs", f"{idx:08d}.png"),
                "torso_img_fname": os.path.join(processed_dir, "inpaint_torso_imgs", f"{idx:08d}.png"),
                "gt_img_fname": os.path.join(processed_dir, "com_imgs", f"{idx:08d}.jpg"),
                "face_rect": get_face_rect(lm2d[idx], H, W),
                "lip_rect": get_lip_rect(lm2d[idx], H, W),
                # normalised lm68 for the convex-hull face mask (dataset_utils.py:77-91)
                "lms": (lm2d[idx] / np.asarray([W, H])).astype(np.float32)
                if lm2d[idx].max() > 1.5 else lm2d[idx].astype(np.float32),
                "c2w": c2w[idx],
            })
        ret[split] = samples

    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        np.save(out_path, ret, allow_pickle=True)
    return ret
