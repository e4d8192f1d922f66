"""Analysis-by-synthesis 3DMM fit: 2D landmarks -> (id, exp, euler, trans)
(port of `genefaceplusplus_tpu/data/fit_3dmm.py`).

Adam on id [1, 80] (shared by the video), exp [T, 64], euler [T, 3] and
trans [T, 3] against the detected landmarks: a weighted mean squared
landmark error (eyes x5, lips x3, the unmatched boundary x0), L2 priors on
id and exp, and a temporal Laplacian on the pose (and, in the joint phase,
on exp). Two phases, each with a fresh optimizer state, as JAX runs two
`optax.adam`s: pose only, then everything.

Outside a phase's keys the gradient is zero, not the parameter frozen: the
optimizer still steps every tensor, as JAX's masked gradients do (from zero
moments a zero gradient moves nothing, so the two agree while the moments
are zero). The optimizer is `training/schedulers.py:OptaxAdam`, optax's
Adam. The whole video fits in one loop on the device the helper's basis
lives on (`data/face3d.py:Face3DHelper(device=)`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
from genefaceplusplus_tpu_torch.data.landmarks import (
    INDEX_EYE_FROM_LM478,
    INDEX_INNERLIP_FROM_LM478,
    INDEX_OUTERLIP_FROM_LM478,
    UNMATCH_MASK_FROM_LM478,
)
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam

KEYS = ("id", "exp", "euler", "trans")
POSE_KEYS = ("euler", "trans")


def landmark_weights(n_points: int) -> np.ndarray:
    """Per-landmark loss weights (fit_3dmm_landmark.py:93-111): eyes x5,
    lips x3, unmatched boundary x0, normalised to mean 1."""
    w = np.ones(n_points, np.float32)
    if n_points >= 468:
        w[INDEX_EYE_FROM_LM478] = 5.0
        w[INDEX_INNERLIP_FROM_LM478] = 3.0
        w[INDEX_OUTERLIP_FROM_LM478] = 3.0
        w[UNMATCH_MASK_FROM_LM478] = 0.0
    else:  # lm68: eyes 36-47, mouth 48-67
        w[36:48] = 5.0
        w[48:68] = 3.0
    return w / w.mean()


def laplacian_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean squared temporal second difference over axis 0."""
    if x.shape[0] < 3:
        return x.new_zeros(())
    lap = x[:-2] - 2 * x[1:-1] + x[2:]
    return (lap ** 2).mean()


@dataclasses.dataclass
class FitConfig:
    lr_pose: float = 0.1
    lr_joint: float = 0.01
    iters_pose: int = 200
    iters_joint: int = 200
    lambda_lap: float = 0.3
    lambda_reg_id: float = 0.001
    lambda_reg_exp: float = 0.001


class _Coeffs(torch.nn.Module):
    def __init__(self, T: int, like: torch.Tensor, init: Optional[Dict[str, np.ndarray]]):
        super().__init__()
        shapes = {"id": (1, 80), "exp": (T, 64), "euler": (T, 3), "trans": (T, 3)}
        for k in KEYS:
            v = torch.zeros(shapes[k])
            if init and k in init:
                v = torch.as_tensor(np.asarray(init[k], np.float32)).reshape(shapes[k])
            self.register_parameter(k, torch.nn.Parameter(v.to(like)))


def fit_3dmm_for_video(
    lm2d: np.ndarray,  # [T, K, 2] detected landmarks in [0, 1]
    helper: Face3DHelper,
    cfg: FitConfig = FitConfig(),
    init: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Fit BFM coefficients to a landmark track on the helper's device, in
    its basis's float type.
    Returns the binarizer's dict as numpy: id [T, 80] (the shared row
    repeated), exp [T, 64], euler [T, 3], trans [T, 3], and the last
    iteration's loss of each phase, `final_loss` and `pose_loss`."""
    T, K, _ = lm2d.shape
    like = helper.key_mean_shape  # the device and float type of the fit
    target = torch.as_tensor(np.asarray(lm2d, np.float32)).to(like)
    w = torch.as_tensor(landmark_weights(K)).to(like)[None, :, None]
    coeffs = _Coeffs(T, like, init)
    params = dict(coeffs.named_parameters())

    def loss_fn(joint: bool) -> torch.Tensor:
        p = params
        pred = helper.reconstruct_lm2d(p["id"].expand(T, 80), p["exp"], p["euler"], p["trans"])
        lan = (w * (pred - target) ** 2).mean()
        reg = cfg.lambda_reg_id * (p["id"] ** 2).mean() + cfg.lambda_reg_exp * (p["exp"] ** 2).mean()
        lap = laplacian_loss(p["euler"]) + laplacian_loss(p["trans"])
        if joint:
            lap = lap + laplacian_loss(p["exp"])
        return lan + reg + cfg.lambda_lap * lap

    def run_phase(lr: float, iters: int, keys, joint: bool) -> float:
        opt = OptaxAdam(coeffs, lr, collection=None)
        zeros = {k: torch.zeros_like(v) for k, v in params.items() if k not in keys}
        loss = None
        for _ in range(iters):
            loss = loss_fn(joint)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            for k, g in zip(keys, grads):
                params[k].grad = g
            for k, z in zeros.items():
                params[k].grad = z
            opt.step()
        return float(loss.detach()) if loss is not None else float("nan")

    pose_loss = run_phase(cfg.lr_pose, cfg.iters_pose, POSE_KEYS, joint=False)
    joint_loss = run_phase(cfg.lr_joint, cfg.iters_joint, KEYS, joint=True)

    out = {k: params[k].detach().cpu().numpy().astype(np.float32) for k in KEYS}
    out["id"] = np.tile(out["id"], (T, 1))
    out["final_loss"] = joint_loss
    out["pose_loss"] = pose_loss
    return out


def exp_displacement_px(helper: Face3DHelper, fit: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                        size: int) -> float:
    """The largest landmark displacement, in pixels of a `size` frame, that
    `fit`'s exp alone makes against `ref`'s: both reprojected through
    `helper` with ref's id, euler and trans. Where exp moves along
    directions that the pose takes up, the coefficients differ while this
    stays small: it reads what the expression does to the landmarks."""
    base = helper.key_exp_base

    def lm(exp):
        t = [torch.as_tensor(np.asarray(x), dtype=base.dtype, device=base.device)
             for x in (ref["id"], exp, ref["euler"], ref["trans"])]
        return helper.reconstruct_lm2d(*t).cpu().double().numpy()

    return float(np.abs(lm(fit["exp"]) - lm(ref["exp"])).max() * size)
