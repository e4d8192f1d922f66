"""Masked volumetric compositing with transmittance early termination
(port of `genefaceplusplus_tpu/ops/composite.py`).

alpha_i = 1 - exp(-sigma_i * dt_i); T_i = prod_{j<i} (1 - alpha_j);
sample i is composited iff T_i >= T_thresh (the CUDA loop's break).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeResult(NamedTuple):
    weights_sum: torch.Tensor  # [R]
    ambient_sum: torch.Tensor  # [R]
    depth: torch.Tensor  # [R]
    image: torch.Tensor  # [R, 3]
    weights: torch.Tensor  # [R, S]


def composite_rays(sigmas, rgbs, ambient, deltas, ts, mask, T_thresh: float = 1e-4) -> CompositeResult:
    """sigmas/ambient/deltas/ts/mask: [R, S]; rgbs: [R, S, 3]."""
    sigmas = torch.where(mask, sigmas, torch.zeros_like(sigmas))
    alphas = 1.0 - torch.exp(-sigmas * deltas)
    one_minus = 1.0 - alphas
    T = torch.cumprod(torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]], dim=1), dim=1)
    keep = (T >= T_thresh) & mask
    w = alphas * T * keep

    weights_sum = w.sum(dim=-1)
    depth = (w * ts).sum(dim=-1)
    image = (w[..., None] * rgbs).sum(dim=-2)
    ambient_sum = (ambient * keep).sum(dim=-1)
    return CompositeResult(weights_sum, ambient_sum, depth, image, w)


def composite_weights(sigmas, deltas, mask, T_thresh: float = 1e-4):
    """The weights of `composite_rays` without colours: (weights [R, S],
    keep [R, S]). The top-K colour path needs the weights before it picks
    the samples that get a colour."""
    sigmas = torch.where(mask, sigmas, torch.zeros_like(sigmas))
    alphas = 1.0 - torch.exp(-sigmas * deltas)
    one_minus = 1.0 - alphas
    T = torch.cumprod(torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]], dim=1), dim=1)
    keep = (T >= T_thresh) & mask
    return alphas * T * keep, keep


def blend_background(image, weights_sum, bg_color):
    """image += (1 - weights_sum) * bg; clamp to [0, 1]."""
    return torch.clamp(image + (1.0 - weights_sum)[..., None] * bg_color, 0.0, 1.0)


def normalize_depth(depth, nears, fars):
    """(depth - near) / (far - near), clamped at 0."""
    return torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-8)
