"""SECC (Semantic-Encoded Color Coding) debug rendering (port of
`genefaceplusplus_tpu/data/secc.py`).

The reference's SECC_Renderer (deep_3drecon/secc_renderer.py) renders the
BFM face mesh with per-vertex NCC colours: the canonical vertex position
min-max normalised to [0, 1]^3. Only `--debug` uses it. Without the full
BFM mesh this is a depth-sorted point splat of the key points, as in JAX;
`data/bfm_render.py:SECCRenderer` rasterises the mesh where it exists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def ncc_colors(canonical_vertices: np.ndarray) -> np.ndarray:
    """Per-vertex NCC color = min-max normalised canonical position [N,3]."""
    v = np.asarray(canonical_vertices, np.float32)
    lo, hi = v.min(0, keepdims=True), v.max(0, keepdims=True)
    return (v - lo) / np.maximum(hi - lo, 1e-8)


def render_secc(
    vertices_cam: np.ndarray,  # [N, 3] camera-space vertices (z > 0 toward cam)
    colors: Optional[np.ndarray] = None,  # [N, 3] in [0,1]; default NCC
    size: int = 224,
    focal: float = 1015.0,
    center: float = 112.0,
    splat: int = 2,
) -> np.ndarray:
    """Depth-sorted splat render -> uint8 RGB [size, size, 3] (black bg)."""
    v = np.asarray(vertices_cam, np.float32)
    if colors is None:
        colors = ncc_colors(v)
    z = np.maximum(v[:, 2], 1e-3)
    x = (v[:, 0] * focal / z + center) * (size / 224.0)
    y = (size - 1) - (v[:, 1] * focal / z + center) * (size / 224.0)

    order = np.argsort(-z)  # far first; near overwrites
    img = np.zeros((size, size, 3), np.float32)
    xi = np.clip(x[order].astype(np.int32), 0, size - 1)
    yi = np.clip(y[order].astype(np.int32), 0, size - 1)
    c = np.asarray(colors, np.float32)[order]
    for dy in range(-(splat // 2), splat // 2 + 1):
        for dx in range(-(splat // 2), splat // 2 + 1):
            img[np.clip(yi + dy, 0, size - 1), np.clip(xi + dx, 0, size - 1)] = c
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_secc_from_coeffs(helper, id_coeff, exp_coeff, euler, trans, size: int = 224):
    """Debug panel from fitted coefficients through the key-point subset of
    the basis (`data/face3d.py:Face3DHelper`; the full 35709-vertex basis
    needs the licensed BFM .mat)."""
    like = helper.key_mean_shape

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(like)

    lm3d = helper.reconstruct_key_lm3d(t(id_coeff), t(exp_coeff), t(euler), t(trans), to_camera=True)
    v = lm3d[0].cpu().numpy()
    colors = ncc_colors(helper.key_mean_shape.cpu().numpy())
    return render_secc(v, colors, size=size, splat=4)
