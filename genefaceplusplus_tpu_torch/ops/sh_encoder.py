"""Real spherical-harmonics basis of direction vectors, degree <= 4
(port of `genefaceplusplus_tpu/ops/sh_encoder.py`, same constants and
evaluation order)."""

from __future__ import annotations

import torch


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """d: [..., 3] unit directions -> [..., degree**2] SH basis values."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in [1, 4], got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree > 3:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)
