"""Training losses for the RAD-NeRF tasks (port of
`genefaceplusplus_tpu/training/losses.py`): mse, psnr, weights entropy,
masked ambient, the ambient ramp and the adaptive lambda_ambient
controller."""

from __future__ import annotations

import math

import torch


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def weights_entropy_loss(weights_sum: torch.Tensor) -> torch.Tensor:
    """Mean binary entropy (log2) of per-ray opacity."""
    a = torch.clamp(weights_sum, 1e-5, 1.0 - 1e-5)
    return torch.mean(-a * torch.log2(a) - (1.0 - a) * torch.log2(1.0 - a))


def ambient_loss(ambient_sum: torch.Tensor, face_mask: torch.Tensor, mode: str = "mae") -> torch.Tensor:
    """|ambient| outside the face polygon, normalised by count + 1 (mae|mse)."""
    outside = ~face_mask.reshape(-1)
    amb = ambient_sum.reshape(-1)
    v = amb ** 2 if mode == "mse" else torch.abs(amb)
    return (v * outside).sum() / (outside.sum() + 1)


def ambient_ramp(global_step, total: int = 250_000):
    """Ramp lambda_ambient in over training: min(step / total, 1)."""
    return min(float(global_step) / total, 1.0)


def adaptive_lambda_ambient(lambda_ambient: torch.Tensor, ambient_loss_value: torch.Tensor,
                            target: float, lr: float = 0.01) -> torch.Tensor:
    """Log10-difference feedback toward target_ambient_loss:
    lambda += lr * (log10(loss + 1e-15) - log10(target + 1e-15)), clamped to [0, 1000]."""
    grad = torch.log10(ambient_loss_value + 1e-15) - math.log10(target + 1e-15)
    return torch.clamp(lambda_ambient + lr * grad, 0.0, 1000.0)
