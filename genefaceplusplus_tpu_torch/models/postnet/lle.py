"""Locally-linear-embedding projection of predicted landmarks onto the
identity's training landmarks (port of
`genefaceplusplus_tpu/models/postnet/lle.py`).

Brute-force L2 K nearest neighbours, then the constrained least squares
(weights sum to 1) by normal equations with a Tikhonov ridge, as
scikit-learn's LLE conditions it. Tensor functions on the inputs' device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sq_dists(feats: torch.Tensor, feat_database: torch.Tensor) -> torch.Tensor:
    d_norm = (feat_database ** 2).sum(-1)
    f_norm = (feats ** 2).sum(-1)
    return f_norm[:, None] + d_norm[None, :] - 2.0 * feats @ feat_database.T


def find_k_nearest_neighbors(feats: torch.Tensor, feat_database: torch.Tensor, K: int = 10) -> torch.Tensor:
    """feats [N, C], database [M, C] -> [N, K] indices of the nearest rows,
    nearest first and ties to the lower index, as `jax.lax.top_k` orders
    them (`torch.topk` leaves the order of ties unspecified)."""
    return torch.sort(_sq_dists(feats, feat_database), dim=-1, stable=True).indices[:, :K]


def solve_lle_projection_batch(feat: torch.Tensor, feat_base: torch.Tensor, reg: float = 1e-4
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """feat [N, C], feat_base [N, K, C] -> (feat_fuse [N, C], errors [N],
    weights [N, K]). The first neighbour is the base row of the solve. The
    Gram matrix gets a relative ridge, reg * trace (+ 1e-12 for identical
    neighbours): without it a neighbourhood spanning fewer than K - 1
    dimensions makes the solve singular and the condition NaN."""
    N, K, C = feat_base.shape
    if K == 1:
        return feat_base[:, 0], feat.new_zeros((N,)), feat.new_ones((N, 1))
    B = feat - feat_base[:, 0, :]  # [N, C]
    A = (feat_base[:, 1:, :] - feat_base[:, 0:1, :]).transpose(1, 2)  # [N, C, K-1]
    AT = A.transpose(1, 2)  # [N, K-1, C]
    ATA = AT @ A  # [N, K-1, K-1]
    ATB = AT @ B[..., None]  # [N, K-1, 1]
    ridge = reg * ATA.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-12  # [N]
    ATA = ATA + ridge[:, None, None] * torch.eye(K - 1, dtype=ATA.dtype, device=ATA.device)
    X = torch.linalg.solve(ATA, ATB)[..., 0]  # [N, K-1]
    w0 = 1.0 - X.sum(dim=-1, keepdim=True)
    weights = torch.cat([w0, X], dim=-1)  # [N, K]
    feat_fuse = (weights[:, None, :] @ feat_base)[:, 0]  # [N, C]
    errors = ((A @ X[..., None])[..., 0] - B).abs().mean(dim=-1)
    return feat_fuse, errors, weights


def compute_lle_projection(feats: torch.Tensor, feat_database: torch.Tensor, K: int = 10
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project each feat onto the affine hull of its K nearest database rows."""
    idx = find_k_nearest_neighbors(feats, feat_database, K)
    return solve_lle_projection_batch(feats, feat_database[idx])
