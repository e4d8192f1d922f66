"""Windowed condition features (port of `get_audio_features_batch` in
`genefaceplusplus_tpu/utils/audio_features.py`): centred att_mode-2 windows,
zero outside the sequence."""

from __future__ import annotations

import torch


def get_audio_features_batch(features: torch.Tensor, indices: torch.Tensor,
                             smo_win_size: int = 8) -> torch.Tensor:
    """features [T, ...], indices [N] -> windows [N, smo_win_size, ...]."""
    T = features.shape[0]
    left = indices[:, None] - smo_win_size // 2
    offs = left + torch.arange(smo_win_size, device=indices.device)[None, :]
    valid = (offs >= 0) & (offs < T)
    gathered = features[torch.clamp(offs, 0, T - 1)]
    mask = valid.reshape(valid.shape + (1,) * (features.ndim - 1))
    return torch.where(mask, gathered, torch.zeros_like(gathered))
