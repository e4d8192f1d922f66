"""Sequence collation and padding (the port's copy of
`genefaceplusplus_tpu/utils/seq.py`, numpy): batching clips of different
lengths."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def collate_1d(values: List[np.ndarray], pad_value: float = 0.0, max_len: Optional[int] = None) -> np.ndarray:
    """[T_i] each -> [B, max_T] padded with `pad_value`."""
    size = max_len or max(len(v) for v in values)
    out = np.full((len(values), size), pad_value, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        out[i, : len(v)] = v
    return out


def collate_2d(values: List[np.ndarray], pad_value: float = 0.0, max_len: Optional[int] = None) -> np.ndarray:
    """[T_i, C] each -> [B, max_T, C] padded with `pad_value`."""
    size = max_len or max(len(v) for v in values)
    C = np.asarray(values[0]).shape[1]
    out = np.full((len(values), size, C), pad_value, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        out[i, : len(v)] = v
    return out


def sequence_mask(lengths: np.ndarray, max_len: Optional[int] = None) -> np.ndarray:
    """[B] lengths -> [B, T] bool mask."""
    size = max_len or int(np.max(lengths))
    return np.arange(size)[None, :] < np.asarray(lengths)[:, None]


def expand_by_repeat_times(x: np.ndarray, repeats: np.ndarray) -> np.ndarray:
    """Each row x[i] repeated repeats[i] times along axis 0."""
    return np.repeat(x, repeats, axis=0)
