"""Bias + activation + gain + clamp (port of
`genefaceplusplus_tpu/ops/bias_act.py`): an elementwise chain, no kernel.

The bias broadcasts along `dim`, channel dimension 1 by default, as in the
reference's torch `bias_act` (the JAX version's NHWC layout has it last).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# def_gain per activation (bias_act.activation_funcs)
ACT_GAINS = {
    "linear": 1.0,
    "relu": math.sqrt(2.0),
    "lrelu": math.sqrt(2.0),
    "tanh": 1.0,
    "sigmoid": 1.0,
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, act: str = "linear",
             alpha: float = 0.2, gain: Optional[float] = None, clamp: Optional[float] = None,
             dim: int = 1) -> torch.Tensor:
    """x + b (along `dim`) -> act -> * gain -> clamp to +-clamp."""
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    if act == "relu":
        x = torch.clamp(x, min=0)
    elif act == "lrelu":
        x = torch.where(x >= 0, x, x * alpha)
    elif act == "tanh":
        x = torch.tanh(x)
    elif act == "sigmoid":
        x = 1.0 / (1.0 + torch.exp(-x))
    elif act != "linear":
        raise NotImplementedError(act)
    g = ACT_GAINS[act] if gain is None else gain
    if g != 1.0:
        x = x * g
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x
