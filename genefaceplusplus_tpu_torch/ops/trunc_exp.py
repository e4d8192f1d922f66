"""exp in float32 (forward of `genefaceplusplus_tpu/ops/trunc_exp.py`).

Only the forward is ported: the serving path takes no gradient. The
clamped backward arrives with training (ROADMAP queue A, training)."""

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.float())
