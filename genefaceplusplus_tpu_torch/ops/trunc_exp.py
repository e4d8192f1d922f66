"""exp with a gradient-clamped backward (port of
`genefaceplusplus_tpu/ops/trunc_exp.py`, the instant-NGP trick): forward
exp(x) in float32, backward g * exp(clip(x, -15, 15))."""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x32)
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x32, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
