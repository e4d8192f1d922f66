"""Where the port's entry points run, and its full-float32 convolution."""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
from torch import nn

IntOrSeq = Union[int, Sequence[int]]


def resolve_device(device=None) -> torch.device:
    """`device` when one is named, else the CUDA card. With no card and no
    device named this raises: the entry points run on the CPU only when the
    caller asks for it (`device="cpu"`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@contextlib.contextmanager
def cudnn_tf32_off():
    """cuDNN's float32 convolutions in full float32 for the block, whatever
    `torch.backends.cudnn.allow_tf32` says (its default runs them in TF32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Float32Convolution(torch.autograd.Function):
    """`aten.convolution` whose forward and backward both run under
    `cudnn_tf32_off`: autograd runs a backward after the caller's block has
    been left, so a guard around the forward call alone leaves the input and
    weight gradients in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, transposed, output_padding, groups):
        ctx.conv = (stride, padding, dilation, transposed, output_padding, groups)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        ctx.save_for_backward(x, weight)
        with cudnn_tf32_off():
            return torch.ops.aten.convolution(x, weight, bias, stride, padding, dilation, transposed,
                                              output_padding, groups)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.bias_sizes is not None and ctx.needs_input_grad[2]]
        with cudnn_tf32_off():
            gx, gw, gb = torch.ops.aten.convolution_backward(grad_out.contiguous(), x, weight, ctx.bias_sizes,
                                                             *ctx.conv, mask)
        return gx, gw, gb, None, None, None, None, None, None


def _tuple(v: IntOrSeq, n: int) -> list:
    return [int(v)] * n if isinstance(v, int) else [int(x) for x in v]


def conv_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
             stride: IntOrSeq = 1, padding: IntOrSeq = 0, dilation: IntOrSeq = 1, groups: int = 1,
             transposed: bool = False, output_padding: IntOrSeq = 0) -> torch.Tensor:
    """`F.conv{1,2}d` (or, with `transposed`, `F.conv_transpose{1,2}d`) of
    float32 tensors in full float32, forward and backward, whatever
    `torch.backends.cudnn.allow_tf32` says. Other dtypes run as they are."""
    n = x.dim() - 2
    args = (_tuple(stride, n), _tuple(padding, n), _tuple(dilation, n), transposed,
            _tuple(output_padding, n), groups)
    if x.dtype != torch.float32:
        return torch.ops.aten.convolution(x, weight, bias, *args)
    return _Float32Convolution.apply(x, weight, bias, *args)


class Float32Conv:
    """A convolution module mixin (before `nn.Conv1d`, `nn.Conv2d`): its
    float32 calls run through `conv_f32`, zero padding only."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        if self.padding_mode != "zeros":
            raise ValueError(f"padding_mode {self.padding_mode!r}: only zero padding")
        return conv_f32(x, weight, bias, self.stride, self.padding, self.dilation, self.groups)


class Conv2d(Float32Conv, nn.Conv2d):
    """`nn.Conv2d` in full float32 (`conv_f32`)."""
