"""Where the port's entry points run."""

from __future__ import annotations

import contextlib

import torch


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
