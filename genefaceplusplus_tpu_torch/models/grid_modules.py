"""The grid encoder as a module that owns its embedding table (port of
`genefaceplusplus_tpu/models/grid_modules.py`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from genefaceplusplus_tpu_torch.ops.grid_encoder import GridEncodeFunction, GridSpec, grid_encode


class GridEncoder(nn.Module):
    """Owns the [n_rows, level_dim] table `embeddings` (JAX's leaf name, so
    the weight bridge carries it as it is), initialised U(-1e-4, 1e-4) from
    `generator`. With autograd on it encodes through `GridEncodeFunction`
    (its backward recomputes each level; nothing but the inputs and the
    table is kept for it); under `no_grad` through `grid_encode`."""

    def __init__(self, spec: GridSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.embeddings = nn.Parameter(
            torch.rand(spec.n_rows, spec.level_dim, generator=generator) * 2e-4 - 1e-4)

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def forward(self, x: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        if torch.is_grad_enabled():
            return GridEncodeFunction.apply(x, self.embeddings, self.spec, bound)
        return grid_encode(x, self.embeddings, self.spec, bound=bound)
