"""Multi-resolution tiled / hash grid encoder, plain PyTorch (port of
`genefaceplusplus_tpu/ops/grid_encoder.py`).

The level layout (`GridSpec.create`: offsets, 8-row alignment,
`per_level_scale` from `desired_resolution`), the position math (`pos =
x * scale + 0.5`, `scale = exp2(level * S) * H - 1`), the dense index until
it overflows the level's table and the hash past it, linear or smoothstep
interpolation, and zero features for inputs outside [0, 1] are JAX's.

Two departures in form, none in value:

- JAX hashes and wraps in uint32. Torch has no `%` and no indexing for
  uint32, so the indices are int64 masked to 32 bits after every product
  and sum (and the corner itself, so a negative corner wraps as
  `astype(uint32)` wraps). The hash's products are split at 16 bits so no
  int64 product overflows. Every row equals JAX's, out-of-bounds points
  included.
- JAX gathers every (level, corner) at once through an [N, L * 2^D] index
  tensor. Here each level gathers its 2^D corners on its own and writes
  its own `level_dim` output columns, so a 512^2 frame's 2.6M points peak at
  a few hundred MB a level instead of gigabytes. The corners of a level
  are summed as in JAX (`grid_encode`'s sum over 2^D). Within a level the
  index arithmetic runs once a point, not once a corner (`_level`).

The backward is `GridEncodeFunction`'s (the reference's CUDA
`grid_encode_backward` does the same): its forward is `grid_encode` run
without a graph and saves only the inputs and the table; its backward
recomputes each level's rows and weights, one level at a time, scatters
grad x weight into the table's gradient with `index_add_` (rows that
repeat within a point, from a hash collision or a small level's dense
index, sum), and returns the inputs' gradient through the weights'
derivative, zero outside [0, 1] as JAX's `where(oob, 0, w)` gives.
Autograd through `grid_encode` itself (it keeps every level's rows,
weights and gathered corners) is the plain version the tests hold it to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static configuration of a grid encoder (one per field)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    per_level_scale: float = 2.0
    log2_hashmap_size: int = 19
    gridtype: str = "tiled"  # 'tiled' | 'hash'
    align_corners: bool = False
    interpolation: str = "linear"  # 'linear' | 'smoothstep'
    offsets: Tuple[int, ...] = ()  # L + 1 row offsets into the embedding table

    @classmethod
    def create(cls, input_dim: int = 3, num_levels: int = 16, level_dim: int = 2,
               base_resolution: int = 16, per_level_scale: float = 2.0, log2_hashmap_size: int = 19,
               desired_resolution=None, gridtype: str = "tiled", align_corners: bool = False,
               interpolation: str = "linear") -> "GridSpec":
        if desired_resolution is not None:
            per_level_scale = float(np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
        max_params = 2 ** log2_hashmap_size
        offsets, offset = [0], 0
        for lvl in range(num_levels):
            resolution = int(np.ceil(base_resolution * per_level_scale ** lvl))
            n = min(max_params, (resolution if align_corners else resolution + 1) ** input_dim)
            offset += int(np.ceil(n / 8) * 8)  # 8-row alignment
            offsets.append(offset)
        return cls(input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
                   base_resolution=base_resolution, per_level_scale=per_level_scale,
                   log2_hashmap_size=log2_hashmap_size, gridtype=gridtype, align_corners=align_corners,
                   interpolation=interpolation, offsets=tuple(offsets))

    @property
    def n_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_scale(self, level: int) -> float:
        return math.exp2(level * math.log2(self.per_level_scale)) * self.base_resolution - 1.0

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1


def _corner_bits(input_dim: int, device=None) -> torch.Tensor:
    """[2^D, D] binary corner offsets (bit d of corner c is (c >> d) & 1) as
    bool, made on `device` (no copy from the host, which would wait for the
    device's queue)."""
    c = torch.arange(2 ** input_dim, device=device)
    return torch.stack([(c >> d) & 1 for d in range(input_dim)], dim=-1).bool()


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2^32 for int64 a in [0, 2^32) and 0 <= b < 2^32, with no
    int64 product past 2^49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _level_parts(x01: torch.Tensor, spec: GridSpec, lvl: int):
    """(rows [N, 2^D] int64, per-dim weights: D tensors [N, 2^D], the
    unsmoothed fraction t [N, D]) of one level.

    Modulo 2^32 a corner's index is a function of the cell's corner and
    its bits: the dense index is the cell's (sum_d pg_d * stride_d) plus
    the corner's constant offset, and the hash xors, for each dim, one of
    the two products pg_d * prime_d and (pg_d + 1) * prime_d. So the
    per-point work is done once on [N], and only the last sum or xor, the
    modulo and the weights' products run on [N, 2^D] (as broadcasts, not
    gathers)."""
    D = spec.input_dim
    sel = _corner_bits(D, x01.device)  # [2^D, D]
    size = spec.offsets[lvl + 1] - spec.offsets[lvl]
    stride_dim = spec.level_resolution(lvl) + (0 if spec.align_corners else 1)
    pos = x01 * spec.level_scale(lvl) + (0.0 if spec.align_corners else 0.5)
    pg = torch.floor(pos)
    t = pos - pg
    frac = t * t * (3.0 - 2.0 * t) if spec.interpolation == "smoothstep" else t
    pg = pg.to(torch.int64) & _U32  # the corner's uint32 wrap
    # the dense stride of each dim, 0 once it passes the table; the dense
    # index overflows the table when the whole cube does
    strides, stride = [], 1
    for _ in range(D):
        strides.append(stride if stride <= size else 0)
        stride *= stride_dim
    if spec.gridtype == "hash" and stride > size:
        idx = None
        for d in range(D):
            h0 = _mul_u32(pg[:, d:d + 1], PRIMES[d])
            h = torch.where(sel[:, d], (h0 + PRIMES[d]) & _U32, h0)  # [N, 2^D]
            idx = h if idx is None else idx ^ h
    else:
        base = sum(pg[:, d:d + 1] * strides[d] for d in range(D) if strides[d]) & _U32  # each product < 2^51
        corner = sum(sel[:, d].to(torch.int64) * strides[d] for d in range(D))  # [2^D]
        idx = (base + corner) & _U32
    rows = idx % size + spec.offsets[lvl]
    wds = [torch.where(sel[:, d], frac[:, d:d + 1], 1.0 - frac[:, d:d + 1]) for d in range(D)]
    return rows, wds, t


def _level(x01: torch.Tensor, spec: GridSpec, lvl: int):
    """(rows [N, 2^D] int64, weights [N, 2^D] float32) of one level: the
    weights are prod_d (frac_d or 1 - frac_d), in JAX's order over d."""
    rows, wds, _ = _level_parts(x01, spec, lvl)
    w = wds[0]
    for wd in wds[1:]:
        w = w * wd
    return rows, w


def grid_indices_and_weights(x01: torch.Tensor, spec: GridSpec):
    """All levels' (rows [N, L * 2^D] int64, weights [N, L * 2^D] float32),
    level-major as JAX's; weights 0 for inputs outside [0, 1]. For tests:
    `grid_encode` runs one level at a time."""
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)
    rows, weights = zip(*(_level(x01.float(), spec, lvl) for lvl in range(spec.num_levels)))
    w = torch.cat(weights, dim=-1)
    return torch.cat(rows, dim=-1), torch.where(oob, torch.zeros_like(w), w)


def grid_encode(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec, bound: float = 1.0) -> torch.Tensor:
    """Coordinates [..., D] in [-bound, bound] -> features [..., L * C],
    level-major."""
    prefix = x.shape[:-1]
    x01 = ((x.reshape(-1, spec.input_dim) + bound) / (2.0 * bound)).float()
    keep = (~((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)).to(embeddings.dtype)
    N, C = x01.shape[0], spec.level_dim
    out = embeddings.new_empty((N, spec.num_levels, C))
    for lvl in range(spec.num_levels):
        rows, w = _level(x01, spec, lvl)
        corners = embeddings.index_select(0, rows.reshape(-1)).view(*rows.shape, C)
        out[:, lvl] = (corners * w.to(embeddings.dtype)[..., None]).sum(dim=1)
    return (out.view(N, -1) * keep).reshape(*prefix, spec.output_dim)  # 0 outside the grid


class GridEncodeFunction(torch.autograd.Function):
    """`grid_encode` with a backward that recomputes each level (module
    docstring): `GridEncodeFunction.apply(x, embeddings, spec, bound)`."""

    @staticmethod
    def forward(ctx, x, embeddings, spec, bound):
        ctx.save_for_backward(x, embeddings)
        ctx.spec, ctx.bound = spec, bound
        return grid_encode(x, embeddings, spec, bound=bound)

    @staticmethod
    def backward(ctx, grad_out):
        x, embeddings = ctx.saved_tensors
        spec, bound = ctx.spec, ctx.bound
        D, C, L = spec.input_dim, spec.level_dim, spec.num_levels
        x01 = ((x.reshape(-1, D) + bound) / (2.0 * bound)).float()
        keep = ~((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)
        g = (grad_out.reshape(-1, L, C) * keep[:, :, None]).to(embeddings.dtype)  # 0 outside the grid
        sel = _corner_bits(D, x.device)
        need_x, need_table = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        g_table = torch.zeros_like(embeddings) if need_table else None
        g_x01 = torch.zeros_like(x01) if need_x else None
        for lvl in range(L):
            rows, wds, t = _level_parts(x01, spec, lvl)
            g_lvl = g[:, lvl]  # [N, C]
            if need_table:
                w = wds[0]
                for wd in wds[1:]:
                    w = w * wd
                g_table.index_add_(0, rows.reshape(-1), (w.to(g.dtype)[..., None] * g_lvl[:, None, :]).reshape(-1, C))
            if need_x:  # d out / d w_k, then through w_k = prod_d wd_d
                corners = embeddings.index_select(0, rows.reshape(-1)).view(*rows.shape, C)
                g_w = (corners * g_lvl[:, None, :]).sum(dim=-1).float()  # [N, 2^D]
                dfrac = 6.0 * t * (1.0 - t) if spec.interpolation == "smoothstep" else None
                for d in range(D):
                    others = None
                    for e in range(D):
                        if e != d:
                            others = wds[e] if others is None else others * wds[e]
                    signed = torch.where(sel[:, d], g_w, -g_w)
                    gd = (signed if others is None else signed * others).sum(dim=-1)
                    if dfrac is not None:
                        gd = gd * dfrac[:, d]
                    g_x01[:, d] += gd * spec.level_scale(lvl)
        g_x = None
        if need_x:
            g_x = (g_x01 * keep / (2.0 * bound)).to(x.dtype).reshape(x.shape)
        return g_x, g_table, None, None
