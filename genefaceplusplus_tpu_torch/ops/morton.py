"""Morton (Z-order) codes, the packed occupancy bitfield and grid dilation
(port of `genefaceplusplus_tpu/ops/morton.py`).

The reference keeps its density grid in morton order and its occupancy as
a bitfield packed LSB first (`kernel_packbits`); the port's renderer reads
a plain spatial [H, H, H] grid, so these serve the reference's checkpoints
(`utils/convert_torch_ckpt.py`) and `testing.reference_head_state`.

JAX computes the codes in uint32. Torch has no shifts or masks on uint32
it can index with, so codes here are int64 tensors holding the same values
(< 2^30 for coordinates < 2^10).
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] int coords (< 2^10) -> [...] int64 morton codes."""
    return _expand_bits(coords[..., 0]) | (_expand_bits(coords[..., 1]) << 1) | (_expand_bits(coords[..., 2]) << 2)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    return (x | (x >> 16)) & 0x0000FFFF


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """[...] morton codes -> [..., 3] int64 coords."""
    codes = codes.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compact_bits(codes), _compact_bits(codes >> 1), _compact_bits(codes >> 2)], dim=-1)


def morton_permutation(H: int, device=None) -> torch.Tensor:
    """perm [H^3] int64 with grid_morton[perm[i]] == grid_spatial_flat[i] for
    an x-major flattened [H, H, H] grid: spatial index -> morton index."""
    r = torch.arange(H, device=device)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    return morton3d(coords)


def spatial_to_morton(grid_spatial: torch.Tensor) -> torch.Tensor:
    """[CAS, H, H, H] -> [CAS, H^3] in morton order (the reference's layout)."""
    CAS, H = grid_spatial.shape[0], grid_spatial.shape[1]
    flat = grid_spatial.reshape(CAS, -1)
    out = torch.zeros_like(flat)
    out[:, morton_permutation(H, flat.device)] = flat
    return out


def morton_to_spatial(grid_morton: torch.Tensor, H: int) -> torch.Tensor:
    """[CAS, H^3] in morton order -> [CAS, H, H, H] spatial."""
    return grid_morton[:, morton_permutation(H, grid_morton.device)].reshape(grid_morton.shape[0], H, H, H)


_BIT_VALUES = (1, 2, 4, 8, 16, 32, 64, 128)


def packbits(flat: torch.Tensor, thresh: float) -> torch.Tensor:
    """[M] values -> [M // 8] uint8, bit i of byte j set where flat[8j + i] >
    thresh (LSB first, `kernel_packbits`'s order)."""
    bits = (flat > thresh).reshape(-1, 8).to(torch.int64)
    return (bits * torch.tensor(_BIT_VALUES, device=flat.device)).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """[M // 8] uint8 -> [M] bool, LSB first."""
    b = bitfield.to(torch.int64)[:, None]
    return ((b >> torch.arange(8, device=bitfield.device)) & 1).to(torch.bool).reshape(-1)


def bitfield_to_occupancy(bitfield: torch.Tensor, cascade: int, H: int) -> torch.Tensor:
    """The reference's density_bitfield [CAS * H^3 / 8] uint8 -> spatial
    [CAS, H, H, H] bool."""
    return morton_to_spatial(unpackbits(bitfield).reshape(cascade, H * H * H), H)


def occupancy_to_bitfield(occ: torch.Tensor) -> torch.Tensor:
    """Spatial [CAS, H, H, H] bool -> the reference's uint8 bitfield."""
    return packbits(spatial_to_morton(occ.to(torch.float32)).reshape(-1), 0.5)


def dilate6(grid: torch.Tensor) -> torch.Tensor:
    """6-neighbourhood max dilation of [CAS, H, H, H]; an out-of-range
    neighbour is skipped, i.e. the edge value is replicated."""
    out = grid
    for axis in (1, 2, 3):
        n = grid.shape[axis]
        fwd = torch.cat([grid.narrow(axis, 1, n - 1), grid.narrow(axis, n - 1, 1)], dim=axis)
        bwd = torch.cat([grid.narrow(axis, 0, 1), grid.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.maximum(out, torch.maximum(fwd, bwd))
    return out
