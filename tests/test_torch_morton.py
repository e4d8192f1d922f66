"""The port's morton codes and packed occupancy bitfield
(`genefaceplusplus_tpu_torch/ops/morton.py`) against the JAX package's
(`genefaceplusplus_tpu/ops/morton.py`), on the CPU.

Tolerances: exact everywhere (integer codes, permutations, bits; the
float grids are moved, not computed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops import morton as jm
from genefaceplusplus_tpu_torch.ops import morton as tm


def _interleave(x, y, z, bits=10):
    """Bit b of x, y, z at bits 3b, 3b + 1, 3b + 2 of the code, one bit at a
    time (independent of either package)."""
    code = 0
    for b in range(bits):
        code |= ((x >> b) & 1) << (3 * b) | ((y >> b) & 1) << (3 * b + 1) | ((z >> b) & 1) << (3 * b + 2)
    return code


def test_morton3d_and_its_inverse_match_jax_and_an_independent_interleave():
    rs = np.random.RandomState(0)
    coords = np.concatenate([rs.randint(0, 1024, (500, 3)), [[0, 0, 0], [1023, 1023, 1023], [1, 2, 4]]])
    got = tm.morton3d(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.morton3d(jnp.asarray(coords))).astype(np.int64))
    np.testing.assert_array_equal(got, [_interleave(*c) for c in coords.tolist()])
    back = tm.morton3d_invert(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, coords)
    np.testing.assert_array_equal(back, np.asarray(jm.morton3d_invert(jnp.asarray(got.astype(np.uint32)))))


@pytest.mark.parametrize("H", [4, 16])
def test_grids_and_bitfields_match_jax(H):
    rs = np.random.RandomState(H)
    np.testing.assert_array_equal(tm.morton_permutation(H).numpy(), jm.morton_permutation(H))
    grid = rs.rand(2, H, H, H).astype(np.float32)
    mort = tm.spatial_to_morton(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(mort, np.asarray(jm.spatial_to_morton(jnp.asarray(grid))))
    np.testing.assert_array_equal(tm.morton_to_spatial(torch.from_numpy(mort), H).numpy(), grid)
    np.testing.assert_array_equal(tm.morton_to_spatial(torch.from_numpy(mort), H).numpy(),
                                  np.asarray(jm.morton_to_spatial(jnp.asarray(mort), H)))
    bits = tm.packbits(torch.from_numpy(mort.reshape(-1)), 0.5)
    assert bits.dtype == torch.uint8 and bits.shape == (2 * H ** 3 // 8,)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jm.packbits(jnp.asarray(mort.reshape(-1)), 0.5)))
    np.testing.assert_array_equal(tm.unpackbits(bits).numpy(), np.asarray(jm.unpackbits(jnp.asarray(bits.numpy()))))
    occ = grid > 0.5
    field = tm.occupancy_to_bitfield(torch.from_numpy(occ))
    np.testing.assert_array_equal(field.numpy(), np.asarray(jm.occupancy_to_bitfield(jnp.asarray(occ))))
    np.testing.assert_array_equal(field.numpy(), bits.numpy())
    back = tm.bitfield_to_occupancy(field, 2, H)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), occ)  # bitfield_to_occupancy(occupancy_to_bitfield(x)) == x
    np.testing.assert_array_equal(back.numpy(), np.asarray(jm.bitfield_to_occupancy(jnp.asarray(field.numpy()), 2, H)))


def test_packbits_is_lsb_first():
    flat = torch.zeros(16)
    flat[[0, 3, 15]] = 1.0
    assert tm.packbits(flat, 0.5).tolist() == [1 | 8, 128]
