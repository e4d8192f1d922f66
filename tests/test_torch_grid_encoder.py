"""The port's grid encoder (`genefaceplusplus_tpu_torch/ops/grid_encoder.py`,
`models/grid_modules.py`) against the JAX package's
(`genefaceplusplus_tpu/ops/grid_encoder.py`), on the CPU.

Small specs (2 levels, tables of 2^8 rows for the hash case, so its dense
index overflows and it hashes) over points drawn in [-1.2, 1.2]^D, so
some lie outside the grid. Tolerances:
- rows: exact, out-of-bounds points included;
- interpolation weights: 1e-6;
- features: 1e-5 of the largest |feature|;
- the table's gradient (autograd against `jax.grad`): 1e-5 of its largest
  entry;
- the May spec's offsets: exact."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops import grid_encoder as J
from genefaceplusplus_tpu_torch.models.grid_modules import GridEncoder
from genefaceplusplus_tpu_torch.ops import grid_encoder as T

CASES = list(itertools.product(("tiled", "hash"), (2, 3), ("linear", "smoothstep"), (False, True)))


@pytest.mark.parametrize("gridtype,D,interpolation,align_corners", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_grid_encoder_matches_jax(gridtype, D, interpolation, align_corners):
    kw = dict(input_dim=D, num_levels=2, level_dim=2, base_resolution=8, desired_resolution=24,
              log2_hashmap_size=8 if gridtype == "hash" else 12, gridtype=gridtype,
              align_corners=align_corners, interpolation=interpolation)
    js, ts = J.GridSpec.create(**kw), T.GridSpec.create(**kw)
    assert ts.offsets == js.offsets and ts.per_level_scale == js.per_level_scale
    assert [ts.level_resolution(i) for i in range(2)] == [js.level_resolution(i) for i in range(2)]
    rs = np.random.RandomState(D * 8 + len(interpolation) + align_corners)
    x = rs.uniform(-1.2, 1.2, (200, D)).astype(np.float32)
    emb = rs.randn(js.n_rows, 2).astype(np.float32)
    x01 = (x + 1.0) / 2.0
    assert ((x01 < 0) | (x01 > 1)).any(axis=1).sum() > 20

    j_rows, j_w = J.grid_indices_and_weights(jnp.asarray(x01), js)  # eager: jit may fuse a multiply-add
    t_rows, t_w = T.grid_indices_and_weights(torch.from_numpy(x01), ts)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows).astype(np.int64))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-6, rtol=0)

    mix = np.arange(js.output_dim, dtype=np.float32) % 5 - 2.0  # a loss that weighs each level's columns
    j_feat, j_vjp = jax.vjp(lambda e: J.grid_encode(jnp.asarray(x), e, js), jnp.asarray(emb))
    (j_grad,) = j_vjp(jnp.broadcast_to(jnp.asarray(mix), j_feat.shape))
    enc = GridEncoder(ts)
    with torch.no_grad():
        enc.embeddings.copy_(torch.from_numpy(emb))
    t_feat = enc(torch.from_numpy(x))
    (t_feat * torch.from_numpy(mix)).sum().backward()
    scale = np.abs(np.asarray(j_feat)).max()
    np.testing.assert_allclose(t_feat.detach().numpy(), np.asarray(j_feat), atol=1e-5 * scale, rtol=0)
    oob = ((x01 < 0) | (x01 > 1)).any(axis=1)
    assert not t_feat.detach().numpy()[oob].any()  # outside the grid: zero features
    g = np.asarray(j_grad)
    np.testing.assert_allclose(enc.embeddings.grad.numpy(), g, atol=1e-5 * np.abs(g).max(), rtol=0)


@pytest.mark.parametrize("D", [2, 3])
def test_may_spec_offsets_and_init(D):
    """The May head's and torso's spec (16 levels x 2, base 16, log2 16,
    desired resolution 2048): offsets equal JAX's; the table initialises
    within U(-1e-4, 1e-4)."""
    kw = dict(input_dim=D, num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=16,
              desired_resolution=2048, gridtype="tiled")
    js, ts = J.GridSpec.create(**kw), T.GridSpec.create(**kw)
    assert ts == T.GridSpec(**{k: getattr(js, k) for k in js.__dataclass_fields__})
    assert ts.n_rows == js.n_rows and ts.output_dim == 32
    emb = GridEncoder(ts, generator=torch.Generator().manual_seed(0)).embeddings.detach()
    assert emb.shape == (js.n_rows, 2) and float(emb.abs().max()) <= 1e-4 and float(emb.std()) > 4e-5
