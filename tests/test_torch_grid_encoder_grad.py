"""The grid encoder's backward (`GridEncodeFunction`,
`genefaceplusplus_tpu_torch/ops/grid_encoder.py`) against autograd through
the plain `grid_encode` and against `jax.grad` of the JAX package's
`grid_encode`, for the table and for the inputs, on the CPU.

Small specs (4 levels, base 8, desired resolution 64; hash tables of 2^8
rows a level so that it hashes) over points in [-1.2, 1.2]^D, so some lie
outside the grid; the repeated-rows case has tables of 2^3 rows a level,
where several corners of one point land on one row. JAX runs eagerly: under
`jax.jit` XLA fuses `x * scale + 0.5` into one rounding, which moves a
point that lies within an ulp of a cell's edge into the next cell (see
tests/test_torch_grid_encoder.py). Tolerances, of each gradient's largest
entry: 1e-6 against autograd, 1e-5 against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops import grid_encoder as J
from genefaceplusplus_tpu_torch.models.grid_modules import GridEncoder
from genefaceplusplus_tpu_torch.ops import grid_encoder as T

CASES = {
    "tiled-linear": dict(input_dim=3, gridtype="tiled", interpolation="linear", log2_hashmap_size=12),
    "hash-smoothstep": dict(input_dim=3, gridtype="hash", interpolation="smoothstep", log2_hashmap_size=8),
    "tiled-2d": dict(input_dim=2, gridtype="tiled", interpolation="linear", log2_hashmap_size=8),
    "hash-repeated-rows": dict(input_dim=3, gridtype="hash", interpolation="linear", log2_hashmap_size=3),
}


def _inputs(name, spec, n=300):
    rs = np.random.RandomState(len(name))
    x = rs.uniform(-1.2, 1.2, (n, spec.input_dim)).astype(np.float32)
    emb = rs.randn(spec.n_rows, spec.level_dim).astype(np.float32)
    mix = rs.randn(n, spec.output_dim).astype(np.float32)  # the output's gradient
    return x, emb, mix


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_autograd_and_jax(name):
    kw = dict(CASES[name], num_levels=4, level_dim=2, base_resolution=8, desired_resolution=64)
    ts, js = T.GridSpec.create(**kw), J.GridSpec.create(**kw)
    x, emb, mix = _inputs(name, ts)
    x01 = (x + 1.0) / 2.0
    oob = ((x01 < 0) | (x01 > 1)).any(axis=1)
    assert 20 < oob.sum() < len(x) - 100
    if name == "hash-repeated-rows":
        rows, _ = T.grid_indices_and_weights(torch.from_numpy(x01), ts)
        per_level = rows.view(len(x), ts.num_levels, -1)
        repeats = sum(len(set(r.tolist())) < len(r) for r in per_level.reshape(-1, per_level.shape[-1]))
        assert repeats > 100  # one point's corners share rows: index_add_ must sum them

    def port(fn):
        xt = torch.from_numpy(x).requires_grad_()
        et = torch.from_numpy(emb).requires_grad_()
        out = fn(xt, et)
        (out * torch.from_numpy(mix)).sum().backward()
        return out.detach().numpy(), xt.grad.numpy(), et.grad.numpy()

    f_plain, gx_plain, ge_plain = port(lambda a, b: T.grid_encode(a, b, ts))
    f_fn, gx_fn, ge_fn = port(lambda a, b: T.GridEncodeFunction.apply(a, b, ts, 1.0))
    np.testing.assert_array_equal(f_fn, f_plain)
    _close(ge_fn, ge_plain, 1e-6)
    _close(gx_fn, gx_plain, 1e-6)
    assert not gx_fn[oob].any()  # outside the grid: no inputs' gradient
    assert np.abs(gx_fn).max() > 0 and np.abs(ge_fn).max() > 0

    def loss(xj, ej):
        return jnp.sum(J.grid_encode(xj, ej, js) * mix)

    gx_j, ge_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    _close(ge_fn, ge_j, 1e-5)
    _close(gx_fn, gx_j, 1e-5)


def test_module_trains_through_the_function_and_serves_without_it():
    """`GridEncoder` takes the Function with autograd on (its graph keeps the
    Function's node, not the per-level gathers), the plain path under
    no_grad, with equal features; a bound other than 1 scales the inputs'
    gradient by 1 / (2 bound), as autograd's does."""
    spec = T.GridSpec.create(input_dim=3, num_levels=4, base_resolution=8, desired_resolution=64,
                             log2_hashmap_size=8, gridtype="hash")
    enc = GridEncoder(spec, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc.embeddings.mul_(1000.0)
    x = torch.from_numpy(np.random.RandomState(3).uniform(-2, 2, (64, 3)).astype(np.float32)).requires_grad_()
    out = enc(x, bound=2.0)
    assert type(out.grad_fn).__name__ == "GridEncodeFunctionBackward"
    with torch.no_grad():
        served = enc(x, bound=2.0)
    assert served.grad_fn is None and torch.equal(served, out.detach())
    out.square().sum().backward()
    g_fn = x.grad.clone()
    x.grad = None
    T.grid_encode(x, enc.embeddings, spec, bound=2.0).square().sum().backward()
    _close(g_fn.numpy(), x.grad.numpy(), 1e-6)
