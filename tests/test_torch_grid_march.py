"""The port's grid-mode marcher (`genefaceplusplus_tpu_torch/ops/raymarch.py`
`march_rays`) against the JAX package's (`genefaceplusplus_tpu/ops/
raymarch.py:354`) and against a sequential per-ray loop of the reference
marcher's documented algorithm, written here independently; on the CPU.

A concave random occupancy of 32^3, 64 forward-ish rays. Tolerances: the
sample mask and each sample's lattice index exact; positions, deltas and
depths within 1e-6 of JAX's; the same sample set as the loop, positions
within 1e-4 (the loop steps t in float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops import raymarch as jr
from genefaceplusplus_tpu_torch.ops import raymarch as tr

H, R = 32, 64


def _scene(seed):
    rng = np.random.RandomState(seed)
    occ = rng.rand(H, H, H) > 0.6
    ro = np.zeros((R, 3), np.float32)
    ro[:, 2] = -2.0
    rd = rng.randn(R, 3).astype(np.float32)
    rd[:, 2] = np.abs(rd[:, 2]) + 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return occ, ro, rd, rng.rand(R).astype(np.float32)


def _loop(ro, rd, near, far, occ, dt, max_samples):
    """One ray: step t on the lattice near + m * dt, keep the positions whose
    voxel is occupied, stop at far or after max_samples."""
    t, out = float(near), []
    while t < far and len(out) < max_samples:
        p = np.clip(ro + t * rd, -1.0, 1.0)
        n = np.clip((0.5 * (p + 1.0) * H).astype(int), 0, H - 1)
        if occ[n[0], n[1], n[2]]:
            out.append(p)
        t += dt
    return out


@pytest.mark.parametrize("dt_gamma,noise,K,S", [(0.0, False, 96, 16), (1 / 256, True, 48, 16), (0.0, False, 8, 16)],
                         ids=["constant-step", "growing-step-noise", "fewer-points-than-samples"])
def test_march_rays_matches_jax(dt_gamma, noise, K, S):
    occ, ro, rd, nz = _scene(K)
    aabb = np.array([-1.0, -0.5, -1.0, 1.0, 0.5, 1.0], np.float32)
    jn, jf = jr.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb), 0.05)
    tn, tf = tr.near_far_from_aabb(torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(aabb), 0.05)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    kw = dict(bound=1.0, dt_gamma=dt_gamma, max_steps=16, num_coarse=K, num_samples=S)
    j = jr.march_rays(jnp.asarray(ro), jnp.asarray(rd), jn, jf, jnp.asarray(occ),
                      noise=jnp.asarray(nz) if noise else None, **kw)
    t = tr.march_rays(torch.from_numpy(ro), torch.from_numpy(rd), tn, tf, torch.from_numpy(occ),
                      noise=torch.from_numpy(nz) if noise else None, **kw)
    assert t.mask.shape == np.asarray(j.mask).shape == (R, min(K, S))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert 0 < int(t.mask.sum()) < t.mask.numel()
    for got, ref in ((t.xyzs, j.xyzs), (t.deltas, j.deltas), (t.ts, j.ts)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # the sample indices: each sample's t after the step names its lattice point
    np.testing.assert_array_equal(t.ts.numpy(), np.asarray(j.ts))


def test_march_rays_is_the_sequential_loop():
    occ, ro, rd, _ = _scene(0)
    aabb = torch.tensor([-1.0, -0.5, -1.0, 1.0, 0.5, 1.0])
    nears, fars = tr.near_far_from_aabb(torch.from_numpy(ro), torch.from_numpy(rd), aabb, 0.05)
    S, K = 16, 96
    m = tr.march_rays(torch.from_numpy(ro), torch.from_numpy(rd), nears, fars, torch.from_numpy(occ),
                      dt_gamma=0.0, max_steps=16, num_coarse=K, num_samples=S)
    dt = tr.step_size(H, 1, 16)[0]
    checked = 0
    for r in range(R):
        if nears[r] + K * dt < fars[r]:  # the K-point lattice stops short of far
            continue
        ref = _loop(ro[r].astype(np.float64), rd[r].astype(np.float64), nears[r], fars[r], occ, dt, S)
        got = m.xyzs[r][m.mask[r]].numpy()
        assert len(got) == len(ref), r
        np.testing.assert_allclose(got, np.asarray(ref).reshape(-1, 3), atol=1e-4)
        checked += 1
    assert checked > R // 2
