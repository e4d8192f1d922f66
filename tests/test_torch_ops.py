"""Port ops vs the JAX ops on the same numpy inputs (CPU, float32).

Tolerance: atol 1e-4 for float results (ROADMAP's cross-backend float32
precedent); index-valued and boolean results must match exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops import composite as j_comp
from genefaceplusplus_tpu.ops import fastmath as j_fm
from genefaceplusplus_tpu.ops import raymarch as j_rm
from genefaceplusplus_tpu.ops.fourier_encoder import FourierEncoder as JFourier
from genefaceplusplus_tpu.ops.sh_encoder import sh_encode as j_sh
from genefaceplusplus_tpu.utils import rays as j_rays
from genefaceplusplus_tpu.utils.audio_features import get_audio_features_batch as j_win
from genefaceplusplus_tpu.utils.rotation import nerf_matrix_to_ngp as j_ngp
from genefaceplusplus_tpu.utils.smoothing import mirror_index as j_mirror
from genefaceplusplus_tpu_torch.ops import composite as t_comp
from genefaceplusplus_tpu_torch.ops import fastmath as t_fm
from genefaceplusplus_tpu_torch.ops import raymarch as t_rm
from genefaceplusplus_tpu_torch.ops.fourier_encoder import FourierEncoder as TFourier
from genefaceplusplus_tpu_torch.ops.sh_encoder import sh_encode as t_sh
from genefaceplusplus_tpu_torch.utils import rays as t_rays
from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch as t_win
from genefaceplusplus_tpu_torch.utils.rotation import nerf_matrix_to_ngp as t_ngp
from genefaceplusplus_tpu_torch.utils.smoothing import mirror_index as t_mirror

ATOL = 1e-4


def _close(a_jax, a_torch, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a_torch), np.asarray(a_jax), atol=atol, rtol=0)


def _halfway_points():
    """float32 x with x * f32(1/2pi) == k + 0.5 exactly: where round's
    tie-breaking rule decides the reduced argument's sign."""
    inv = np.float32(1.0 / (2.0 * math.pi))
    out = []
    for k in range(-40, 40):
        target = np.float32(k + 0.5)
        x = np.float32(target / inv)
        for _ in range(64):
            prod = np.float32(x * inv)
            if prod == target:
                out.append(x)
                break
            x = np.nextafter(x, np.float32(np.inf if prod < target else -np.inf), dtype=np.float32)
    return np.asarray(out, np.float32)


def test_fastmath_matches_jax():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-10, 10, 4000), rs.uniform(-900, 900, 4000)]).astype(np.float32)
    xt = torch.from_numpy(x)
    _close(j_fm.fast_sin(x), t_fm.fast_sin(xt))
    _close(j_fm.fast_cos(x), t_fm.fast_cos(xt))
    _close(j_fm.fast_tanh(x / 100), t_fm.fast_tanh(xt / 100))
    _close(j_fm.fast_tanh(x), t_fm.fast_tanh(xt))


def test_fastmath_round_half_to_even():
    x = _halfway_points()
    assert len(x) > 60
    u = np.float32(1.0 / (2.0 * math.pi)) * x
    t_j = np.asarray(jnp.asarray(u) - jnp.round(jnp.asarray(u)))
    t_t = t_fm.sin_reduce(torch.from_numpy(x)).numpy()
    # exact: the tie rule is the whole point (half to even gives +-0.5 by k)
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_array_equal(np.abs(t_t), 0.5)
    _close(j_fm.fast_sin(x), t_fm.fast_sin(torch.from_numpy(x)))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encoder_matches_jax(degree):
    d = np.random.RandomState(degree).randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(j_sh(d, degree), t_sh(torch.from_numpy(d), degree))


def test_fourier_encoder_matches_jax():
    enc = JFourier(3, 32, max_scale=128.0)
    x = np.random.RandomState(1).uniform(-2, 2, (400, 3)).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x), bound=2.0)
    port = TFourier(3, 32, max_scale=128.0)
    with torch.no_grad():
        port.B.copy_(torch.from_numpy(np.asarray(params["params"]["B"])))
    _close(enc.apply(params, jnp.asarray(x), bound=2.0),
           port(torch.from_numpy(x), bound=2.0).detach())


# ---- ray marching: 32^3 bench-ellipsoid grid, 32x32 rays ------------------

G, HW = 32, 32


def _scene():
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, G)] * 3), indexing="ij")
    occ = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    intr = (2.0 * HW, 2.0 * HW, HW / 2, HW / 2)
    ro, rd, _ = j_rays.pixel_rays(jnp.asarray(pose[None]), intr, HW, HW)
    return occ, np.asarray(ro[0]), np.asarray(rd[0])


def test_pixel_rays_and_bg_coords_match_jax():
    pose = np.asarray(j_ngp(np.eye(4) + np.diag([0, 0, 0, 0])), np.float32)
    pose[:3, 3] = [0.1, 2.4, -0.2]
    intr = (70.0, 71.0, 15.5, 16.5)
    poses = np.stack([pose, pose @ np.diag([1, -1, 1, 1]).astype(np.float32)])
    ro_j, rd_j, _ = j_rays.pixel_rays(jnp.asarray(poses), intr, 24, 32)
    ro_t, rd_t = t_rays.pixel_rays(torch.from_numpy(poses), intr, 24, 32)
    _close(ro_j, ro_t)
    _close(rd_j, rd_t)
    _close(j_rays.get_bg_coords(24, 32), t_rays.get_bg_coords(24, 32))


def test_small_helpers_match_jax():
    c2w = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    np.testing.assert_array_equal(t_ngp(c2w, scale=4.0, offset=(0.1, 0.2, 0.3)),
                                  j_ngp(c2w, scale=4.0, offset=(0.1, 0.2, 0.3)))
    for size in (1, 2, 7):
        assert [t_mirror(i, size) for i in range(30)] == [j_mirror(i, size) for i in range(30)]
    feats = np.random.RandomState(3).randn(9, 1, 6).astype(np.float32)
    idx = np.arange(9)
    _close(j_win(jnp.asarray(feats), jnp.asarray(idx), 5),
           t_win(torch.from_numpy(feats), torch.from_numpy(idx), 5))


def test_raymarch_primitives_match_jax():
    occ, ro, rd = _scene()
    occ_t, ro_t, rd_t = torch.from_numpy(occ), torch.from_numpy(ro), torch.from_numpy(rd)
    aabb = np.asarray([-1, -0.5, -1, 1, 0.5, 1], np.float32)
    n_j, f_j = j_rm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb), 0.05)
    n_t, f_t = t_rm.near_far_from_aabb(ro_t, rd_t, torch.from_numpy(aabb), 0.05)
    _close(n_j, n_t)
    _close(f_j, f_t)

    pts = np.random.RandomState(4).uniform(-1, 1, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_rm.occupancy_lookup(occ_t, torch.from_numpy(pts), 1.0).numpy(),
        np.asarray(j_rm.occupancy_lookup(jnp.asarray(occ), jnp.asarray(pts), 1.0)))
    box_j = j_rm.occupancy_aabb(jnp.asarray(occ), 1.0)
    box_t = t_rm.occupancy_aabb(occ_t, 1.0)
    np.testing.assert_array_equal(box_t.numpy(), np.asarray(box_j))
    empty = np.zeros((G, G, G), bool)
    np.testing.assert_array_equal(t_rm.occupancy_aabb(torch.from_numpy(empty)).numpy(),
                                  np.asarray(j_rm.occupancy_aabb(jnp.asarray(empty))))
    for dilate in (False, True):
        np.testing.assert_array_equal(
            t_rm.coarsen_occupancy(occ_t, 4, dilate).numpy(),
            np.asarray(j_rm.coarsen_occupancy(jnp.asarray(occ), 4, dilate)))


def test_probe_and_interval_march_match_jax():
    occ, ro, rd = _scene()
    occ = occ.copy()
    occ[6:9, 6:9, 25:30] = True  # a far corner blob: the probe must tighten the box
    occ_t, ro_t, rd_t = torch.from_numpy(occ), torch.from_numpy(ro), torch.from_numpy(rd)
    box_j = j_rm.occupancy_aabb(jnp.asarray(occ), 1.0)
    box_t = t_rm.occupancy_aabb(occ_t, 1.0)
    n2, f2 = j_rm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), box_j, 0.05)
    coarse = j_rm.coarsen_occupancy(jnp.asarray(occ), 4, True)
    tf_j, tl_j = j_rm.probe_entry_exit(jnp.asarray(ro), jnp.asarray(rd), n2, f2, coarse, 1.0, n_probe=32)
    tf_t, tl_t = t_rm.probe_entry_exit(ro_t, rd_t, torch.from_numpy(np.asarray(n2)),
                                       torch.from_numpy(np.asarray(f2)),
                                       torch.from_numpy(np.asarray(coarse)), 1.0, n_probe=32)
    _close(tf_j, tf_t)
    _close(tl_j, tl_t)
    # the probe tightens the slab on some rays (the comparison is not vacuous)
    moved = ((np.asarray(tf_j) > np.asarray(n2) + 1e-6)
             | (np.asarray(tl_j) < np.asarray(f2) - 1e-6))
    assert moved.any()

    te_j, tx_j = j_rm.entry_exit_depth_map(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ),
                                           box_j, 1.0, (HW, HW), n_probe=32)
    te_t, tx_t = t_rm.entry_exit_depth_map(ro_t, rd_t, occ_t, box_t, 1.0, (HW, HW), n_probe=32)
    _close(te_j, te_t)
    _close(tx_j, tx_t)

    aabb = np.asarray([-1, -0.5, -1, 1, 0.5, 1], np.float32)
    nears, fars = j_rm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb), 0.05)
    for kw_j, kw_t in (
        ({}, {}),
        ({"t_entry": te_j, "t_exit": tx_j}, {"t_entry": te_t, "t_exit": tx_t}),
    ):
        m_j = j_rm.march_rays_interval(jnp.asarray(ro), jnp.asarray(rd), nears, fars, box_j,
                                       num_samples=10, grid_size=G, **kw_j)
        m_t = t_rm.march_rays_interval(ro_t, rd_t, torch.from_numpy(np.asarray(nears)),
                                       torch.from_numpy(np.asarray(fars)), box_t,
                                       num_samples=10, grid_size=G, **kw_t)
        for a, b in zip(m_j[:3], m_t[:3]):
            _close(a, b)
        np.testing.assert_array_equal(m_t.mask.numpy(), np.asarray(m_j.mask))


def test_composite_matches_jax():
    rs = np.random.RandomState(6)
    R, S = 256, 10
    sig = rs.exponential(8.0, (R, S)).astype(np.float32)
    rgb = rs.rand(R, S, 3).astype(np.float32)
    amb = rs.rand(R, S).astype(np.float32)
    deltas = rs.uniform(0.01, 0.05, (R, S)).astype(np.float32)
    ts = np.cumsum(deltas, axis=1).astype(np.float32) + 0.3
    mask = rs.rand(R, S) > 0.2
    args = (sig, rgb, amb, deltas, ts, mask)
    c_j = j_comp.composite_rays(*map(jnp.asarray, args), T_thresh=1e-2)
    c_t = t_comp.composite_rays(*map(torch.from_numpy, args), T_thresh=1e-2)
    for a, b in zip(c_j, c_t):
        _close(a, b)
    bg = rs.rand(R, 3).astype(np.float32)
    _close(j_comp.blend_background(c_j.image, c_j.weights_sum, jnp.asarray(bg)),
           t_comp.blend_background(c_t.image, c_t.weights_sum, torch.from_numpy(bg)))
    nears = rs.uniform(0.1, 0.3, R).astype(np.float32)
    fars = nears + rs.uniform(0.0, 1.0, R).astype(np.float32)
    _close(j_comp.normalize_depth(c_j.depth, jnp.asarray(nears), jnp.asarray(fars)),
           t_comp.normalize_depth(c_t.depth, torch.from_numpy(nears), torch.from_numpy(fars)))
