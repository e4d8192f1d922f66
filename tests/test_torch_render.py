"""Port renderer vs the JAX renderer: render_rays on the production
options (probe entry, S=10, T_thresh 1e-2) with the float32 model field,
the head-crop helpers, and the head-only render_full_frame.

Tolerance: atol 1e-4 for images and maps (ROADMAP's cross-backend float32
precedent); crop sizes and offsets are integers and must match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models import full_renderer as j_fr
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.renderer import RenderOptions as JOptions
from genefaceplusplus_tpu.models.renderer import render_rays as j_render_rays
from genefaceplusplus_tpu.ops.raymarch import occupancy_aabb as j_occ_aabb
from genefaceplusplus_tpu.utils.rays import pixel_rays as j_pixel_rays
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
from genefaceplusplus_tpu_torch.models import full_renderer as t_fr
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions as TOptions
from genefaceplusplus_tpu_torch.models.renderer import render_rays as t_render_rays
from genefaceplusplus_tpu_torch.ops.raymarch import occupancy_aabb as t_occ_aabb
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

ATOL = 1e-4
H = W = 32
CFG = dict(smo_win_size=5, grid_size=16, individual_embedding_num=8, fourier_pos_features=16,
           fourier_amb_features=8, hidden_dim_ambient=32, hidden_dim_sigma=32,
           hidden_dim_color=32, geo_feat_dim=16)
OPTS = dict(num_samples=10, T_thresh=1e-2, entry_mode="probe")


@pytest.fixture(scope="module")
def scene():
    jm = JRADNeRF(JConfig(**CFG))
    c = jm.cfg
    rs = np.random.RandomState(0)
    cond = rs.randn(c.smo_win_size, 1, c.cond_in_dim).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.asarray(cond))
    tm = TRADNeRF(TConfig(**CFG))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    ds = RADNeRFDataset(synthetic(num_frames=4, H=H, W=W), smo_win_size=5)
    occ = np.zeros((16, 16, 16), bool)
    occ[7:9, 7:10, 7:9] = True
    pose = ds.frame_pose(1)
    ro, rd, _ = j_pixel_rays(jnp.asarray(pose[None]), ds.intrinsics, H, W)
    ro, rd = np.asarray(ro[0]), np.asarray(rd[0])
    eye = np.asarray([[0.3]], np.float32)
    return dict(jm=jm, params=params, tm=tm, ds=ds, occ=occ, pose=pose, ro=ro, rd=rd,
                cond=cond, eye=eye, bg=ds.bg_img.reshape(-1, 3))


def test_render_rays_probe_matches_jax(scene):
    s = scene
    jm, params, tm = s["jm"], s["params"], s["tm"]
    cf = jm.apply(params, jnp.asarray(s["cond"]), jnp.asarray(s["eye"]), method=JRADNeRF.cal_cond_feat)
    ind = jm.apply(params, 0, method=JRADNeRF.get_individual_code)

    def j_field(xyz, dirs):
        return jm.apply(params, xyz, dirs, cf, ind, method=JRADNeRF.field)

    out_j = j_render_rays(j_field, jnp.asarray(s["ro"]), jnp.asarray(s["rd"]), jnp.asarray(s["occ"]),
                          bound=1.0, min_near=0.05, bg_color=jnp.asarray(s["bg"]),
                          opts=JOptions(**OPTS), image_hw=(H, W))
    cf_t, ind_t = torch.from_numpy(np.asarray(cf)), torch.from_numpy(np.asarray(ind))
    with torch.no_grad():
        out_t = t_render_rays(lambda x, d: tm.field(x, d, cf_t, ind_t),
                              torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]),
                              torch.from_numpy(s["occ"]), bound=1.0, min_near=0.05,
                              bg_color=torch.from_numpy(s["bg"]), opts=TOptions(**OPTS),
                              image_hw=(H, W))
    for name, a, b in zip(out_j._fields, out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0, err_msg=name)
    assert float(out_t.weights_sum.max()) > 0.05  # the head is really there


def test_render_rays_refuses_unported_approximations(scene):
    """Both approximations, once refused, now render on the production
    options: `compact_frac` 0.5 covers this scene's live samples, so its
    render equals the full one (atol 1e-5, float32 order); `color_topk` 4
    with the split field keeps the geometry exact and the image close
    (tests/test_torch_compaction.py holds both to JAX)."""
    s = scene
    tm = s["tm"]
    cf = tm.cal_cond_feat(torch.from_numpy(s["cond"]), torch.from_numpy(s["eye"]))
    ind = tm.get_individual_code(0)
    args = (torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]), torch.from_numpy(s["occ"]), 1.0, 0.05,
            torch.from_numpy(s["bg"]))
    out = {}
    with torch.no_grad():
        for name, kw in (("full", {}), ("compact", {"compact_frac": 0.5}), ("topk", {"color_topk": 4})):
            out[name] = t_render_rays(lambda x, d: tm.field(x, d, cf, ind), *args, TOptions(**OPTS, **kw),
                                      image_hw=(H, W), sigma_fn=lambda x: tm.field_sigma(x, cf),
                                      color_fn=lambda g, d: tm.field_color(g, d, ind))
    for name in ("rgb_map", "depth_map", "weights_sum", "ambient_sum", "weights", "head_image"):
        # (ambient_pos of a dead sample is 0 in the compacted render)
        np.testing.assert_allclose(getattr(out["compact"], name).numpy(), getattr(out["full"], name).numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["topk"].weights_sum.numpy(), out["full"].weights_sum.numpy(), atol=1e-6)
    assert np.abs(out["topk"].rgb_map.numpy() - out["full"].rgb_map.numpy()).mean() < 1e-2


@pytest.mark.parametrize("pad_px,multiple", [(2, 4), (12, 16)])
def test_head_crop_helpers_equal_jax(scene, pad_px, multiple):
    s = scene
    ds = s["ds"]
    poses = np.stack([ds.frame_pose(i) for i in range(len(ds))])
    kw = dict(bound=1.0, pad_px=pad_px, multiple=multiple)
    crop_j = j_fr.auto_head_crop(jnp.asarray(s["occ"]), poses, ds.intrinsics, H, W, **kw)
    crop_t = t_fr.auto_head_crop(torch.from_numpy(s["occ"]), poses, ds.intrinsics, H, W, **kw)
    assert crop_t == crop_j
    assert (j_fr.auto_head_bbox(jnp.asarray(s["occ"]), poses, ds.intrinsics, H, W)
            == t_fr.auto_head_bbox(torch.from_numpy(s["occ"]), poses, ds.intrinsics, H, W))
    for crop in ((16, 16), (20, 24), (H, W)):
        r_j = j_fr.head_crop_offset(jnp.asarray(s["ro"]), jnp.asarray(s["rd"]),
                                    j_occ_aabb(jnp.asarray(s["occ"]), 1.0), (H, W), crop)
        r_t = t_fr.head_crop_offset(torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]),
                                    t_occ_aabb(torch.from_numpy(s["occ"]), 1.0), (H, W), crop)
        assert [int(v) for v in r_t] == [int(v) for v in r_j]


def test_auto_head_crop_engages_on_this_scene(scene):
    s = scene
    ds = s["ds"]
    poses = np.stack([ds.frame_pose(i) for i in range(len(ds))])
    assert t_fr.auto_head_crop(torch.from_numpy(s["occ"]), poses, ds.intrinsics, H, W,
                               pad_px=2, multiple=4) is not None


@pytest.mark.parametrize("head_crop", [None, (16, 20)])
def test_render_full_frame_head_only_matches_jax(scene, head_crop):
    s = scene
    jm, params, tm = s["jm"], s["params"], s["tm"]
    out_j = j_fr.render_full_frame(
        jm, params, jnp.asarray(s["ro"]), jnp.asarray(s["rd"]), jnp.asarray(s["cond"]),
        jnp.asarray(s["occ"]), jnp.asarray(s["bg"]), JOptions(**OPTS), (H, W),
        eye_area_percent=jnp.asarray(s["eye"]), index=2, head_crop=head_crop)
    with torch.no_grad():
        out_t = t_fr.render_full_frame(
            tm, torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]), torch.from_numpy(s["cond"]),
            torch.from_numpy(s["occ"]), torch.from_numpy(s["bg"]), TOptions(**OPTS), (H, W),
            eye_area_percent=torch.from_numpy(s["eye"]), index=2, head_crop=head_crop)
    for name in ("rgb_map", "depth_map", "weights_sum"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    if head_crop is None:
        assert out_t.head_crop_fits is None
    else:
        assert bool(out_t.head_crop_fits) == bool(out_j.head_crop_fits)
