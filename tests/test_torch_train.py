"""The port's head-NeRF training slice vs the JAX package on the CPU, at a
small size with the flagship widths (grid 16, tens of rays, S <= 4,
individual_embedding_num 8): perturbed marching and rendering, losses,
the schedule and the grouped Adam, the density-grid refresh, the frame
store, the dataset's training parts, one whole train step for both
`use_fused_field` values, and a HeadNeRFTask + Trainer run with a resume.

Inputs and noise come from numpy seeds and go to both packages. Each test
states its tolerance."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genefaceplusplus_tpu.data import dataset as j_data
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.renderer import RenderOptions as JOptions
from genefaceplusplus_tpu.models.renderer import render_rays as j_render_rays
from genefaceplusplus_tpu.ops import raymarch as j_rm
from genefaceplusplus_tpu.ops.morton import dilate6 as j_dilate6
from genefaceplusplus_tpu.training import frame_store as j_fs
from genefaceplusplus_tpu.training import grid_updater as j_grid
from genefaceplusplus_tpu.training import losses as j_L
from genefaceplusplus_tpu.training import radnerf_task as j_task
from genefaceplusplus_tpu.training import schedulers as j_sched
from genefaceplusplus_tpu.utils import rays as j_rays
from genefaceplusplus_tpu_torch.data import dataset as t_data
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions as TOptions
from genefaceplusplus_tpu_torch.models.renderer import render_rays as t_render_rays
from genefaceplusplus_tpu_torch.ops import raymarch as t_rm
from genefaceplusplus_tpu_torch.ops.morton import dilate6 as t_dilate6
from genefaceplusplus_tpu_torch.training import frame_store as t_fs
from genefaceplusplus_tpu_torch.training import grid_updater as t_grid
from genefaceplusplus_tpu_torch.training import losses as t_L
from genefaceplusplus_tpu_torch.training import radnerf_task as t_task
from genefaceplusplus_tpu_torch.training import schedulers as t_sched
from genefaceplusplus_tpu_torch.utils import rays as t_rays
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

G, HW, R = 16, 32, 32
FLAGSHIP = dict(smo_win_size=3, individual_embedding_num=8, grid_size=G)


def _close(a_torch, a_jax, atol=1e-5, rtol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(a_torch), np.asarray(a_jax), atol=atol, rtol=rtol,
                               err_msg=name)


def _occupancy():
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, G)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.3


@pytest.fixture(scope="module")
def data():
    ds_dict = t_data.synthetic(num_frames=8, H=HW, W=HW, seed=3)  # 6 train frames
    ds_t = t_data.RADNeRFDataset(ds_dict, smo_win_size=3)
    ds_j = j_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=False)
    rs = np.random.RandomState(7)
    inds = rs.randint(0, HW * HW, size=R).astype(np.int32)
    pose = ds_t.frame_pose(2)
    ro, rd, _ = j_rays.pixel_rays(jnp.asarray(pose[None]), ds_t.intrinsics, HW, HW, jnp.asarray(inds[None]))
    return dict(ds_dict=ds_dict, ds_t=ds_t, ds_j=ds_j, inds=inds, ro=np.asarray(ro[0]),
                rd=np.asarray(rd[0]), noise=rs.rand(R).astype(np.float32), rs=rs)


def test_pixel_rays_with_inds_match_jax(data):
    ds = data["ds_t"]
    poses = np.stack([ds.frame_pose(0), ds.frame_pose(5)])
    inds = data["rs"].randint(0, HW * HW, size=(2, 50)).astype(np.int32)
    ro_j, rd_j, _ = j_rays.pixel_rays(jnp.asarray(poses), ds.intrinsics, HW, HW, jnp.asarray(inds))
    ro_t, rd_t = t_rays.pixel_rays(torch.from_numpy(poses), ds.intrinsics, HW, HW, torch.from_numpy(inds))
    _close(ro_t, ro_j, atol=1e-6)
    _close(rd_t, rd_j, atol=1e-6)


def _toy_field_j(xyz, dirs):
    r2 = jnp.sum(xyz * xyz, -1)
    return 20.0 * jnp.exp(-4.0 * r2), 0.5 + 0.4 * jnp.tanh(xyz + 0.3 * dirs), 0.1 * jnp.sin(3.0 * xyz)


def _toy_field_t(xyz, dirs):
    r2 = torch.sum(xyz * xyz, -1)
    return 20.0 * torch.exp(-4.0 * r2), 0.5 + 0.4 * torch.tanh(xyz + 0.3 * dirs), 0.1 * torch.sin(3.0 * xyz)


def test_perturbed_march_and_render_match_jax(data):
    """The same numpy noise in both: sample positions, deltas, ts and mask
    (exact), and a render through a closed-form field, atol 1e-5."""
    occ = _occupancy()
    ro, rd, noise = data["ro"], data["rd"], data["noise"]
    box_j = j_rm.occupancy_aabb(jnp.asarray(occ), 1.0)
    box_t = t_rm.occupancy_aabb(torch.from_numpy(occ), 1.0)
    aabb = np.asarray([-1, -0.5, -1, 1, 0.5, 1], np.float32)
    nears, fars = j_rm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb), 0.05)
    m_j = j_rm.march_rays_interval(jnp.asarray(ro), jnp.asarray(rd), nears, fars, box_j, num_samples=4,
                                   grid_size=G, noise=jnp.asarray(noise))
    m_t = t_rm.march_rays_interval(torch.from_numpy(ro), torch.from_numpy(rd),
                                   torch.from_numpy(np.asarray(nears)), torch.from_numpy(np.asarray(fars)),
                                   box_t, num_samples=4, grid_size=G, noise=torch.from_numpy(noise))
    m_0 = j_rm.march_rays_interval(jnp.asarray(ro), jnp.asarray(rd), nears, fars, box_j, num_samples=4,
                                   grid_size=G)
    assert np.abs(np.asarray(m_0.ts) - np.asarray(m_j.ts)).max() > 1e-3  # the noise moved samples
    for name, a, b in zip(m_j._fields, m_j, m_t):
        _close(b, a, atol=1e-6, name=name)

    bg = data["rs"].rand(R, 3).astype(np.float32)
    out_j = j_render_rays(_toy_field_j, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ), bound=1.0,
                          min_near=0.05, bg_color=jnp.asarray(bg),
                          opts=JOptions(num_samples=4, perturb=True), noise=jnp.asarray(noise))
    out_t = t_render_rays(_toy_field_t, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(occ),
                          bound=1.0, min_near=0.05, bg_color=torch.from_numpy(bg),
                          opts=TOptions(num_samples=4, perturb=True), noise=torch.from_numpy(noise))
    for name, a, b in zip(out_j._fields, out_j, out_t):
        _close(b, a, name=name)
    assert float(out_t.weights_sum.max()) > 0.1


def test_losses_match_jax():
    rs = np.random.RandomState(8)
    pred, gt = rs.rand(64, 3).astype(np.float32), rs.rand(64, 3).astype(np.float32)
    ws = np.concatenate([rs.rand(62), [0.0, 1.0]]).astype(np.float32)
    amb, mask = rs.rand(64).astype(np.float32) * 0.3, rs.rand(64) > 0.5
    T = lambda a: torch.from_numpy(a)
    mse_j = j_L.mse_loss(jnp.asarray(pred), jnp.asarray(gt))
    _close(t_L.mse_loss(T(pred), T(gt)), mse_j)
    _close(t_L.mse2psnr(t_L.mse_loss(T(pred), T(gt))), j_L.mse2psnr(mse_j))
    _close(t_L.weights_entropy_loss(T(ws)), j_L.weights_entropy_loss(jnp.asarray(ws)))
    for mode in ("mae", "mse"):
        _close(t_L.ambient_loss(T(amb), T(mask), mode), j_L.ambient_loss(jnp.asarray(amb), jnp.asarray(mask), mode))
    for step in (0, 1000, 250_000, 400_000):
        _close(t_L.ambient_ramp(step), j_L.ambient_ramp(jnp.asarray(step)))
    for lam, loss in ((1.0, 3.5), (0.002, 1e-9), (999.99, 10.0)):
        _close(t_L.adaptive_lambda_ambient(torch.tensor(lam), torch.tensor(loss), 1e-8, 0.01),
               j_L.adaptive_lambda_ambient(jnp.asarray(lam), jnp.asarray(loss), 1e-8, 0.01))


def test_schedule_and_grouped_adam_match_optax():
    """Three steps of the grouped Adam on the same gradients: parameters
    agree to rtol 1e-5 (float32 on both sides, the same update formula)."""
    for warm in (0, 100):
        s_t, s_j = t_sched.exponential_schedule(5e-4, warm), j_sched.exponential_schedule(5e-4, warm)
        for step in (0, 1, 50, 100, 1000, 250_000, 600_000):
            np.testing.assert_allclose(s_t(step), float(s_j(step)), rtol=1e-6)

    rs = np.random.RandomState(9)
    shapes = {("position_embedder", "B"): (4, 3), ("cond_att_net", "w"): (5,), ("sigma_net", "w"): (3, 2)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for (mod, name), v in init.items():
                m = torch.nn.Module()
                m.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))
                self.add_module(mod, m)

    toy = Toy()
    opt = t_sched.make_radnerf_optimizer(5e-4)(toy)
    assert sorted(g["label"] for g in opt.opt.param_groups) == ["att", "grid", "net"]
    tx = j_sched.make_radnerf_optimizer(5e-4)
    params = {"params": {mod: {name: jnp.asarray(v)} for (mod, name), v in init.items()}}
    state = tx.init(params)
    for g in grads:
        gj = {"params": {mod: {name: jnp.asarray(v)} for (mod, name), v in g.items()}}
        updates, state = tx.update(gj, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for (mod, name), v in g.items():
            getattr(getattr(toy, mod), name).grad = torch.from_numpy(v.copy())
        opt.step()
    for (mod, name) in shapes:
        _close(getattr(getattr(toy, mod), name).detach(), params["params"][mod][name], atol=0, rtol=1e-5,
               name=f"{mod}.{name}")
    named = [(f"{m}.{n}", torch.from_numpy(v)) for (m, n), v in grads[0].items()]
    norms_j = j_sched.grad_norms_by_group({"params": {m: {n: jnp.asarray(v)} for (m, n), v in grads[0].items()}})
    for k, v in t_sched.grad_norms_by_group(named).items():
        _close(v, norms_j[k], name=k)


def test_dilate6_grid_refresh_and_untrained_mark_match_jax(data):
    """dilate6 and mark_untrained_grid exact; one EMA refresh on the same
    jittered points through a closed-form density: grid atol 1e-5,
    occupancy exact."""
    rs = np.random.RandomState(10)
    g = rs.randn(1, 8, 8, 8).astype(np.float32)
    np.testing.assert_array_equal(t_dilate6(torch.from_numpy(g)).numpy(), np.asarray(j_dilate6(jnp.asarray(g))))

    ds = data["ds_t"]
    grid_j = j_grid.mark_untrained_grid(jnp.zeros((G, G, G)), ds.poses, ds.intrinsics, 1.0, chunk=1000)
    grid_t = t_grid.mark_untrained_grid(torch.zeros((G, G, G)), ds.poses, ds.intrinsics, 1.0, chunk=1000)
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(grid_j))
    assert 0 < int((grid_t < 0).sum()) < G ** 3  # some cells unseen, some seen

    grid_j = grid_j.at[2:6].set(jnp.where(grid_j[2:6] >= 0, 7.0, grid_j[2:6]))
    grid_t = torch.from_numpy(np.array(grid_j))
    rng = jax.random.PRNGKey(3)
    half = 1.0 / G
    jitter = np.asarray(jax.random.uniform(rng, (G ** 3, 3), minval=-half, maxval=half))

    def dens_j(p):
        return 30.0 * jnp.exp(-6.0 * jnp.sum(p * p, -1))

    def dens_t(p):
        return 30.0 * torch.exp(-6.0 * torch.sum(p * p, -1))

    new_j, occ_j, mean_j = j_grid.update_density_grid(dens_j, grid_j, rng, chunk=1000)
    new_t, occ_t, mean_t = t_grid.update_density_grid(dens_t, grid_t, jitter=torch.from_numpy(jitter), chunk=1000)
    _close(new_t, new_j)
    _close(mean_t, mean_j)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert 0 < float(occ_t.float().mean()) < 1
    # the generator path runs too (its draws are torch's, not jax's)
    _, occ_g, _ = t_grid.update_density_grid(dens_t, grid_t, torch.Generator().manual_seed(0), chunk=1000)
    assert occ_g.shape == (G, G, G)


def test_frame_store_and_cond_window_match_jax(data):
    ds_t, ds_j = data["ds_t"], data["ds_j"]
    fr_t = t_fs.base_device_frames(ds_t)
    fr_j = j_fs.base_device_frames(ds_j)
    for k in fr_j:
        np.testing.assert_array_equal(fr_t[k].numpy(), np.asarray(fr_j[k]), err_msg=k)
    T_all = len(ds_t.conds_all)
    for idx in (0, 1, 5, len(ds_t) - 1):
        for smo in (3, 5):
            w_t = t_fs.device_cond_window(fr_t, torch.tensor(idx), smo, T_all)
            w_j = j_fs.device_cond_window(fr_j, jnp.asarray(idx), smo, T_all)
            np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
            ds_t.smo_win_size = smo
            np.testing.assert_array_equal(w_t.numpy(), ds_t.frame_cond_window(idx))
    ds_t.smo_win_size = 3
    inds = torch.from_numpy(data["inds"])
    ro_t, rd_t = t_fs.device_frame_rays(fr_t, 2, ds_t.intrinsics, HW, HW, inds.long())
    _close(ro_t, data["ro"], atol=1e-6)
    _close(rd_t, data["rd"], atol=1e-6)
    img = np.random.RandomState(11).rand(4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(t_fs.quantize_u8(img), j_fs.quantize_u8(img))


def test_dataset_training_parts_match_jax():
    """load_image, frame_bg_torso (with a torso image that has alpha) and
    the val split's smoothed camera path, vs the JAX dataset at full
    resolution (with_sr=False)."""
    ds_dict = t_data.synthetic(num_frames=12, H=24, W=24, seed=4)
    rs = np.random.RandomState(12)
    for s in ds_dict["train_samples"][:3]:
        s["torso_img"] = rs.rand(24, 24, 4).astype(np.float32)
    for split in ("train", "val"):
        ds_t = t_data.RADNeRFDataset(ds_dict, split=split, smo_win_size=3)
        ds_j = j_data.RADNeRFDataset(ds_dict, split=split, smo_win_size=3, with_sr=False)
        _close(ds_t.poses, ds_j.poses, atol=1e-6, name=split)
        np.testing.assert_array_equal(ds_t.frame_ids, ds_j.frame_ids)
        for i in range(len(ds_t)):
            np.testing.assert_array_equal(ds_t.load_image(i, "gt"), ds_j.load_image(i, "gt"))
            a, b = ds_t.frame_bg_torso(i), ds_j.frame_bg_torso(i)
            assert (a is None) == (b is None)
            if a is not None:
                _close(a, b, atol=1e-6)
            assert ds_t.load_image(i, "head") is None
    assert not np.allclose(t_data.RADNeRFDataset(ds_dict, split="val").poses,
                           t_data.RADNeRFDataset(ds_dict, split="val", smooth_eval_camera=False).poses)
    with pytest.raises(NotImplementedError):
        t_data.RADNeRFDataset(ds_dict, with_sr=True)


def _hull_edge_distance(pts, ys, xs):
    hull = t_data._convex_hull(pts).astype(np.float64)
    d = np.full(ys.shape, np.inf)
    for a, b in zip(hull, np.roll(hull, -1, axis=0)):
        ab = b - a
        t = np.clip(((xs - a[0]) * ab[0] + (ys - a[1]) * ab[1]) / max(ab @ ab, 1e-12), 0, 1)
        d = np.minimum(d, np.hypot(xs - a[0] - t * ab[0], ys - a[1] - t * ab[1]))
    return d


@pytest.mark.parametrize("size", [64, 512])
def test_boundary_mask_matches_cv2(size):
    """numpy hull + scanline fill vs cv2.convexHull + cv2.fillConvexPoly:
    the masks differ only on pixels within 1 px of a hull edge (cv2's
    fixed-point edge walk rounds some crossings outward), at most 20 % of
    the hull's perimeter in pixels (measured: 4-18 %, e.g. 72 of a
    42,000-pixel face mask at 512^2)."""
    rs = np.random.RandomState(size)
    for trial in range(4):
        lms = (np.asarray([0.5, 0.5]) + rs.randn(68, 2) * [0.12, 0.16]).astype(np.float32)
        m_t = t_data.get_boundary_mask(lms, size, size)
        m_j = j_data.get_boundary_mask(lms, size, size)
        diff = m_t != m_j
        assert m_j.sum() > 0.05 * size * size
        pts = np.clip((lms * np.asarray([size, size])).astype(np.int32), 0, size - 1)
        ys, xs = np.nonzero(diff)
        if len(ys):
            assert _hull_edge_distance(pts, ys, xs).max() <= 1.0, trial
        perimeter = np.sum(np.hypot(*np.diff(np.vstack([h := t_data._convex_hull(pts), h[:1]]), axis=0).T))
        assert diff.sum() <= 0.2 * perimeter + 2, (trial, int(diff.sum()), perimeter)


# ---- one whole train step -----------------------------------------------

def _step_inputs(data):
    widths = dict(FLAGSHIP, fourier_pos_max_scale=16.0, fourier_amb_max_scale=8.0)
    jm = JRADNeRF(JConfig(**widths))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.zeros((3, 1, 204)))
    tm = TRADNeRF(TConfig(**widths))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    ds = data["ds_t"]
    idx = 2
    rs = np.random.RandomState(13)
    batch = {
        "rays_o": data["ro"], "rays_d": data["rd"],
        "cond": ds.frame_cond_window(idx),
        "gt_rgb": ds.load_image(idx, "gt").reshape(-1, 3)[data["inds"]],
        "bg_color": rs.rand(R, 3).astype(np.float32),
        "face_mask": rs.rand(R) > 0.5,
        "idx": np.asarray(idx, np.int32),
        "eye_area_percent": ds.eye_area_percents[idx][None],
    }
    return jm, params, tm, batch


@pytest.mark.parametrize("fused", [False, True])
def test_one_train_step_matches_jax(data, fused):
    """make_train_step (port) vs JAX's head_loss_fn under value_and_grad (the
    body of its make_train_step), then grad_norms_by_group and the
    lambda_ambient controller, on the same params, batch, occupancy and
    noise, at step 1000 (the ambient ramp is on). use_fused_field=True runs
    the JAX Pallas kernels in interpret mode and the port's plain versions.
    Tolerances: f32 path, losses rtol 1e-4 and every parameter's gradient
    cosine >= 0.9999, max |d| <= 1e-3 of its largest entry; fused path
    (bf16 chains with float32 sums in different orders: a flipped rounding
    of one of the 128 points' gradients moves its share by 2^-8), losses
    rtol 1e-3, gradient norms rtol 5e-2 (the attention net's is ~1e-5 of
    the total and measured 4 % apart), the cosine of the whole gradient
    >= 0.99 (measured 0.9966), and for the kernel's own weights (the three field MLPs)
    cosine >= 0.99, max |d| <= 0.2 of the largest entry (measured 0.9955,
    0.15). Every gradient here is a sum over only 128 points of signed bf16
    gradients that partly cancel, which amplifies each flipped rounding; the
    fused backward itself matches the Pallas kernel to ~1e-5
    (tests/test_torch_fused_field_bwd.py). The Fourier `B`s, the condition
    encoders and the individual codes, the most cancelling sums (measured
    cosine 0.98 to 0.999), are held through the whole-gradient cosine. The Fourier scales are cut to 16 / 8
    (widths stay the flagship's): at the flagship's 128 / 64 the position
    phases reach ~800 rad, where compiled XLA (the JAX side runs jitted, to
    keep the test short) and PyTorch round a phase ~6e-5 rad apart, and at
    128 points that alone moves the gradient norms by up to 0.2 %."""
    jm, params, tm, batch = _step_inputs(data)
    occ = _occupancy()
    hp_j, hp_t = j_task.TaskHParams(), t_task.TaskHParams()
    step = 1000
    def loss_j(p, b, o, n):
        return j_task.head_loss_fn(p, jm, b, o, JOptions(num_samples=4, perturb=True), hp_j,
                                   jnp.asarray(step, jnp.int32), jnp.asarray(1.0, jnp.float32), n,
                                   use_fused_field=fused, fused_tile=64, fused_interpret=True)

    (_, m_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(occ), jnp.asarray(data["noise"]))
    m_j = {k: float(v) for k, v in m_j.items()}
    m_j.update({k: float(v) for k, v in j_sched.grad_norms_by_group(g_j).items()})
    m_j["lambda_ambient"] = float(j_L.adaptive_lambda_ambient(
        jnp.asarray(1.0), jnp.asarray(m_j["ambient_loss"]), hp_j.target_ambient_loss, hp_j.lr_lambda_ambient))

    state = t_task.create_train_state(tm, t_sched.make_radnerf_optimizer(), torch.Generator(), hp_t)
    state.global_step = step
    train_step = t_task.make_train_step(TOptions(num_samples=4, perturb=True), hp_t, use_fused_field=fused)
    state, m_t = train_step(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                            torch.from_numpy(occ), noise=torch.from_numpy(data["noise"]))
    assert state.global_step == step + 1
    rtol, min_cos, max_rel = (1e-3, 0.99, 0.2) if fused else (1e-4, 0.9999, 1e-3)
    assert set(m_j) == set(m_t)
    for k in m_j:
        tol = 5e-2 if (fused and k.startswith("grad_norm/")) else rtol
        np.testing.assert_allclose(float(m_t[k]), m_j[k], rtol=tol, atol=1e-7, err_msg=k)
    assert m_j["ambient_loss"] > 0 and m_j["grad_norm/grid"] > 0

    g_ref = convert_flax_params(jax.tree.map(np.asarray, g_j), tm)
    flat_t, flat_j, bad = [], [], []
    for name, p in tm.named_parameters():
        a, b = p.grad.double().numpy().ravel(), g_ref[name].double().numpy().ravel()
        flat_t.append(a)
        flat_j.append(b)
        if fused and not name.startswith(("ambient_net", "sigma_net", "color_net")):
            continue  # checked through the whole-gradient cosine below
        nb = np.linalg.norm(b)
        if nb == 0.0:
            assert np.abs(a).max() == 0.0, name
            continue
        cos = float(a @ b) / (np.linalg.norm(a) * nb)
        rel = np.abs(a - b).max() / np.abs(b).max()
        if cos < min_cos or rel > max_rel:
            bad.append((name, cos, rel))
    assert not bad, bad
    a, b = np.concatenate(flat_t), np.concatenate(flat_j)
    assert float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) >= (0.99 if fused else 0.9999)


# ---- the task and the trainer -------------------------------------------

def test_head_task_draws_match_jax_and_trainer_resumes(data, tmp_path):
    """HeadNeRFTask draws the same frame ids and ray indices as the JAX task
    (same seed, same numpy calls); Trainer.fit runs 5 fused steps on the
    CPU with finite losses and a grid refresh, writes a checkpoint and
    resumes from it. The JAX task cannot run its fused path on the CPU (its
    HeadTaskConfig has no interpret flag), so only the draws are compared."""
    from genefaceplusplus_tpu.training.tasks.head_task import HeadNeRFTask as JTask
    from genefaceplusplus_tpu.training.tasks.head_task import HeadTaskConfig as JTaskCfg
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig
    from genefaceplusplus_tpu_torch.training.trainer import Trainer

    ds_t, ds_j = data["ds_t"], data["ds_j"]
    task_j = JTask(ds_j, JConfig(**FLAGSHIP), JTaskCfg(n_rays=R, num_samples=4), seed=5)
    task_t = HeadNeRFTask(ds_t, TConfig(**FLAGSHIP), HeadTaskConfig(n_rays=R, num_samples=4), seed=5)
    np.testing.assert_array_equal(task_t.density_grid.numpy(), np.asarray(task_j.density_grid))
    for step in range(3):
        b_j, b_t = task_j.sample_train_batch(global_step=step), task_t.sample_train_batch(global_step=step)
        assert b_t["frame_idx"] == b_j["frame_idx"]
        np.testing.assert_array_equal(b_t["inds"], b_j["inds"])
    gt_j = task_j._device_frames()
    gt_t = task_t._device_frames()
    for k in ("gt", "bg", "poses"):
        np.testing.assert_array_equal(gt_t[k].numpy(), np.asarray(gt_j[k]), err_msg=k)
    # face masks: equal but for hull-boundary pixels (test_boundary_mask_matches_cv2)
    assert (gt_t["mask"].numpy() != np.asarray(gt_j["mask"])).mean() < 0.02

    cfg_t = HeadTaskConfig(n_rays=R, num_samples=4, use_fused_field=True)
    task = HeadNeRFTask(ds_t, TConfig(**FLAGSHIP), cfg_t, seed=5)
    trainer = Trainer(task, str(tmp_path), max_updates=5, val_check_interval=100, tb_log_interval=1,
                      update_extra_interval=4, num_sanity_val_steps=1)
    state = trainer.fit()
    assert state.global_step == 5
    assert task.grid_telemetry["density_grid/occupancy_rate"] < 1.0  # refreshed at steps 0 and 4
    lines = open(tmp_path / "metrics.jsonl").read().splitlines()
    assert sum('"total_loss"' in ln for ln in lines) == 5
    assert all(math.isfinite(float(ln.split('"total_loss": ')[1].split(",")[0]))
               for ln in lines if '"total_loss"' in ln)
    assert os.listdir(tmp_path).count("model_ckpt_steps_5.ckpt") == 1
    resumed = Trainer(HeadNeRFTask(ds_t, TConfig(**FLAGSHIP), cfg_t, seed=5), str(tmp_path), max_updates=6,
                      val_check_interval=100, tb_log_interval=1, update_extra_interval=4)
    state2 = resumed.fit()
    assert state2.global_step == 6
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt")) == ["model_ckpt_steps_6.ckpt"]
    with pytest.raises(NotImplementedError):
        HeadNeRFTask(ds_t, TConfig(**FLAGSHIP), HeadTaskConfig(train_compact_start=10))
