"""The port's training steps of the head + SR, lip fine-tuning and torso
stages against the JAX package's, on the CPU, at a small size with the
flagship widths (grid 16, a 32^2 identity rendered at 16^2 with SR to
32^2, lip window 8); and their parts: the optimizer's optax layout, the
torso grid refresh, `load_image(full_res=True)`, the perceptual loss and
the PNG writer.

Each step starts both packages from JAX's weights (the bridge), the same
perceptual weights, occupancy and ray noise (JAX's own draw, replayed
into the port), and the same seeded Adam state (moments and count through
`RADNeRFAdam.load_optax`), so an update is a smooth function of the
gradient: Adam's first step from zero moments is lr x sign(g), which
would turn float noise in a near-zero gradient into a full lr. The
Fourier scales are cut to 16 / 8 (widths stay the flagship's), as in
tests/test_torch_train.py: at 128 / 64 compiled XLA and PyTorch round
the phases ~6e-5 rad apart. Each test states its tolerance."""

import os

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.data import dataset as j_data
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.training import grid_updater as j_grid
from genefaceplusplus_tpu.training import perceptual as j_perc
from genefaceplusplus_tpu.training import schedulers as j_sched
from genefaceplusplus_tpu.training.tasks import head_task as j_head
from genefaceplusplus_tpu.training.tasks import sr_task as j_sr
from genefaceplusplus_tpu.training.tasks import torso_task as j_torso
from genefaceplusplus_tpu_torch.data import dataset as t_data
from genefaceplusplus_tpu_torch.data import image_io
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.training import grid_updater as t_grid
from genefaceplusplus_tpu_torch.training import perceptual as t_perc
from genefaceplusplus_tpu_torch.training import schedulers as t_sched
from genefaceplusplus_tpu_torch.training.tasks import head_task as t_head
from genefaceplusplus_tpu_torch.training.tasks import sr_task as t_sr
from genefaceplusplus_tpu_torch.training.tasks import torso_task as t_torso
from genefaceplusplus_tpu_torch.utils.convert_jax import (
    convert_flax_params, export_flax_tree, flax_tree_leaves, load_flax_tree)

G, HW = 16, 32
WIDTHS = dict(smo_win_size=3, individual_embedding_num=8, grid_size=G, fourier_pos_max_scale=16.0,
              fourier_amb_max_scale=8.0)
TORSO = {"with_sr": True, "torso_head_aware": True, "torso_individual_embedding_dim": 8,
         "individual_embedding_num": 8, "grid_size": G, "lambda_torso_deform": 0.01,
         "smo_win_size": 3}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU steps, so the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _occupancy():
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, G)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.3


@pytest.fixture(scope="module")
def ds_dict():
    d = t_data.synthetic(num_frames=8, H=HW, W=HW, seed=3)
    rs = np.random.RandomState(4)
    for s in d["train_samples"] + d["val_samples"]:
        torso = rs.rand(HW, HW, 4).astype(np.float32)
        torso[..., 3] = torso[..., 3] > 0.5
        s["torso_img"] = torso
    return d


def _seeded_opt_state(opt_state, seed=0, count=10):
    """optax's state dict with every moment leaf seeded (mu ~ N(0, 1e-3),
    nu ~ U(1e-4, 1e-3)) and every count `count`."""
    rs = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "count":
            return np.asarray(count, np.int32)
        if any(getattr(p, "key", None) == "mu" for p in path):
            return np.asarray(rs.randn(*x.shape) * 1e-3, np.float32)
        return np.asarray(rs.uniform(1e-4, 1e-3, x.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(flax.serialization.to_state_dict(opt_state)))


def _sync_states(state_j, state_t, seed=0):
    """The port's state from JAX's: params through the bridge, seeded Adam
    moments and count into both. Returns JAX's state with that optimizer
    state."""
    params_key = type(state_t).params_key
    load_flax_tree(state_t.model, _np(getattr(state_j, params_key)))
    seeded = _seeded_opt_state(state_j.opt_state, seed)
    state_t.opt.load_optax(seeded)
    return state_j.replace(opt_state=flax.serialization.from_state_dict(state_j.opt_state, seeded))


def _noise(state_j, n):
    """The ray noise JAX's step draws from its state's key."""
    _, sub = jax.random.split(state_j.rng)
    return np.array(jax.random.uniform(sub, (n,)))


def _assert_params_close(state_t, params_j, atol, what):
    ref = flax_tree_leaves(_np(params_j), state_t.model)
    got = {k: v.detach() for k, v in state_t.model.state_dict().items()}
    assert set(ref) == set(got), what
    worst = max(((np.abs(got[k].numpy() - ref[k]).max(), k) for k in ref), key=lambda t: t[0])
    assert worst[0] <= atol, (what, worst)


def _assert_metrics_close(m_t, m_j, rtol, keys=None):
    m_j = {k: float(v) for k, v in m_j.items()}
    keys = sorted(m_j) if keys is None else keys
    assert set(m_j) <= set(m_t), sorted(set(m_j) - set(m_t))
    for k in keys:
        np.testing.assert_allclose(float(m_t[k]), m_j[k], rtol=rtol, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- the optimizer


def test_optimizer_state_round_trips_through_optax_layout():
    """Three steps of the grouped Adam on the same gradients in both: the
    port's export equals optax's state dict (every leaf, masked leaves as
    empty dicts; moments <= 1e-6, counts exact), and a fresh optimizer that
    imports it exports the same tree again, bit for bit."""
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
    tx = j_sched.make_radnerf_optimizer(5e-4)
    params = {"params": {mod: {name: jnp.asarray(v)} for (mod, name), v in init.items()}}
    state = tx.init(params)
    for g in grads:
        gj = {"params": {mod: {name: jnp.asarray(v)} for (mod, name), v in g.items()}}
        updates, state = tx.update(gj, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        opt.zero_grad()
        for (mod, name), v in g.items():
            getattr(getattr(toy, mod), name).grad = torch.from_numpy(v.copy())
        opt.step()
    ref = _np(flax.serialization.to_state_dict(state))
    got = opt.export_optax()
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    assert int(got["inner_states"]["grid"]["inner_state"]["1"]["count"]) == 3

    fresh = t_sched.make_radnerf_optimizer(5e-4)(Toy())
    fresh.load_optax(ref)
    assert fresh.count == 3
    again = fresh.export_optax()
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="moments"):
        broken = jax.tree.map(lambda x: x, ref)
        broken["inner_states"]["grid"]["inner_state"]["0"]["mu"]["params"]["position_embedder"]["B"] = {}
        fresh.load_optax(broken)


# ---------------------------------------------------------------- the lip step


def test_lip_step_matches_jax(ds_dict):
    """One lip-window step (mse + lambda_lpips x the small perceptual loss on
    the 8x8 window, the float32 field) from the same state, window and
    noise: losses rtol 1e-4 (measured 6.4e-5, the perceptual term);
    updated params atol 1e-6 (measured 4.8e-7); lambda_ambient kept."""
    ds_j = j_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    ds_t = t_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    kw = dict(n_rays=64, num_samples=4, finetune_lips_start_iter=0, lip_window=8, lambda_lpips=0.5)
    task_j = j_head.HeadNeRFTask(ds_j, JConfig(**WIDTHS), j_head.HeadTaskConfig(**kw), seed=5)
    task_t = t_head.HeadNeRFTask(ds_t, TConfig(**WIDTHS), t_head.HeadTaskConfig(**kw), seed=5, device="cpu")
    occ = _occupancy()
    task_j.occupancy, task_t.occupancy = jnp.asarray(occ), torch.from_numpy(occ)
    state_j, state_t = task_j.create_state(), task_t.create_state()
    state_j = _sync_states(state_j, state_t)
    task_t.perceptual = t_perc.PerceptualLoss(device="cpu")
    load_flax_tree(task_t.perceptual.net, _np(j_perc.perceptual_from_task_config(task_j.task_cfg).params))

    b_j = task_j.sample_train_batch(global_step=1)
    b_t = task_t.sample_train_batch(global_step=1)
    assert b_j["_is_lip"] and b_t["_is_lip"]
    assert b_t["frame_idx"] == b_j["frame_idx"]
    np.testing.assert_array_equal(b_t["inds"], b_j["inds"])
    np.testing.assert_array_equal(b_t["inds"], task_t._lip_window_indices(b_t["frame_idx"]))
    noise = _noise(state_j, 64)
    new_j, m_j = task_j.train_step(state_j, dict(b_j))
    new_t, m_t = task_t.train_step(state_t, dict(b_t), noise=torch.from_numpy(noise))
    assert set(m_t) == set(m_j)
    _assert_metrics_close(m_t, m_j, 1e-4)
    assert float(m_j["lpips_loss"]) > 0
    _assert_params_close(new_t, new_j.params, 1e-6, "lip step")
    assert new_t.global_step == 1 and float(new_t.lambda_ambient) == 1.0
    # the alternation and the paused grid refresh
    assert not task_t.sample_train_batch(global_step=2)["_is_lip"]
    grid = task_t.density_grid.clone()
    task_t.update_extra_state(new_t)
    assert torch.equal(grid, task_t.density_grid)


# ---------------------------------------------------------------- the SR step


@pytest.fixture(scope="module")
def sr_pair(ds_dict):
    ds_j = j_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    ds_t = t_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    out = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(n_rays=256, num_samples=4, lpips_start_iters=0, lip_window=8, lambda_lpips=0.5,
                  sr_dtype=dtype)
        task_j = j_sr.SRHeadNeRFTask(ds_j, JConfig(**WIDTHS), j_sr.SRTaskConfig(**kw), seed=5)
        task_t = t_sr.SRHeadNeRFTask(ds_t, TConfig(**WIDTHS), t_sr.SRTaskConfig(**kw), seed=5, device="cpu")
        out[dtype] = (task_j, task_t)
    return out


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-6), ("bfloat16", 2e-3, 1e-5)])
def test_sr_step_matches_jax(sr_pair, dtype, rtol, atol):
    """One full-frame head + SR step with every term on (SR mse, the
    perceptual terms on the raw, SR and lip-crop frames) from the same
    state and noise. float32 SR: losses and gradient norms rtol 1e-4,
    updated params atol 1e-6 (measured 8e-7 and 1.2e-7). bf16 SR blocks
    (XLA's and oneDNN's bf16 convolutions round differently): losses and
    norms rtol 2e-3, updated params atol 1e-5 (measured 1.7e-4, on the
    attention net's gradient norm, and 7.9e-7); the head's losses before
    SR hold 1e-4 either way. The SR's noise_const buffers are stepped, as
    optax steps them in JAX's params, with noise strengths set non-zero."""
    task_j, task_t = sr_pair[dtype]
    occ = _occupancy()
    task_j.occupancy, task_t.occupancy = jnp.asarray(occ), torch.from_numpy(occ)
    state_j, state_t = task_j.create_state(), task_t.create_state()
    # SR noise strengths initialise to 0: non-zero, so the noise path runs
    state_j = state_j.replace(params=jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.full_like(x, 0.15) if p[-1].key == "noise_strength" else x, state_j.params))
    state_j = _sync_states(state_j, state_t, seed=1)
    load_flax_tree(task_t.perceptual.net, _np(task_j.perceptual.params))
    frames_j, frames_t = task_j._device_frames(), task_t._device_frames()
    for k in ("gt", "gt2x", "lip_xy0", "poses"):
        np.testing.assert_array_equal(frames_t[k].numpy(), np.asarray(frames_j[k]), err_msg=k)
    # the torso-composited background (the half-size bg resized bilinearly
    # where cv2 samples: within one level) and the face mask (equal but for
    # hull-boundary pixels, tests/test_torch_train.py): the step runs on JAX's
    bg_j, mask_j = np.array(frames_j["bg"]), np.array(frames_j["mask"])
    assert np.abs(frames_t["bg"].numpy().astype(int) - bg_j).max() <= 1
    assert (frames_t["mask"].numpy() != mask_j).mean() < 0.05
    frames_t["bg"], frames_t["mask"] = torch.from_numpy(bg_j), torch.from_numpy(mask_j)
    noise = _noise(state_j, 256)
    new_j, m_j = task_j.train_step(state_j, {"frame_idx": 2})
    new_t, m_t = task_t.train_step(state_t, {"frame_idx": 2}, noise=torch.from_numpy(noise))
    for k in ("sr_lip_lpips_loss", "sr_lpips_loss", "lpips_loss", "sr_mse_loss"):
        assert k in m_t and float(m_j[k]) > 0, k
    _assert_metrics_close(m_t, m_j, 1e-4, keys=["mse_loss", "weights_entropy_loss", "ambient_loss"])
    _assert_metrics_close(m_t, m_j, rtol)
    _assert_params_close(new_t, new_j.params, atol, f"SR step ({dtype})")
    moved = new_t.model["sr"].block1.conv1.noise_const.detach()
    assert new_t.model["sr"].block1.conv1.noise_const.requires_grad and moved.abs().sum() > 0


def test_sr_staging_validation_and_dual_fm(sr_pair, tmp_path):
    """use_sr / use_lpips follow the step (no SR or perceptual metric before
    their start steps); validation reports val_sr_psnr against the stored
    full-resolution gt and writes the SR renders as PNG; lambda_dual_fm > 0
    raises, naming the discriminator."""
    _, task_t = sr_pair["float32"]
    ds = task_t.dataset
    task = t_sr.SRHeadNeRFTask(ds, TConfig(**WIDTHS), t_sr.SRTaskConfig(
        n_rays=256, num_samples=4, sr_start_iters=1, lpips_start_iters=2, lip_window=8,
        sr_dtype="float32"), seed=5, device="cpu")
    state = task.create_state()
    seen = []
    for step in range(3):
        state, m = task.train_step(state, task.sample_train_batch(global_step=step))
        seen.append(sorted(k for k in m if "sr" in k or "lpips" in k))
    assert seen[0] == [] and seen[1] == ["sr_mse_loss"]
    assert seen[2] == ["lpips_loss", "sr_lip_lpips_loss", "sr_lpips_loss", "sr_mse_loss"]
    val = task.validate(state, max_frames=1, save_dir=str(tmp_path))
    assert np.isfinite(val["val_psnr"]) and np.isfinite(val["val_sr_psnr"])
    png = cv2.imread(str(tmp_path / "validation_results" / "val_sr_3_0.png"))
    assert png.shape == (HW, HW, 3)
    with pytest.raises(NotImplementedError, match="discriminator"):
        t_sr.SRHeadNeRFTask(ds, TConfig(**WIDTHS), t_sr.SRTaskConfig(lambda_dual_fm=0.1), device="cpu")


# ---------------------------------------------------------------- the torso step


def test_torso_step_and_grid_match_jax(ds_dict):
    """One torso step over the frozen head (the full frame, the head without
    gradient, mse + alpha entropy + the deformation term) from the same
    head, torso and Adam state: losses and gradient norms rtol 1e-4,
    updated torso params atol 1e-6 (measured 5.7e-6 and 1.5e-7), the head
    untouched; then the torso grid
    refresh at the same jitter (atol 1e-5) and validation through the
    grid."""
    ds_j = j_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    ds_t = t_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    task_j = j_torso.TorsoNeRFTask(ds_j, JConfig(**WIDTHS), TORSO, seed=5)
    task_t = t_torso.TorsoNeRFTask(ds_t, TConfig(**WIDTHS), TORSO, seed=5, device="cpu")
    task_t.head_model.load_state_dict(convert_flax_params(_np(task_j.head_params), task_t.head_model))
    occ = _occupancy()
    task_j.occupancy, task_t.occupancy = jnp.asarray(occ), torch.from_numpy(occ)
    state_j, state_t = task_j.create_state(), task_t.create_state()
    state_j = _sync_states(state_j, state_t, seed=2)
    head_before = {k: v.clone() for k, v in task_t.head_model.state_dict().items()}
    new_j, m_j = task_j.train_step(state_j, {"frame_idx": 3})
    new_t, m_t = task_t.train_step(state_t, {"frame_idx": 3})
    assert float(m_j["deform_reg"]) > 0
    _assert_metrics_close(m_t, m_j, 1e-4)
    _assert_params_close(new_t, new_j.torso_params, 1e-6, "torso step")
    assert all(torch.equal(v, head_before[k]) for k, v in task_t.head_model.state_dict().items())
    assert all(p.grad is None for p in task_t.head_model.parameters())

    # the 2D grid refresh at the same landmarks and JAX's jitter
    grid0 = np.random.RandomState(8).rand(G, G).astype(np.float32) * 0.5
    key = jax.random.PRNGKey(0)
    jitter = np.asarray(jax.random.uniform(key, (G * G, 2), minval=-1 / G, maxval=1 / G))
    lm = task_t._frame_lm68(1)
    ind_j = task_j.torso_model.apply(new_j.torso_params, 0, method=j_torso.TorsoField.get_individual_code)

    def alpha_j(pts):
        return task_j.torso_model.apply(new_j.torso_params, pts, jnp.asarray(lm), ind_j, None, None).alpha[:, 0]

    g_j, mean_j = j_grid.update_torso_grid(alpha_j, jnp.asarray(grid0), key)
    ind_t = new_t.model.get_individual_code(0)
    lm_t = torch.from_numpy(lm)
    g_t, mean_t = t_grid.update_torso_grid(lambda p: new_t.model(p, lm_t, ind_t, None, None).alpha[:, 0],
                                           torch.from_numpy(grid0), jitter=torch.from_numpy(jitter.copy()))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)
    np.testing.assert_allclose(float(mean_t), float(mean_j), atol=1e-6)
    assert not np.array_equal(g_t.numpy(), grid0)

    task_t.update_extra_state(new_t)  # from the task's own draws
    assert task_t.mean_density_torso > 0
    val = task_t.validate(new_t, max_frames=1)
    assert np.isfinite(val["val_psnr"])


# ---------------------------------------------------------------- parts


def test_load_image_full_res_matches_jax(ds_dict):
    """with_sr datasets: the render-size image and the stored-size one
    (full_res) equal JAX's, exactly (uint8 quantised; the stored 32^2 needs
    no resize, the 16^2 one is bilinear as cv2's, held to 1 level), and a
    record naming a file that is no image raises ValueError naming it."""
    ds_j = j_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    ds_t = t_data.RADNeRFDataset(ds_dict, smo_win_size=3, with_sr=True)
    for i in (0, 3):
        for kind in ("gt", "torso"):
            full_t = ds_t.load_image(i, kind, with_alpha=True, full_res=True)
            full_j = ds_j.load_image(i, kind, with_alpha=True, full_res=True)
            assert full_t.shape[:2] == (HW, HW)
            np.testing.assert_array_equal(full_t, full_j)
            half_t, half_j = ds_t.load_image(i, kind), ds_j.load_image(i, kind)
            assert half_t.shape[:2] == (HW // 2, HW // 2)
            assert np.abs(half_t - half_j).max() <= 1 / 255 + 1e-6
    d = dict(ds_dict, train_samples=[dict(s) for s in ds_dict["train_samples"]])
    path = os.path.join(os.path.dirname(__file__), "test_torch_train_steps.py")
    d["train_samples"][0].pop("gt_img")
    d["train_samples"][0]["gt_img_fname"] = path
    with pytest.raises(ValueError, match="test_torch_train_steps.py: not a PNG or JPEG file"):
        t_data.RADNeRFDataset(d, with_sr=True).load_image(0, "gt", full_res=True)


@pytest.mark.parametrize("arch,hw", [("small", 32), ("vgg19", 64)])
def test_perceptual_loss_matches_jax(arch, hw):
    """JAX's weights carried across: the loss rtol 1e-5 and its input
    gradient (relative L2 <= 1e-5 for the small stack; for vgg19 <= 1e-2:
    its L1 distance's gradient is sign(x - y), which float noise flips
    where features nearly agree). vgg19 at 64^2 also runs a
    half-resolution pass (antialiased bilinear)."""
    rs = np.random.RandomState(0)
    jp = j_perc.PerceptualLoss(arch=arch)
    tp = t_perc.PerceptualLoss(arch=arch)
    load_flax_tree(tp.net, _np(jp.params))
    a = rs.rand(2, hw, hw, 3).astype(np.float32)
    b = rs.rand(2, hw, hw, 3).astype(np.float32)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda x: jp(x, jnp.asarray(b))))(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    loss_t = tp(at, torch.from_numpy(b))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    rel = np.linalg.norm(at.grad.numpy() - g_j) / np.linalg.norm(g_j)
    assert rel <= (1e-5 if arch == "small" else 1e-2), rel
    assert not any(p.requires_grad for p in tp.parameters())


def test_perceptual_vgg19_with_vggface_file_matches_jax(tmp_path):
    """vgg19 with the VGGFace tower read from a weights file (JAX's msgpack
    tree, written here by flax from a seeded init): JAX's weights carried
    across, the loss rtol 1e-5 at 64^2 (the VGGFace term included)."""
    rs = np.random.RandomState(1)
    face = jax.jit(lambda: j_perc.VGG16Features().init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3))))()
    path = tmp_path / "vggface.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(_np(face)))
    jp = j_perc.PerceptualLoss(arch="vgg19", vggface_weights_path=str(path))
    tp = t_perc.PerceptualLoss(arch="vgg19", vggface_weights_path=str(path))
    load_flax_tree(tp.net, _np(jp.params))
    a, b = (rs.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
    loss_j = float(jax.jit(jp.__call__)(jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        loss_t = tp(torch.from_numpy(a), torch.from_numpy(b)).item()
        no_face = t_perc.PerceptualLoss(arch="vgg19")
        load_flax_tree(no_face.net, _np(jp.params))
        assert no_face(torch.from_numpy(a), torch.from_numpy(b)).item() < loss_t  # the face term adds
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)


def test_perceptual_weights_files_and_export(tmp_path):
    """A weights file is JAX's msgpack tree (written here by flax) and loads
    into the port; a named file that is missing raises; the bridge's export
    of the port's tower is JAX's tree."""
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadTaskConfig

    jp = j_perc.PerceptualLoss(arch="small", seed=3)
    path = tmp_path / "small.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(_np(jp.params)))
    tp = t_perc.PerceptualLoss(arch="small", weights_path=str(path))
    exported = export_flax_tree(tp.net)
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(_np(jp.params))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(exported) == jax.tree_util.tree_structure(_np(jp.params))
    with pytest.raises(FileNotFoundError, match="vgg_weights_path"):
        t_perc.perceptual_from_task_config(HeadTaskConfig(vgg_weights_path=str(tmp_path / "none")))
    assert t_perc.perceptual_from_task_config(HeadTaskConfig()).arch == "small"


@pytest.mark.parametrize("h,w", [(1, 1), (7, 5), (32, 48)])
def test_png_reads_back_through_cv2(tmp_path, h, w):
    """The port's PNG writer: cv2 reads the same pixels back (RGB order)."""
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], img)
    np.testing.assert_array_equal(image_io.to_u8(np.asarray([[[0.0, 0.5, 1.2]]], np.float32)),
                                  [[[0, 128, 255]]])
