"""Live-sample compaction and top-K colour on the render side, port vs JAX
on the CPU: `render_rays` with `compact_frac` and `color_topk` (the eight
cases of tests/test_topk_color.py, each run through both packages on the
same scene, weights and options), the compact buffer's layout, the
gradient where pad slots write the slot of sample 0, and the pipeline's
`compact_frac: "auto"` budget and frames.

Tolerances: the port against JAX to 1e-4 on every output (float32 on both,
summed in other orders; measured under 1e-5 here), with the Fourier scales
cut to 16 / 8 as tests/test_torch_train.py does; a case's own claim (K = S
equals the full render, the geometry is exact for any K, ...) at JAX's own
tolerance."""

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
from genefaceplusplus_tpu.utils.rays import get_rays
from genefaceplusplus_tpu_torch.models import full_renderer as t_fr
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions as TOptions
from genefaceplusplus_tpu_torch.models.renderer import compact_slots, render_rays as t_render_rays
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

ATOL = 1e-4
G, H, W, S = 32, 24, 24, 8
CFG = dict(grid_size=G, individual_embedding_num=4, smo_win_size=3, fourier_pos_features=16,
           fourier_amb_features=8, hidden_dim_sigma=32, hidden_dim_ambient=32, hidden_dim_color=32,
           geo_feat_dim=16, fourier_pos_max_scale=16.0, fourier_amb_max_scale=8.0)


@pytest.fixture(scope="module")
def scene():
    """tests/test_topk_color.py's scene (an ellipsoid blob seen from 2.2
    units) and model, with the same seeded weights and condition in both
    packages."""
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, G)] * 3), indexing="ij")
    occ = (xx ** 2 + (2.0 * yy) ** 2 + zz ** 2) < 0.25
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.2
    rays = get_rays(jnp.asarray(pose[None]), (1.2 * W, 1.2 * H, W / 2, H / 2), H, W)
    ro, rd = np.asarray(rays["rays_o"][0]), np.asarray(rays["rays_d"][0])
    jm = JRADNeRF(JConfig(**CFG))
    # a seeded condition: at an all-zero one the condition net's pre-activations
    # sit at 0, where JAX's and torch's leaky ReLU derivatives differ
    cond = np.random.RandomState(2).randn(jm.cfg.smo_win_size, jm.cfg.cond_win_size,
                                          jm.cfg.cond_in_dim).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.asarray(cond))
    tm = TRADNeRF(TConfig(**CFG))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    return dict(occ=occ, ro=ro, rd=rd, jm=jm, params=params, tm=tm, cond=cond)


def _fns(s, boost):
    """(field, sigma, colour) closures of both packages, sigma + `boost`."""
    jm, params, tm = s["jm"], s["params"], s["tm"]
    cf = jm.apply(params, jnp.asarray(s["cond"]), method=JRADNeRF.cal_cond_feat)
    ind = jm.apply(params, 0, method=JRADNeRF.get_individual_code)
    cf_t, ind_t = torch.from_numpy(np.asarray(cf)), torch.from_numpy(np.asarray(ind))

    def j_field(x, d):
        sg, c, a = jm.apply(params, x, d, cf, ind, method=JRADNeRF.field)
        return sg + boost, c, a

    def j_sigma(x):
        sg, g, a = jm.apply(params, x, cf, method=JRADNeRF.field_sigma)
        return sg + boost, g, a

    def t_field(x, d):
        sg, c, a = tm.field(x, d, cf_t, ind_t)
        return sg + boost, c, a

    def t_sigma(x):
        sg, g, a = tm.field_sigma(x, cf_t)
        return sg + boost, g, a

    return ((j_field, j_sigma, lambda g, d: jm.apply(params, g, d, ind, method=JRADNeRF.field_color)),
            (t_field, t_sigma, lambda g, d: tm.field_color(g, d, ind_t)))


def _render(s, boost=0.0, split=True, **kw):
    """(JAX output, port output) of render_rays on the scene with options
    `kw` (S = 8, T_thresh 1e-3, bg 0.7)."""
    (jf, js, jc), (tf, ts, tc) = _fns(s, boost)
    o_j = jax.jit(lambda ro, rd: j_render_rays(
        jf, ro, rd, jnp.asarray(s["occ"]), bound=1.0, min_near=0.05, bg_color=0.7,
        opts=JOptions(num_samples=S, T_thresh=1e-3, **kw), sigma_fn=js if split else None,
        color_fn=jc if split else None))(jnp.asarray(s["ro"]), jnp.asarray(s["rd"]))
    with torch.no_grad():
        o_t = t_render_rays(tf, torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]), torch.from_numpy(s["occ"]),
                            bound=1.0, min_near=0.05, bg_color=0.7,
                            opts=TOptions(num_samples=S, T_thresh=1e-3, **kw),
                            sigma_fn=ts if split else None, color_fn=tc if split else None)
    for name, a, b in zip(o_j._fields, o_j, o_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0, err_msg=f"{kw} {name}")
    return o_j, o_t


def _full_frame(s, **kw):
    """(JAX, port) render_full_frame of the scene, head only, f32 field."""
    jm, params, tm = s["jm"], s["params"], s["tm"]
    bg = np.full((H * W, 3), 0.7, np.float32)
    crop = kw.pop("head_crop", None)
    o_j = jax.jit(lambda p, ro, rd, cond, occ, bg_: j_fr.render_full_frame(
        jm, p, ro, rd, cond, occ, bg_color=bg_, opts=JOptions(num_samples=S, T_thresh=1e-3, **kw),
        image_hw=(H, W), head_crop=crop))(params, jnp.asarray(s["ro"]), jnp.asarray(s["rd"]),
                                          jnp.asarray(s["cond"]), jnp.asarray(s["occ"]), jnp.asarray(bg))
    with torch.no_grad():
        o_t = t_fr.render_full_frame(tm, torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]),
                                     torch.from_numpy(s["cond"]), torch.from_numpy(s["occ"]), torch.from_numpy(bg),
                                     TOptions(num_samples=S, T_thresh=1e-3, **kw), (H, W), head_crop=crop)
    np.testing.assert_allclose(o_t.rgb_map.numpy(), np.asarray(o_j.rgb_map), atol=ATOL, rtol=0, err_msg=str(kw))
    return o_j, o_t


def _march_mask(ro, rd, occ):
    """The port's march mask [R, S] of the scene's options."""
    from genefaceplusplus_tpu_torch.models.renderer import make_aabb
    from genefaceplusplus_tpu_torch.ops import raymarch

    ro, rd, occ = torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(occ)
    nears, fars = raymarch.near_far_from_aabb(ro, rd, make_aabb(1.0), 0.05)
    return raymarch.march_rays_interval(ro, rd, nears, fars, raymarch.occupancy_aabb(occ, 1.0), bound=1.0,
                                        num_samples=S, min_near=0.05, grid_size=G).mask


def _live_frac(s):
    return float(_march_mask(s["ro"], s["rd"], s["occ"]).float().mean())


def case_topk_equals_full_when_k_is_s(s):
    _, full = _render(s, split=False)
    _, topk = _render(s, color_topk=S)
    np.testing.assert_allclose(topk.rgb_map.numpy(), full.rgb_map.numpy(), atol=2e-5)
    np.testing.assert_allclose(topk.weights_sum.numpy(), full.weights_sum.numpy(), atol=1e-6)


def case_topk_geometry_outputs_exact_for_any_k(s):
    _, full = _render(s, split=False)
    for K in (2, 4):
        _, topk = _render(s, color_topk=K)
        for name, atol in (("weights_sum", 1e-6), ("depth_map", 1e-5), ("ambient_sum", 1e-5), ("weights", 1e-6)):
            np.testing.assert_allclose(getattr(topk, name).numpy(), getattr(full, name).numpy(), atol=atol,
                                       err_msg=name)


def case_topk_close_on_opaque_surface(s):
    _, full = _render(s, boost=50.0, split=False)
    _, topk = _render(s, boost=50.0, color_topk=4)
    mse = float(((topk.rgb_map - full.rgb_map) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-12)) > 40.0


def case_topk_ignored_without_split_fns(s):
    _, full = _render(s, split=False)
    _, alt = _render(s, split=False, color_topk=4)
    np.testing.assert_array_equal(alt.rgb_map.numpy(), full.rgb_map.numpy())


def case_full_frame_topk_wiring(s):
    _, full = _full_frame(s)
    _, topk = _full_frame(s, color_topk=S)
    np.testing.assert_allclose(topk.rgb_map.numpy(), full.rgb_map.numpy(), atol=2e-5)
    _full_frame(s, color_topk=3, head_crop=(20, 20))  # the head-crop branch, against JAX


def case_compact_exact_when_budget_covers_live(s):
    assert _live_frac(s) < 0.85  # the scene has dead samples to skip
    _, full = _render(s, split=False)
    _, comp = _render(s, split=False, compact_frac=0.9)
    np.testing.assert_allclose(comp.rgb_map.numpy(), full.rgb_map.numpy(), atol=2e-5)
    np.testing.assert_allclose(comp.weights_sum.numpy(), full.weights_sum.numpy(), atol=1e-6)
    np.testing.assert_allclose(comp.depth_map.numpy(), full.depth_map.numpy(), atol=1e-5)
    _, both = _render(s, compact_frac=0.9, color_topk=S)
    np.testing.assert_allclose(both.rgb_map.numpy(), full.rgb_map.numpy(), atol=2e-5)
    _render(s, compact_frac=0.5, color_topk=3)  # both options, a K below S, against JAX


def case_compact_overflow_degrades_gracefully(s):
    _, full = _render(s, boost=50.0, split=False)
    _, tiny = _render(s, boost=50.0, split=False, compact_frac=0.05)
    out = tiny.rgb_map.numpy()
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    assert float(tiny.weights_sum.sum()) <= float(full.weights_sum.sum()) + 1e-4
    # the budget really overflows: the dropped tail shows in the weights
    assert float(tiny.weights_sum.sum()) < float(full.weights_sum.sum()) - 1.0


def case_compact_full_frame_wiring(s):
    _, full = _full_frame(s)
    _, comp = _full_frame(s, compact_frac=0.9)
    np.testing.assert_allclose(comp.rgb_map.numpy(), full.rgb_map.numpy(), atol=2e-5)
    _, crop = _full_frame(s, compact_frac=0.9, head_crop=(20, 20))
    _, crop_full = _full_frame(s, head_crop=(20, 20))
    np.testing.assert_allclose(crop.rgb_map.numpy(), crop_full.rgb_map.numpy(), atol=2e-5)


CASES = [case_topk_equals_full_when_k_is_s, case_topk_geometry_outputs_exact_for_any_k,
         case_topk_close_on_opaque_surface, case_topk_ignored_without_split_fns, case_full_frame_topk_wiring,
         case_compact_exact_when_budget_covers_live, case_compact_overflow_degrades_gracefully,
         case_compact_full_frame_wiring]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_render_matches_jax(scene, case):
    """Each case of tests/test_topk_color.py, its claim checked on the
    port's renders, and every render held to JAX's on the same inputs."""
    case(scene)


def _j_slots(mask, cf):
    """JAX's src and rank (models/renderer.py:146-161) for a mask [N]."""
    N = mask.shape[0]
    M = min(N, max(512, ((int(cf * N) + 511) // 512) * 512))
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask & (rank < M), rank, M)
    src = jnp.zeros((M + 1,), jnp.int32).at[dest].set(jnp.arange(N, dtype=jnp.int32), mode="drop")[:M]
    return np.asarray(src), np.asarray(rank)


@pytest.mark.parametrize("n_live,first_live,cf", [(300, True, 0.5), (300, False, 0.5), (1200, True, 0.25),
                                                  (0, False, 0.3), (2048, True, 0.9)])
def test_compact_slots_layout_matches_jax(n_live, first_live, cf):
    """src and rank equal JAX's (pad slots evaluate sample 0; an overflow
    drops the flat-order tail); dest hands each of the N slots to at most
    one compact slot, the last that evaluates it."""
    rs = np.random.RandomState(n_live)
    N = 2048
    mask = np.zeros(N, bool)
    live = rs.choice(np.arange(1, N), size=n_live - int(first_live), replace=False) if n_live else []
    mask[live] = True
    mask[0] = first_live
    src, rank, dest = compact_slots(torch.from_numpy(mask).reshape(64, 32), cf)
    src_j, rank_j = _j_slots(jnp.asarray(mask), cf)
    np.testing.assert_array_equal(src.numpy(), src_j)
    np.testing.assert_array_equal(rank.numpy(), rank_j)
    written = dest.numpy()[dest.numpy() < N]
    assert len(np.unique(written)) == len(written)  # one writer a slot
    assert set(written) == set(src.numpy())
    for slot in set(src.numpy()):
        assert dest.numpy()[np.flatnonzero(src.numpy() == slot).max()] == slot


def test_pad_slot_gradient_matches_jax(scene):
    """The duplicate writers of slot 0: ray 0's first sample is live, the
    budget has pad slots (which all evaluate sample 0), and the loss reads
    the image, the weights and the ambient sums (a training loss's terms;
    `ambient_pos` of a dead slot is the field's value in the full-slot
    render and 0 in the compacted one, and no loss reads it unmasked). The parameters' gradients equal JAX's (whose scatter
    hands a slot's cotangent to one writer) and the full-slot render's;
    a scatter that gives it to every writer counts sample 0 once a pad
    slot more. Tolerance: 1e-4 of each gradient's largest entry, cosine
    >= 0.9999 (float32 sums in other orders)."""
    s = scene
    occ = s["occ"]
    centre = (H // 2) * W + W // 2
    order = np.concatenate([[centre], np.delete(np.arange(H * W), centre)])  # ray 0 hits the blob's middle
    ro, rd = s["ro"][order], s["rd"][order]
    rs = np.random.RandomState(4)
    target = rs.rand(H * W, 3).astype(np.float32)
    amb_w = rs.rand(H * W).astype(np.float32)
    cf = 0.9
    jm, params, tm = s["jm"], s["params"], s["tm"]
    cond = jnp.asarray(s["cond"])
    opts_kw = dict(num_samples=S, T_thresh=1e-3)

    def loss_j(p, compact):
        cf_ = jm.apply(p, cond, method=JRADNeRF.cal_cond_feat)
        ind = jm.apply(p, 0, method=JRADNeRF.get_individual_code)
        out = j_render_rays(lambda x, d: jm.apply(p, x, d, cf_, ind, method=JRADNeRF.field), jnp.asarray(ro),
                            jnp.asarray(rd), jnp.asarray(occ), bound=1.0, min_near=0.05, bg_color=0.7,
                            opts=JOptions(**opts_kw, compact_frac=cf if compact else 0.0))
        return (jnp.mean((out.rgb_map - target) ** 2) + jnp.mean(out.weights_sum ** 2)
                + jnp.mean(out.ambient_sum * amb_w))

    def grads_t(compact):
        tm.zero_grad()
        cf_ = tm.cal_cond_feat(torch.from_numpy(s["cond"]))
        ind = tm.get_individual_code(0)
        out = t_render_rays(lambda x, d: tm.field(x, d, cf_, ind), torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.from_numpy(occ), bound=1.0, min_near=0.05, bg_color=0.7,
                            opts=TOptions(**opts_kw, compact_frac=cf if compact else 0.0))
        loss = (((out.rgb_map - torch.from_numpy(target)) ** 2).mean() + (out.weights_sum ** 2).mean()
                + (out.ambient_sum * torch.from_numpy(amb_w)).mean())
        loss.backward()
        return {k: p.grad.detach().clone() for k, p in tm.named_parameters()}

    mask = _march_mask(ro, rd, occ)
    N = H * W * S
    M = min(N, max(512, ((int(cf * N) + 511) // 512) * 512))
    assert bool(mask[0, 0]), "ray 0's first sample must be live"
    assert int(mask.sum()) < M, "the budget must have pad slots"
    g_t = grads_t(True)
    g_full = grads_t(False)
    g_j = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_j), static_argnums=1)(params, True))
    g_j = convert_flax_params(g_j, tm)
    for name, g in g_t.items():
        for ref, what in ((g_j[name], "jax"), (g_full[name], "full-slot")):
            a, b = g.double().numpy().ravel(), ref.double().numpy().ravel()
            scale = np.abs(b).max()
            if scale == 0.0:
                assert np.abs(a).max() == 0.0, (name, what)
                continue
            assert np.abs(a - b).max() <= 1e-4 * scale, (name, what, np.abs(a - b).max() / scale)
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999, (name, what)


# ---------------------------------------------------------------- the pipeline

PIPE_H = 32
PIPE_HEAD = {"with_sr": False, "grid_size": 16, "smo_win_size": 3, "cond_win_size": 1,
             "individual_embedding_num": 4}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """JAX's and the port's GeneFaceInfer on one synthetic identity, the same
    head weights and tests/test_inference_e2e.py's box occupancy."""
    from genefaceplusplus_tpu.config import save_config
    from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
    from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic
    from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
    from genefaceplusplus_tpu_torch.data.dataset import synthetic as t_synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer

    head_dir = str(tmp_path_factory.mktemp("ckpts") / "head")
    save_config(PIPE_HEAD, head_dir)
    j_ds = JDataset(j_synthetic(num_frames=6, H=PIPE_H, W=PIPE_H), split="train", smo_win_size=3, with_sr=False)
    j_inf = JInfer(head_model_dir=head_dir, dataset=j_ds)
    occ = np.zeros((16, 16, 16), bool)
    occ[5:11, 5:11, 5:11] = True
    j_inf.occupancy = jnp.asarray(occ)
    cfg = TConfig.from_hparams(PIPE_HEAD)
    params = convert_flax_params(jax.tree.map(np.asarray, j_inf.head_params), TRADNeRF(cfg))
    t_ds = TDataset(t_synthetic(num_frames=6, H=PIPE_H, W=PIPE_H), smo_win_size=3, with_sr=False)
    return j_inf, TInfer(cfg, params, t_ds, occ, device="cpu")


def test_pipeline_auto_compact_matches_jax_and_is_lossless(pipe, capsys):
    """tests/test_inference_e2e.py::test_pipeline_auto_compact_lossless_end_to_end
    on the port: `_auto_compact_frac` returns JAX's budget on the same poses
    (with and without a head crop), quantised to 512 slots and below 0.9;
    frames with the measured budget equal the uncompacted ones (floats to
    atol 1e-4, JAX's bound; uint8 frames to one level of 255, where a
    float on a rounding edge may land either side); 'auto' through
    forward_secc2video prints the budget."""
    j_inf, t_inf = pipe
    opts = dict(num_coarse=48, num_samples=8, T_thresh=1e-2, entry_mode="probe")
    poses = np.stack([t_inf.dataset.frame_pose(i) for i in range(4)])
    for crop in (None, (24, 24)):
        frac_j = j_inf._auto_compact_frac(poses, JOptions(**opts), (PIPE_H, PIPE_H), head_crop=crop)
        frac_t = t_inf._auto_compact_frac(poses, TOptions(**opts), (PIPE_H, PIPE_H), head_crop=crop)
        assert frac_t == frac_j
    frac = t_inf._auto_compact_frac(poses, TOptions(**opts), (PIPE_H, PIPE_H), head_crop=None)
    assert 0.0 < frac < 0.9, frac
    M = frac * (PIPE_H * PIPE_H * opts["num_samples"])
    assert abs(M - round(M)) < 1e-4 and round(M) % 512 == 0, M
    assert t_inf._auto_compact_frac(poses[:3], TOptions(**opts), (PIPE_H, PIPE_H), None) in (frac, 0.0)

    inp = {"num_samples": 8, "head_crop": "off"}
    batch = t_inf.prepare_gt_batch(range(2))
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    ro, rd = pixel_rays(torch.from_numpy(batch["poses"]), t_inf.dataset.intrinsics, PIPE_H, PIPE_H)
    wins = get_audio_features_batch(torch.from_numpy(batch["cond"]), torch.arange(2), 3)
    with torch.no_grad():
        for j in range(2):
            args = (ro[j], rd[j], wins[j], torch.from_numpy(batch["eye_area_percent"][j]),
                    torch.from_numpy(batch["lm68"][j][None]))
            exact = t_inf.render_frame(*args, inp=inp).rgb_map
            comp = t_inf.render_frame(*args, inp={**inp, "compact_frac": frac}).rgb_map
            np.testing.assert_allclose(comp.numpy(), exact.numpy(), atol=1e-4)
    frames_exact = np.stack(list(t_inf.forward_secc2video(batch, inp)))
    capsys.readouterr()
    frames_auto = np.stack(list(t_inf.forward_secc2video(batch, {**inp, "compact_frac": "auto"})))
    printed = capsys.readouterr().out
    budget = t_inf._auto_compact_frac(batch["poses"], TOptions(**opts), (PIPE_H, PIPE_H), None)
    assert f"compact_frac={budget}" in printed and 0.0 < budget < 0.9
    assert np.abs(frames_auto.astype(int) - frames_exact.astype(int)).max() <= 1


@pytest.mark.parametrize("extra,max_levels", [({"compact_frac": "auto"}, 0), ({"compact_frac": 0.9}, 1),
                                               ({"color_topk": 4}, 255)])
def test_stream_renders_with_compaction_options(extra, max_levels):
    """stream_infer takes both options without raising. "auto" is off in a
    stream (its pose track is not known yet, as in JAX's stream): the plain
    frames bit for bit; a covering float budget gives them to one level of
    255; top-4 colour of 10 samples stays within 30 dB PSNR of them."""
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.testing import tiny_infer

    infer = tiny_infer()
    rs = np.random.RandomState(0)
    wav = (0.3 * np.sin(2 * np.pi * 120.0 * np.arange(24000) / 16000.0)).astype(np.float32)
    inp = {"hubert_full": rs.randn(91, 64).astype(np.float32), "temperature": 0.0}
    plain = np.stack(list(stream_infer(infer, wav, dict(inp), chunk_seconds=1.0)))
    got = np.stack(list(stream_infer(infer, wav, dict(inp, **extra), chunk_seconds=1.0)))
    assert got.shape == plain.shape
    d = np.abs(got.astype(int) - plain.astype(int))
    assert d.max() <= max_levels
    assert 10 * np.log10(255.0 ** 2 / max((d.astype(float) ** 2).mean(), 1e-12)) >= 30.0
