"""The slice as a whole: the full frame (head + torso + 2x SR) of the port
vs the JAX package, on the CPU.

- render_full_frame with the torso and SR, crops off and on, vs JAX's, with
  the float32 model field and float32 SR: atol 1e-4 (float summation
  order only);
- inside the port, the lossless properties at JAX's own bounds
  (tests/test_full_renderer.py): torso crop vs full 1e-5, SR crop vs full
  2e-5, sr_apply_batched vs per frame 1e-5;
- auto_sr_crop, and the with_sr dataset (half size, scaled intrinsics, the
  background resized where cv2.INTER_LINEAR samples) vs JAX's;
- GeneFaceInfer with torso and SR (the bf16 fused field's plain version,
  bf16 SR) vs the JAX GeneFaceInfer (float32 flax field, bf16 SR) through
  serving._render_frames at the bar of tests/test_torch_pipeline.py:
  PSNR >= 42 dB and mean |d| <= 1.5 levels per uint8 frame."""

import dataclasses
import math
import os

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.config import save_config, set_hparams
from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic
from genefaceplusplus_tpu.inference import serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.models import full_renderer as j_fr
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoConfig as JTorsoConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoField as JTorso
from genefaceplusplus_tpu.models.renderer import RenderOptions as JOptions
from genefaceplusplus_tpu.models.superresolution import Superresolution as JSR
from genefaceplusplus_tpu.utils.rays import pixel_rays as j_pixel_rays
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import resize_bilinear
from genefaceplusplus_tpu_torch.data.dataset import synthetic as t_synthetic
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.models import full_renderer as t_fr
from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_SR, MAY_LM3D_RADNERF_TORSO_SR
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig as TTorsoConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField as TTorso
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions as TOptions
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution as TSR
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params
from genefaceplusplus_tpu_torch.utils.rays import get_bg_coords

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
H = W = 32  # GeneFaceInfer's raw render; SR makes it 64^2
SH = SW = 48  # render_full_frame's raw render
CFG = dict(smo_win_size=3, grid_size=16, individual_embedding_num=8, fourier_pos_features=16,
           fourier_amb_features=8, hidden_dim_ambient=32, hidden_dim_sigma=32,
           hidden_dim_color=32, geo_feat_dim=16)
OPTS = dict(num_samples=10, T_thresh=1e-2, entry_mode="probe")
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_noise(variables):
    flat = flax.traverse_util.flatten_dict(variables)
    for i, k in enumerate(sorted(flat)):
        if k[-1] == "noise_strength":
            flat[k] = jnp.asarray(0.3 + 0.05 * i, jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _occupancy_2d(g=16):
    occ2d = np.zeros((g, g), np.float32)
    occ2d[11 * g // 16:15 * g // 16, 6 * g // 16:10 * g // 16] = 1.0
    return occ2d


@pytest.fixture(scope="module")
def scene():
    """A grid-16 head, a torso and an SR at raw 48^2, seen from 2.5 units
    (tests/test_full_renderer.py's geometry), where both crops engage."""
    rs = np.random.RandomState(0)
    jm = JRADNeRF(JConfig(**CFG))
    cond = rs.randn(3, 1, 204).astype(np.float32)
    hp = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.asarray(cond))
    tm = TRADNeRF(TConfig(**CFG))
    tm.load_state_dict(convert_flax_params(_np(hp), tm))

    tcfg = dict(torso_individual_embedding_num=4, grid_size=16)
    jt = JTorso(JTorsoConfig(**tcfg))
    bg_coords = np.asarray(get_bg_coords(SH, SW)[0])
    lm68 = rs.rand(1, 68, 2).astype(np.float32)
    tp = jt.init(jax.random.PRNGKey(2), jnp.asarray(bg_coords[:8]), jnp.asarray(lm68), jnp.zeros(8),
                 jnp.zeros((8, 3)), jnp.zeros((8, 1)))
    tt = TTorso(TTorsoConfig(**tcfg))
    tt.load_state_dict(convert_flax_params(_np(tp), tt))

    js = JSR(channels=3, input_resolution=SW)
    sp = _with_noise(js.init(jax.random.PRNGKey(3), jnp.zeros((1, SH, SW, 3))))
    ts = TSR(3, SW)
    ts.load_state_dict(convert_flax_params(_np(sp), ts))

    occ = np.zeros((16, 16, 16), bool)
    occ[7:9, 7:9, 7:9] = True
    occ2d = np.zeros((16, 16), np.float32)
    occ2d[13:15, 7:9] = 1.0
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    intr = (2.0 * SW, 2.0 * SH, SW / 2, SH / 2)
    ro, rd, _ = j_pixel_rays(jnp.asarray(pose[None]), intr, SH, SW)
    bbox = t_fr.auto_head_bbox(torch.from_numpy(occ), pose[None], intr, SH, SW)
    torso_crop = t_fr.auto_torso_crop(torch.from_numpy(occ2d), SH, SW, pad_px=2, multiple=4)
    sr_crop = t_fr.auto_sr_crop(bbox, torso_crop, SH, SW, pad_px=1, margin=6, multiple=4)
    bg = rs.rand(SH * SW, 3).astype(np.float32)
    with torch.no_grad():
        sr_bg = torch.clamp(ts(torch.from_numpy(bg).reshape(1, SH, SW, 3)), 0.0, 1.0)[0]
    return dict(jm=jm, hp=hp, tm=tm, jt=jt, tp=tp, tt=tt, js=js, sp=sp, ts=ts, occ=occ, occ2d=occ2d,
                ro=np.array(ro[0]), rd=np.array(rd[0]), cond=cond, eye=np.asarray([[0.3]], np.float32),
                bg=bg, bg_coords=bg_coords, lm68=lm68, torso_crop=torso_crop, sr_crop=sr_crop, sr_bg=sr_bg)


def _port_frame(s, **kw):
    with torch.no_grad():
        return t_fr.render_full_frame(
            s["tm"], torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]), torch.from_numpy(s["cond"]),
            torch.from_numpy(s["occ"]), torch.from_numpy(s["bg"]), TOptions(**OPTS), (SH, SW),
            eye_area_percent=torch.from_numpy(s["eye"]), index=1, torso_model=s["tt"],
            bg_coords=torch.from_numpy(s["bg_coords"]), lm68=torch.from_numpy(s["lm68"]),
            occupancy_2d=torch.from_numpy(s["occ2d"]), sr_model=s["ts"], **kw)


def test_the_crops_engage(scene):
    s = scene
    (orr, orc, oh, ow), (ir, ic, ih, iw) = s["sr_crop"]
    assert s["torso_crop"][2] * s["torso_crop"][3] < SH * SW and oh * ow < SH * SW
    assert orr <= ir and orc <= ic and ir + ih <= orr + oh and ic + iw <= orc + ow


@pytest.mark.parametrize("crops", [False, True])
def test_full_frame_matches_jax(scene, crops):
    """Head + torso + SR, float32, vs JAX's render_full_frame."""
    s = scene
    kw = dict(torso_crop=s["torso_crop"], sr_crop=s["sr_crop"]) if crops else {}
    out_j = j_fr.render_full_frame(
        s["jm"], s["hp"], jnp.asarray(s["ro"]), jnp.asarray(s["rd"]), jnp.asarray(s["cond"]),
        jnp.asarray(s["occ"]), jnp.asarray(s["bg"]), JOptions(**OPTS), (SH, SW),
        eye_area_percent=jnp.asarray(s["eye"]), index=1, torso_model=s["jt"], torso_params=s["tp"],
        bg_coords=jnp.asarray(s["bg_coords"]), lm68=jnp.asarray(s["lm68"]),
        occupancy_2d=jnp.asarray(s["occ2d"]), sr_model=s["js"], sr_params=s["sp"],
        sr_bg=jnp.asarray(s["sr_bg"].numpy()) if crops else None, **kw)
    out_t = _port_frame(s, sr_bg=s["sr_bg"] if crops else None, **kw)
    for name in ("rgb_map", "sr_rgb_map", "weights_sum", "depth_map", "torso_alpha", "torso_rgb"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    assert out_t.sr_rgb_map.shape == (2 * SH, 2 * SW, 3)
    assert float(out_t.weights_sum.max()) > 0.05 and float(out_t.torso_alpha.max()) > 0.05


def test_torso_crop_is_lossless(scene):
    s = scene
    full, crop = _port_frame(s), _port_frame(s, torso_crop=s["torso_crop"])
    torch.testing.assert_close(crop.rgb_map, full.rgb_map, atol=1e-5, rtol=0)
    torch.testing.assert_close(crop.torso_alpha, full.torso_alpha, atol=1e-5, rtol=0)


def test_sr_crop_is_lossless(scene):
    """Pasting the SR of the outer rect into SR(bg) equals full-frame SR,
    the const noise included (noise_strength != 0)."""
    s = scene
    assert s["ts"].block1.conv1.noise_strength.item() != 0.0
    full = _port_frame(s)
    crop = _port_frame(s, torso_crop=s["torso_crop"], sr_crop=s["sr_crop"], sr_bg=s["sr_bg"])
    torch.testing.assert_close(crop.sr_rgb_map, full.sr_rgb_map, atol=2e-5, rtol=0)


def test_sr_apply_batched_matches_per_frame(scene):
    s = scene
    raws = torch.from_numpy(np.random.RandomState(4).rand(3, SH, SW, 3).astype(np.float32))
    for crop, bg in ((None, None), (s["sr_crop"], s["sr_bg"])):
        with torch.no_grad():
            batched = t_fr.sr_apply_batched(s["ts"], raws, crop, bg)
            assert batched.shape == (3, 2 * SH, 2 * SW, 3)
            for i in range(3):
                single = t_fr.sr_apply_batched(s["ts"], raws[i:i + 1], crop, bg)[0]
                torch.testing.assert_close(batched[i], single, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bbox,torso", [((10.2, 17.8, 12.5, 20.1), (20, 9, 8, 12)),
                                        ((10.2, 17.8, 12.5, 20.1), None),
                                        ((-3.0, 40.0, 2.0, 30.0), None),
                                        (None, (20, 9, 8, 12))])
def test_auto_sr_crop_matches_jax(bbox, torso):
    for kw in ({}, {"pad_px": 1, "margin": 6, "multiple": 4}, {"margin": 4, "max_area_frac": 1.1}):
        assert t_fr.auto_sr_crop(bbox, torso, H, W, **kw) == j_fr.auto_sr_crop(bbox, torso, H, W, **kw)


def test_with_sr_dataset_matches_jax():
    """with_sr: half the stored size, intrinsics scaled, the background
    resized where cv2.INTER_LINEAR samples."""
    ds_dict = t_synthetic(num_frames=6, H=64, W=48, seed=2)
    t, j = TDataset(ds_dict, smo_win_size=3, with_sr=True), JDataset(ds_dict, smo_win_size=3, with_sr=True)
    assert (t.H, t.W) == (j.H, j.W) == (32, 24) and t.intrinsics == j.intrinsics
    np.testing.assert_allclose(t.bg_img, j.bg_img, atol=1e-6)
    np.testing.assert_array_equal(t.poses, j.poses)
    rs = np.random.RandomState(5)
    for (h, w), (h2, w2) in (((64, 48), (32, 24)), ((37, 29), (18, 14)), ((20, 16), (33, 27))):
        img = rs.rand(h, w, 3).astype(np.float32)
        np.testing.assert_allclose(resize_bilinear(img, h2, w2), cv2.resize(img, (w2, h2)), atol=1e-5)


def test_sr_head_config_matches_the_yaml():
    hp = set_hparams(config=os.path.join(REPO, "egs/datasets/May/lm3d_radnerf_sr.yaml"))
    for k, v in MAY_LM3D_RADNERF_SR.items():
        assert hp[k] == v, k
    assert dataclasses.asdict(TConfig.from_hparams(MAY_LM3D_RADNERF_SR)) == \
        dataclasses.asdict(JConfig.from_hparams(hp))


# ---- GeneFaceInfer with torso and SR ------------------------------------

HEAD = {"with_sr": True, "sr_dtype": "bfloat16", "grid_size": 16, "smo_win_size": 3,
        "cond_win_size": 1, "individual_embedding_num": 16, "add_eye_blink_cond": True}
TORSO = {"with_sr": True, "torso_head_aware": True, "torso_individual_embedding_dim": 8,
         "individual_embedding_num": 16, "grid_size": 16}


def _bench_occupancy(g):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpts")
    a2m_dir, head_dir, torso_dir = str(tmp / "a2m"), str(tmp / "head"), str(tmp / "torso")
    save_config({"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp",
                 "a2m_hidden_channels": 64, "a2m_enc_layers": 2, "a2m_dec_layers": 2,
                 "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}, a2m_dir)
    save_config(HEAD, head_dir)
    save_config(dict(TORSO, head_model_dir=head_dir), torso_dir)
    ds_dict = j_synthetic(num_frames=12, H=2 * H, W=2 * W)
    j_ds = JDataset(ds_dict, split="train", smo_win_size=3, with_sr=True)
    j_inf = JInfer(audio2secc_dir=a2m_dir, head_model_dir=head_dir, torso_model_dir=torso_dir, dataset=j_ds)
    occ, occ2d = _bench_occupancy(16), _occupancy_2d()
    j_inf.occupancy = jnp.asarray(occ)
    j_inf.torso_occupancy_2d = jnp.asarray(occ2d)
    j_inf.head_crop = j_inf._auto_head_crop()
    j_inf.torso_crop = j_fr.auto_torso_crop(j_inf.torso_occupancy_2d, H, W,
                                            thr=j_inf.torso_cfg.density_thresh_torso)
    j_inf.sr_params = _with_noise(j_inf.sr_params)
    j_inf.sr_crop, j_inf.sr_bg = j_inf._auto_sr_crop()

    cfg = TConfig.from_hparams(HEAD)
    tcfg = TTorsoConfig.from_hparams(TORSO)
    t_ds = TDataset(t_synthetic(num_frames=12, H=2 * H, W=2 * W), smo_win_size=3, with_sr=True)
    t_inf = TInfer(cfg, convert_flax_params(_np(j_inf.head_params), TRADNeRF(cfg)), t_ds, occ,
                   device="cpu", torso_cfg=tcfg,
                   torso_params=convert_flax_params(_np(j_inf.torso_params), TTorso(tcfg)),
                   torso_occupancy_2d=occ2d, sr_params=convert_flax_params(_np(j_inf.sr_params), TSR(3, 256)))
    return j_inf, t_inf


def test_full_frame_infer_load_matches_jax(pair):
    j_inf, t_inf = pair
    assert dataclasses.asdict(t_inf.torso_cfg) == dataclasses.asdict(j_inf.torso_cfg)
    assert t_inf.sr_model.block0.dtype == torch.bfloat16
    assert (t_inf.head_crop, t_inf.torso_crop, t_inf.sr_crop) == (j_inf.head_crop, j_inf.torso_crop,
                                                                  j_inf.sr_crop)
    # at 32^2 the SR margins (16 px) cover the frame: only the torso crops
    assert t_inf.torso_crop is not None and t_inf.sr_crop is None and t_inf.sr_bg is None


def test_full_frame_gt_driven_frames_match_jax(pair):
    j_inf, t_inf = pair
    batch = t_inf.prepare_gt_batch([0, 3, 4, 5, 9, 2])
    inp = {"frames_per_dispatch": 4}  # 6 frames: one full chunk and a ragged one
    ref = list(serving._render_frames(j_inf, batch, inp))
    got = list(t_inf.forward_secc2video(batch, inp))
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        assert a.shape == (2 * H, 2 * W, 3) and a.dtype == np.uint8
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        psnr = math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)
        assert psnr >= MIN_PSNR, psnr
        assert np.abs(d).mean() <= MAX_MEAN_ABS
    assert not np.array_equal(got[0], got[1])


def test_full_frame_infer_needs_a_card_unless_asked_for_cpu(monkeypatch, pair):
    _, t_inf = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TInfer(t_inf.head_cfg, t_inf.head_model.state_dict(), t_inf.dataset, _bench_occupancy(16),
               torso_cfg=t_inf.torso_cfg, torso_params=t_inf.torso_model.state_dict(),
               sr_params=t_inf.sr_model.state_dict())
