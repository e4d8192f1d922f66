"""Audio-driven serving of the port vs the JAX package, on the CPU: the
3DMM helper (the stand-in basis bit for bit, every reconstruction), the
BFM rotation, the LLE projection (the low-rank case and tied distances),
the landmark helpers, the calibrated landmark projection and the audio
front end (numpy copies: equal), `prepare_batch_from_inp` for each pose
schedule, `forward_audio2secc` for motion_type "exp" and "idexp_lm3d", and
the whole slice, features -> frames, against JAX's GeneFaceInfer at small
widths, both fed JAX's own a2m noise.

Tolerances:
- float32 tensor functions and the condition `cond` (after normalisation
  by the dataset's stored std; the synthetic identity's std has a 1e-3
  floor, so no dimension amplifies float32 noise): atol 1e-4, measured
  8.5e-6;
- `lm68` and the BFM-camera projections: 1e-3 of max(1, |value|),
  measured 4.7e-4. The stand-in basis puts landmarks near depth 0 of the
  BFM camera, where the perspective division turns float32 differences of
  the canonical landmarks into values up to ~3.6e4; landmarks of
  magnitude <= 2 hold 1e-4 (measured 2e-6);
- frames: the bar of tests/test_torch_pipeline.py, PSNR >= 42 dB and mean
  |d| <= 1.5 levels of 255 per uint8 frame (the fused field's bf16 against
  the flax field's float32)."""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from genefaceplusplus_tpu.config import save_config
from genefaceplusplus_tpu.data import audio as j_audio
from genefaceplusplus_tpu.data import landmarks as j_lm
from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic
from genefaceplusplus_tpu.data.face3d import Face3DHelper as JFace3D
from genefaceplusplus_tpu.inference import serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.inference.pipeline import default_inp as j_default_inp
from genefaceplusplus_tpu.models.audio2motion.vae_model import PitchContourVAEModel as JA2M
from genefaceplusplus_tpu.models.postnet import lle as j_lle
from genefaceplusplus_tpu.utils import lm_projection as j_proj
from genefaceplusplus_tpu.utils.rotation import compute_bfm_rotation as j_bfm_rotation
from genefaceplusplus_tpu_torch.data import audio as t_audio
from genefaceplusplus_tpu_torch.data import landmarks as t_lm
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import synthetic as t_synthetic
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper as TFace3D
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
from genefaceplusplus_tpu_torch.models.postnet import lle as t_lle
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.utils import lm_projection as t_proj
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params
from genefaceplusplus_tpu_torch.utils.rotation import compute_bfm_rotation

H = W = 32
HEAD = {"with_sr": False, "grid_size": 16, "smo_win_size": 5, "cond_win_size": 1,
        "individual_embedding_num": 16, "add_eye_blink_cond": True}
A2M = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32,
       "a2m_enc_layers": 2, "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
ATOL = 1e-4
LM_REL = 1e-3
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# JAX's functions as single compiled programs (eager jnp compiles each
# primitive on its own)
j_knn = jax.jit(j_lle.find_k_nearest_neighbors, static_argnames="K")
j_lle_proj = jax.jit(j_lle.compute_lle_projection, static_argnames="K")


def _close_rel(got, ref, rel=LM_REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= rel, err.max()
    small = np.abs(ref) <= 2.0
    assert np.abs(got - ref)[small].max() <= ATOL


# ---------------------------------------------------------------- face3d, rotation


@pytest.mark.parametrize("mode", ["mediapipe", "lm68"])
def test_face3d_synthetic_basis_is_jax_bit_for_bit(mode):
    j, t = JFace3D.synthetic(mode), TFace3D.synthetic(mode)
    for name in ("key_mean_shape", "key_id_base", "key_exp_base", "persc_proj"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    assert t.n_keypoints == j.n_keypoints
    assert TFace3D.load("no/such/dir", mode).n_keypoints == JFace3D.load("no/such/dir", mode).n_keypoints


def _coeffs(T=6, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, 80).astype(np.float32) * 0.5, rs.randn(T, 64).astype(np.float32) * 0.5,
            rs.randn(T, 3).astype(np.float32) * 0.2, rs.randn(T, 3).astype(np.float32) * 0.1)


def test_face3d_reconstructions_match_jax():
    j, t = JFace3D.synthetic("mediapipe"), TFace3D.synthetic("mediapipe")
    idc, exp, eul, tr = _coeffs()
    J = [jnp.asarray(a) for a in (idc, exp, eul, tr)]
    T_ = [_t(a) for a in (idc, exp, eul, tr)]
    np.testing.assert_allclose(t.reconstruct_idexp_lm3d(*T_[:2]).numpy(),
                               np.asarray(j.reconstruct_idexp_lm3d(*J[:2])), atol=ATOL)
    for cam in (True, False):
        np.testing.assert_allclose(t.reconstruct_key_lm3d(*T_, to_camera=cam).numpy(),
                                   np.asarray(j.reconstruct_key_lm3d(*J, to_camera=cam)), atol=ATOL)
    # the camera-space projection (depth ~10): 1e-4
    np.testing.assert_allclose(t.reconstruct_lm2d(*T_).numpy(), np.asarray(j.reconstruct_lm2d(*J)), atol=ATOL)
    btc = [a.reshape(2, 3, -1) for a in T_]
    np.testing.assert_allclose(t.reconstruct_lm2d(*btc).numpy(),
                               np.asarray(j.reconstruct_lm2d(*[a.reshape(2, 3, -1) for a in J])), atol=ATOL)
    # the NeRF convention keeps canonical depths (near 0 on the stand-in basis)
    _close_rel(t.reconstruct_lm2d_nerf(*T_).numpy(), j.reconstruct_lm2d_nerf(*J))
    cano = np.random.RandomState(1).randn(6, 68, 3).astype(np.float32) * 0.3 + [0, 0, 2.0]
    _close_rel(t.project_lm3d_nerf(_t(cano), *T_[2:]).numpy(), j.project_lm3d_nerf(jnp.asarray(cano), *J[2:]))


def test_compute_bfm_rotation_matches_jax():
    eul = np.random.RandomState(2).uniform(-1.5, 1.5, (20, 3)).astype(np.float32)
    got = compute_bfm_rotation(_t(eul)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bfm_rotation(jnp.asarray(eul))), atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


# ---------------------------------------------------------------- LLE


def test_lle_projection_matches_jax():
    rs = np.random.RandomState(1)
    feats, db = rs.randn(20, 16).astype(np.float32), rs.randn(200, 16).astype(np.float32)
    np.testing.assert_array_equal(t_lle.find_k_nearest_neighbors(_t(feats), _t(db), K=10).numpy(),
                                  np.asarray(j_knn(jnp.asarray(feats), jnp.asarray(db), K=10)))
    for got, ref in zip(t_lle.compute_lle_projection(_t(feats), _t(db), K=10),
                        j_lle_proj(jnp.asarray(feats), jnp.asarray(db), K=10)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    fuse, err, w = t_lle.solve_lle_projection_batch(_t(feats[:3]), _t(db[None, :1].repeat(3, 0)))
    assert w.shape == (3, 1) and float(w.sum()) == 3.0 and float(err.abs().max()) == 0.0  # K = 1


def test_lle_low_rank_manifold_is_finite_and_matches_jax():
    """tests/test_audio2motion.py:162's case: K - 1 neighbours spanning a
    3-dim affine manifold in 204-d (singular without the ridge)."""
    rs = np.random.RandomState(2)
    basis = rs.randn(3, 204).astype(np.float32)
    db = (rs.randn(300, 3).astype(np.float32) @ basis + rs.randn(204).astype(np.float32)).astype(np.float32)
    q = db[:5] + 0.01 * rs.randn(5, 204).astype(np.float32)
    fuse, _, w = t_lle.compute_lle_projection(_t(q), _t(db), K=10)
    j_fuse, _, j_w = j_lle_proj(jnp.asarray(q), jnp.asarray(db), K=10)
    assert torch.isfinite(fuse).all() and torch.isfinite(w).all()
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-3)
    assert float((fuse - _t(q)).abs().mean()) < 0.05
    np.testing.assert_allclose(fuse.numpy(), np.asarray(j_fuse), atol=ATOL)
    same = _t(np.tile(db[0][None, None], (1, 10, 1)))  # identical neighbours: the absolute floor
    f2, _, w2 = t_lle.solve_lle_projection_batch(_t(db[:1]), same)
    assert torch.isfinite(f2).all() and torch.isfinite(w2).all()


def test_lle_tied_distances_order_like_jax_top_k():
    """A database with repeated rows: the tied neighbours come in index
    order, as jax.lax.top_k gives them, and the first is the solve's base."""
    rs = np.random.RandomState(3)
    rows = rs.randn(6, 8).astype(np.float32)
    db = np.concatenate([rows, rows, rows[:3]], 0)  # rows 0..5 repeated at 6..11 and 0..2 at 12..14
    feats = np.concatenate([rows[[1, 4]] + 0.01 * rs.randn(2, 8).astype(np.float32), rows[[2]]], 0)
    got = t_lle.find_k_nearest_neighbors(_t(feats), _t(db), K=5).numpy()
    ref = np.asarray(j_knn(jnp.asarray(feats), jnp.asarray(db), K=5))
    np.testing.assert_array_equal(got, ref)
    assert list(got[0][:2]) == [1, 7] and list(got[2][:3]) == [2, 8, 14]
    for a, b in zip(t_lle.compute_lle_projection(_t(feats), _t(db), K=5),
                    j_lle_proj(jnp.asarray(feats), jnp.asarray(db), K=5)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# ---------------------------------------------------------------- numpy copies


def test_landmark_helpers_equal_jax():
    assert t_lm.INDEX_LM68_FROM_LM478 == j_lm.INDEX_LM68_FROM_LM478
    rs = np.random.RandomState(4)
    lm = rs.randn(130, 68, 3).astype(np.float32)
    np.testing.assert_array_equal(t_lm.polygon_area(lm[..., 0], lm[..., 1]), j_lm.polygon_area(lm[..., 0], lm[..., 1]))
    np.testing.assert_array_equal(t_lm.get_eye_area_percent(lm), j_lm.get_eye_area_percent(lm))
    for a, b in zip(t_lm.inject_blink_to_lm68(lm, 0.55, 0.2), j_lm.inject_blink_to_lm68(lm, 0.55, 0.2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_lm.recompose_lm68_regions(lm), j_lm.recompose_lm68_regions(lm))


def test_lm_projection_equals_jax():
    ds = t_synthetic(num_frames=12, H=H, W=W)
    tds = TDataset(ds, smo_win_size=5)
    key_mean = TFace3D.synthetic("mediapipe").key_mean_shape.numpy()[t_lm.INDEX_LM68_FROM_LM478]
    cano = np.asarray(ds["idexp_lm3d"], np.float32).reshape(-1, 68, 3)[tds.frame_ids] / 10.0 + key_mean[None]
    lms = np.stack([s["lms"] for s in tds.samples])
    (L, b), r = t_proj.calibrate_cano_to_world(cano, tds.poses, tds.intrinsics, lms, H, W)
    (jL, jb), jr = j_proj.calibrate_cano_to_world(cano, tds.poses, tds.intrinsics, lms, H, W)
    np.testing.assert_array_equal(L, jL)
    np.testing.assert_array_equal(b, jb)
    assert r == jr
    np.testing.assert_array_equal(t_proj.project_cano_lm3d((L, b), cano, tds.poses, tds.intrinsics, H, W),
                                  j_proj.project_cano_lm3d((L, b), cano, tds.poses, tds.intrinsics, H, W))


def _voiced_wav(seconds=1.0, sr=16000, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    f = 140.0 + 60.0 * t / seconds  # a gliding pitch
    phase = 2 * np.pi * np.cumsum(f) / sr
    wav = sum(np.sin(k * phase) / k for k in (1, 2, 3)) * 0.3
    return (wav + 0.003 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


def test_audio_front_end_equals_jax(tmp_path):
    wav = _voiced_wav()
    np.testing.assert_array_equal(t_audio.mel_filterbank(), j_audio.mel_filterbank())
    np.testing.assert_array_equal(t_audio.stft_mag(wav), j_audio.stft_mag(wav))
    for a, b in zip(t_audio.extract_mel(wav), j_audio.extract_mel(wav)):
        np.testing.assert_array_equal(a, b)
    f0 = t_audio.extract_f0(wav, mel_len=50)
    np.testing.assert_array_equal(f0, j_audio.extract_f0(wav, mel_len=50))
    assert (f0[5:45] > 0).mean() > 0.8 and 140 < np.median(f0[5:45]) < 200  # voiced, on the glide
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 22050, (wav[:8000] * 32767).astype(np.int16))
    np.testing.assert_array_equal(t_audio.load_wav_16k(path), j_audio.load_wav_16k(path))
    assert (t_audio.SAMPLE_RATE, t_audio.HOP_SIZE) == (j_audio.SAMPLE_RATE, j_audio.HOP_SIZE)


# ---------------------------------------------------------------- the pipeline


def _bench_occupancy(g):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


class _JInfer(JInfer):
    """JAX's GeneFaceInfer with each flax init compiled as one program
    (the same values; eager init compiles every primitive on its own)."""

    def _init_a2m(self):
        return jax.jit(super()._init_a2m)()

    def _init_head(self):
        return jax.jit(super()._init_head)()


def _seeded_a2m(variables, seed):
    """a2m variables with seeded non-zero `post` convs and BatchNorm
    statistics (their init is the identity flow, 0 and 1)."""
    rs = np.random.RandomState(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: (rs.randn(*x.shape) * 0.1).astype(np.float32)
        if any(getattr(k, "key", None) == "post" for k in p) else np.asarray(x), variables)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rs.randn(*x.shape) * 0.1 if p[-1].key == "mean" else rs.uniform(0.5, 1.5, x.shape)
                      ).astype(np.float32), v["batch_stats"])
    return v


def _with_a2m(j_inf, t_inf, hp, seed):
    """Copies of both infers whose a2m is a seeded model of config `hp`."""
    j_inf, t_inf = copy.copy(j_inf), copy.copy(t_inf)
    in_out = {"idexp_lm3d": 204}.get(hp["motion_type"], 64)
    jm = JA2M(in_out_dim=in_out, audio_in_dim=hp["audio_in_dim"], hidden_channels=hp["a2m_hidden_channels"],
              enc_n_layers=hp["a2m_enc_layers"], dec_n_layers=hp["a2m_dec_layers"],
              flow_hidden=hp["a2m_flow_hidden"], flow_n_blocks=hp["a2m_flow_blocks"])
    j_inf.a2m_model, j_inf._a2m_jit = jm, {}
    batch = {"audio": jnp.zeros((1, 16, hp["audio_in_dim"])), "f0": jnp.zeros((1, 16)),
             "y_mask": jnp.ones((1, 8)), "y": jnp.zeros((1, 8, in_out))}
    init = jax.jit(lambda: jm.init(jax.random.PRNGKey(seed), batch, train=True, rng=jax.random.PRNGKey(1)))
    j_inf.a2m_params = _seeded_a2m(init(), seed + 100)
    t_inf.a2m_cfg = dict(hp)
    t_inf.a2m_model = a2m_model_from_hparams(hp)
    t_inf.a2m_model.load_state_dict(convert_flax_params(j_inf.a2m_params, t_inf.a2m_model))
    t_inf.a2m_model.eval()
    return j_inf, t_inf


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpts")
    a2m_dir, head_dir = str(tmp / "a2m"), str(tmp / "head")
    save_config(A2M, a2m_dir)
    save_config(HEAD, head_dir)
    j_ds = JDataset(j_synthetic(num_frames=12, H=H, W=W), split="train", smo_win_size=5, with_sr=False)
    j_inf = _JInfer(audio2secc_dir=a2m_dir, head_model_dir=head_dir, dataset=j_ds)
    occ = _bench_occupancy(16)
    j_inf.occupancy = jnp.asarray(occ)
    j_inf.head_crop = j_inf._auto_head_crop()
    cfg = TConfig.from_hparams(HEAD)
    params = convert_flax_params(jax.tree.map(np.asarray, j_inf.head_params), RADNeRF(cfg))
    j_a2m = _seeded_a2m(jax.tree.map(np.asarray, j_inf.a2m_params), 7)
    j_inf.a2m_params = j_a2m
    t_a2m = convert_flax_params(j_a2m, a2m_model_from_hparams(A2M))
    t_ds = TDataset(t_synthetic(num_frames=12, H=H, W=W), smo_win_size=5)
    t_inf = TInfer(cfg, params, t_ds, occ, device="cpu", a2m_hparams=A2M, a2m_params=t_a2m)
    return j_inf, t_inf


def _features(tmp_path, T50=40, seed=0, dim=64):
    rs = np.random.RandomState(seed)
    feats = {"hubert": rs.randn(T50, dim).astype(np.float32),
             "f0": t_audio.extract_f0(_voiced_wav(T50 * 320 / 16000, seed=seed), mel_len=T50)}
    path = str(tmp_path / f"feats{seed}.npy")
    np.save(path, feats, allow_pickle=True)
    return path


def _drive(j_inf, t_inf, inp):
    """Both packages' audio2secc on one request, the port fed JAX's draw."""
    jb, tb = j_inf.prepare_batch_from_inp(inp), t_inf.prepare_batch_from_inp(inp)
    _, sub = jax.random.split(j_inf.rng)  # the key JAX's forward_audio2secc draws z_p from
    noise = np.asarray(jax.random.normal(sub, (1, t_inf.a2m_model.vae.latent_length(tb["T"]), 16)))
    return j_inf.forward_audio2secc(jb, inp), t_inf.forward_audio2secc(tb, inp, noise=noise)


def test_default_inp_is_jax():
    assert default_inp(temperature=0.5) == j_default_inp(temperature=0.5)


@pytest.mark.parametrize("drv_pose", ["nearest", "static", "3", "2-6"])
def test_prepare_batch_matches_jax(pair, tmp_path, drv_pose):
    j_inf, t_inf = pair
    inp = default_inp(drv_aud_features=_features(tmp_path, T50=45), drv_pose=drv_pose)
    jb, tb = j_inf.prepare_batch_from_inp(inp), t_inf.prepare_batch_from_inp(inp)
    assert tb["T"] == jb["T"] == 20  # 45 frames at 50 Hz trimmed to 40
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("motion_type", ["exp", "idexp_lm3d"])
def test_forward_audio2secc_matches_jax(pair, tmp_path, motion_type):
    j_inf, t_inf = pair
    if motion_type != "exp":
        j_inf, t_inf = _with_a2m(j_inf, t_inf, dict(A2M, motion_type=motion_type), seed=3)
    inp = default_inp(drv_aud_features=_features(tmp_path, seed=1))
    jb, tb = _drive(j_inf, t_inf, inp)
    T = tb["T"]
    assert tb["cond"].shape == (T, 1, 204) and tb["lm68"].shape == (T, 68, 2)
    if motion_type == "exp":
        np.testing.assert_array_equal(tb["exp"], tb["a2m_out"])
    else:  # direct drive: no 3DMM coefficients
        assert tb["a2m_out"].shape == (T, 204) and not tb["exp"].any() and not tb["id_coeff"].any()
    np.testing.assert_allclose(tb["cond"], np.asarray(jb["cond"]), atol=ATOL)
    _close_rel(tb["lm68"], jb["lm68"])
    np.testing.assert_array_equal(tb["eye_area_percent"], jb["eye_area_percent"])
    np.testing.assert_allclose(tb["exp"], jb["exp"], atol=ATOL)
    np.testing.assert_array_equal(tb["id_coeff"], jb["id_coeff"])
    assert np.ptp(tb["eye_area_percent"]) == 0.0 or tb["eye_area_percent"].min() < t_inf.opened_eye_area_percent


def test_deterministic_mode_and_own_draws(pair, tmp_path):
    """Temperature 0 draws nothing and matches JAX; otherwise the draw comes
    from the instance's seeded generator and is returned with the batch."""
    j_inf, t_inf = pair
    inp = default_inp(drv_aud_features=_features(tmp_path, seed=2), temperature=0.0, blink_mode="none",
                      lle_percent=0.0)
    jb = j_inf.forward_audio2secc(j_inf.prepare_batch_from_inp(inp), inp)
    tb = t_inf.forward_audio2secc(t_inf.prepare_batch_from_inp(inp), inp)
    assert tb["a2m_noise"] is None
    np.testing.assert_allclose(tb["cond"], np.asarray(jb["cond"]), atol=ATOL)
    np.testing.assert_array_equal(tb["eye_area_percent"], np.full_like(tb["eye_area_percent"],
                                                                       t_inf.opened_eye_area_percent))
    inp = default_inp(drv_aud_features=_features(tmp_path, seed=2))
    t2 = copy.copy(t_inf)
    t2.generator = torch.Generator().manual_seed(5)
    a = t2.forward_audio2secc(t2.prepare_batch_from_inp(inp), inp)
    b = t_inf.forward_audio2secc(t_inf.prepare_batch_from_inp(inp), inp, noise=a["a2m_noise"])
    assert a["a2m_noise"].shape == (1, 5, 16)
    np.testing.assert_array_equal(a["cond"], b["cond"])


def test_audio_driven_frames_match_jax(pair, tmp_path):
    """features -> frames: prepare_batch_from_inp, forward_audio2secc and
    forward_secc2video against JAX's prepare_batch_from_inp,
    forward_audio2secc and serving._render_frames."""
    j_inf, t_inf = pair
    inp = default_inp(drv_aud_features=_features(tmp_path, T50=24, seed=3), frames_per_dispatch=4)
    jb, tb = _drive(j_inf, t_inf, inp)
    ref = list(serving._render_frames(j_inf, jb, inp))
    got = list(t_inf.forward_secc2video(tb, inp))
    assert len(got) == len(ref) == 12
    for a, b in zip(got, ref):
        assert a.shape == (H, W, 3) and a.dtype == np.uint8
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        psnr = math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)
        assert psnr >= MIN_PSNR, psnr
        assert np.abs(d).mean() <= MAX_MEAN_ABS
    assert any(not np.array_equal(got[0], f) for f in got[1:])


def test_what_the_port_cannot_do_raises(pair, tmp_path):
    j_inf, t_inf = pair
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 16000, (_voiced_wav(0.5) * 32767).astype(np.int16))
    with pytest.raises(RuntimeError, match="drv_aud_features"):
        t_inf.prepare_batch_from_inp(default_inp(drv_aud=path))
    bare = copy.copy(t_inf)
    bare.a2m_model = None
    inp = default_inp(drv_aud_features=_features(tmp_path))
    with pytest.raises(ValueError, match="a2m_params"):
        bare.forward_audio2secc(bare.prepare_batch_from_inp(inp), inp)
    broken = copy.copy(t_inf)
    broken.a2m_model = copy.deepcopy(t_inf.a2m_model)
    with torch.no_grad():
        broken.a2m_model.vae.decoder.convs[0].bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite driven condition"):
        broken.forward_audio2secc(broken.prepare_batch_from_inp(inp), inp)
