"""JAX work dirs in, video out: the port's `GeneFaceInfer.from_work_dirs`,
`infer_once` and CLI against the JAX package's `GeneFaceInfer`, on the CPU.

The work dirs are written by the JAX package's own `save_checkpoint` and
`save_config`, with `Trainer.save`'s payload ({'state_dict': TrainState
dict, 'extra_state': the task's grids}); the head dir that drives frames
comes from a real JAX `Trainer.fit` of 3 steps. Widths are small (grid
16, a 32^2 identity, a 2-layer a2m), the fused field's at flagship width.

Tolerances:
- loading: exact (configs, state dicts against the bridged JAX params,
  occupancy, torso grid, crops, eye-area quantiles);
- the AVI read back: its frames equal the port's forward_secc2video frames
  for the same draw, and its PCM equals `pcm16` of the request's wav16k,
  exactly;
- frames against JAX's for the same draw: PSNR >= 42 dB and mean |d| <=
  1.5 levels of 255 (tests/test_torch_pipeline.py's bar: the fused field's
  bf16 against the flax field's float32)."""

import dataclasses
import functools
import math
import os
import struct

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genefaceplusplus_tpu.config import save_config
from genefaceplusplus_tpu.data import audio as j_audio
from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic
from genefaceplusplus_tpu.inference import serving as j_serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.models.audio2motion.vae_model import PitchContourVAEModel as JA2M
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoConfig as JTorsoConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoField as JTorso
from genefaceplusplus_tpu.models.superresolution import Superresolution as JSR
from genefaceplusplus_tpu.training.radnerf_task import TaskHParams
from genefaceplusplus_tpu.training.tasks.head_task import HeadNeRFTask as JHeadTask
from genefaceplusplus_tpu.training.tasks.head_task import HeadTaskConfig as JHeadTaskConfig
from genefaceplusplus_tpu.training.trainer import Trainer as JTrainer
from genefaceplusplus_tpu.utils.ckpt import save_checkpoint
from genefaceplusplus_tpu_torch.data import audio as t_audio
from genefaceplusplus_tpu_torch.data import video as t_video
from genefaceplusplus_tpu_torch.inference import cli
from genefaceplusplus_tpu_torch.inference import pipeline as t_pipeline
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField as TTorso
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution as TSR
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

H = W = 32
A2M = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32,
       "a2m_enc_layers": 2, "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
HEAD = {"with_sr": False, "grid_size": 16, "smo_win_size": 5, "cond_win_size": 1,
        "individual_embedding_num": 16, "add_eye_blink_cond": True, "video_id": "head32"}
HEAD_SR = {"with_sr": True, "sr_dtype": "bfloat16", "grid_size": 16, "smo_win_size": 3, "cond_win_size": 1,
           "individual_embedding_num": 16, "add_eye_blink_cond": True, "video_id": "sr64",
           "head_crop_pad_px": 4}
TORSO = {"with_sr": True, "torso_head_aware": True, "torso_individual_embedding_dim": 8,
         "individual_embedding_num": 16, "grid_size": 16}
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bench_occupancy(g):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


def _occupancy_2d(g=16):
    occ2d = np.zeros((g, g), np.float32)
    occ2d[11 * g // 16:15 * g // 16, 6 * g // 16:10 * g // 16] = 1.0
    return occ2d


def _seeded(variables, seed, keys=("post",)):
    """Variables with the leaves under `keys` and the BatchNorm statistics
    drawn non-trivial (their init is 0 / the identity)."""
    rs = np.random.RandomState(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(rs.randn(*x.shape) * 0.1, np.float32)
        if any(getattr(k, "key", None) in keys for k in p) else np.asarray(x), variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: np.asarray(rs.randn(*x.shape) * 0.1 if p[-1].key == "mean"
                                    else rs.uniform(0.5, 1.5, x.shape), np.float32), v["batch_stats"])
    return v


def _adam(params):
    return flax.serialization.to_state_dict(optax.adam(1e-3).init(params))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU renders (many small ops), so
    the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JInfer(JInfer):
    """JAX's GeneFaceInfer with each flax init compiled as one program (the
    same values; eager init compiles every primitive on its own)."""

    def _init_a2m(self):
        return jax.jit(super()._init_a2m)()

    def _init_head(self):
        return jax.jit(super()._init_head)()

    def _init_torso(self):
        return jax.jit(super()._init_torso)()

    def _init_sr(self):
        return jax.jit(super()._init_sr)()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """JAX work dirs: a2m; head + SR and torso (hand-written Trainer.save
    payloads); a head trained by JAX's Trainer.fit for 3 steps."""
    tmp = tmp_path_factory.mktemp("work")
    binary = str(tmp / "binary")
    for vid, size in (("head32", H), ("sr64", 2 * H)):
        os.makedirs(os.path.join(binary, vid))
        np.save(os.path.join(binary, vid, "trainval_dataset.npy"), j_synthetic(num_frames=12, H=size, W=size),
                allow_pickle=True)
    d = {k: str(tmp / k) for k in ("a2m", "head_sr", "torso", "trained", "a2m_config_only", "bad")}

    jm = JA2M(in_out_dim=64, audio_in_dim=64, hidden_channels=32, enc_n_layers=2, dec_n_layers=2,
              flow_hidden=16, flow_n_blocks=2)
    batch = {"audio": jnp.zeros((1, 16, 64)), "f0": jnp.zeros((1, 16)), "y_mask": jnp.ones((1, 8)),
             "y": jnp.zeros((1, 8, 64))}
    av = _seeded(_np(jax.jit(lambda: jm.init(jax.random.PRNGKey(5), batch, train=True,
                                             rng=jax.random.PRNGKey(1)))()), 7)
    save_checkpoint(d["a2m"], 40, {"state_dict": {"step": 40, "variables": av, "opt_state": _adam(av["params"])},
                                   "extra_state": {}}, config=A2M)
    save_config(A2M, d["a2m_config_only"])

    cfg = JConfig.from_hparams(HEAD_SR)
    hv = _np(jax.jit(lambda: JRADNeRF(cfg).init(jax.random.PRNGKey(11), jnp.zeros((8, 3)), jnp.ones((8, 3)),
                                                  jnp.zeros((3, 1, 204))))())
    sv = _seeded(_np(jax.jit(lambda: JSR(channels=3, input_resolution=256).init(
        jax.random.PRNGKey(12), jnp.zeros((1, 16, 16, 3))))()), 3, keys=("noise_strength",))
    params = {"head": hv, "sr": sv}
    save_checkpoint(d["head_sr"], 7, {
        "state_dict": {"step": 7, "params": params, "opt_state": _adam(params)},
        "extra_state": {"occupancy": _bench_occupancy(16), "density_grid": np.ones((16,) * 3, np.float32)}},
        config=dict(HEAD_SR, binary_data_dir=binary))
    tcfg = JTorsoConfig.from_hparams(TORSO)
    tv = _np(jax.jit(lambda: JTorso(tcfg).init(jax.random.PRNGKey(13), jnp.zeros((8, 2)), jnp.zeros((1, 68, 2)),
                                               jnp.zeros(8), jnp.zeros((8, 3)), jnp.zeros((8, 1))))())
    save_checkpoint(d["torso"], 9, {
        "state_dict": {"step": 9, "torso_params": tv, "opt_state": _adam(tv)},
        "extra_state": {"torso_grid": _occupancy_2d(), "occupancy": _bench_occupancy(16),
                        "density_grid": np.ones((16,) * 3, np.float32)}},
        config=dict(TORSO, head_model_dir=d["head_sr"]))

    bogus = {"params": {"not_a_module": {"kernel": np.ones((3, 3), np.float32)}}}
    save_checkpoint(d["bad"], 1, {"state_dict": {"step": 1, "params": bogus, "opt_state": {}}, "extra_state": {}},
                    config=dict(HEAD, binary_data_dir=binary))

    ds = JDataset(os.path.join(binary, "head32", "trainval_dataset.npy"), split="train", smo_win_size=5)
    task = JHeadTask(ds, JConfig.from_hparams(HEAD), JHeadTaskConfig(n_rays=64, num_coarse=8, num_samples=4, lr=1e-2,
                                                                      update_extra_interval=2), TaskHParams())
    JTrainer(task, d["trained"], config=dict(HEAD, binary_data_dir=binary), max_updates=3, val_check_interval=3,
             tb_log_interval=10, update_extra_interval=2, num_sanity_val_steps=0).fit(resume=False)
    return d


def _state_equal(model, ref):
    a = model.state_dict()
    assert set(a) == set(ref)
    for k in a:
        assert a[k].dtype == ref[k].dtype and torch.equal(a[k], ref[k]), k


@pytest.fixture(scope="module")
def full(dirs):
    j_inf = _JInfer(audio2secc_dir=dirs["a2m"], head_model_dir=dirs["head_sr"], torso_model_dir=dirs["torso"])
    t_inf = TInfer.from_work_dirs(audio2secc_dir=dirs["a2m"], head_model_dir=dirs["head_sr"],
                                  torso_model_dir=dirs["torso"], device="cpu")
    return j_inf, t_inf


def test_from_work_dirs_matches_jax(full):
    j_inf, t_inf = full
    assert t_inf.head_cfg_raw.to_dict() == j_inf.head_cfg_raw.to_dict()
    assert t_inf.a2m_cfg == j_inf.a2m_cfg.to_dict()
    assert dataclasses.asdict(t_inf.head_cfg) == dataclasses.asdict(j_inf.head_cfg)
    assert dataclasses.asdict(t_inf.torso_cfg) == dataclasses.asdict(j_inf.torso_cfg)
    _state_equal(t_inf.head_model, convert_flax_params(_np(j_inf.head_params), TRADNeRF(t_inf.head_cfg)))
    _state_equal(t_inf.torso_model, convert_flax_params(_np(j_inf.torso_params), TTorso(t_inf.torso_cfg)))
    _state_equal(t_inf.sr_model, convert_flax_params(_np(j_inf.sr_params), TSR(3, 256)))
    _state_equal(t_inf.a2m_model, convert_flax_params(_np(j_inf.a2m_params), a2m_model_from_hparams(A2M)))
    assert t_inf.sr_model.block0.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_inf.occupancy.numpy(), np.asarray(j_inf.occupancy))
    np.testing.assert_array_equal(t_inf.torso_occupancy_2d.numpy(), np.asarray(j_inf.torso_occupancy_2d))
    assert (t_inf.head_crop, t_inf.torso_crop, t_inf.sr_crop) == (j_inf.head_crop, j_inf.torso_crop, j_inf.sr_crop)
    assert t_inf.torso_crop is not None
    assert (t_inf.opened_eye_area_percent, t_inf.closed_eye_area_percent) == \
        (j_inf.opened_eye_area_percent, j_inf.closed_eye_area_percent)
    assert (t_inf.dataset.H, t_inf.dataset.W) == (j_inf.dataset.H, j_inf.dataset.W) == (H, W)


def test_the_torso_dir_alone_resolves_the_head_dir(dirs, full):
    _, t_inf = full
    alone = TInfer.from_work_dirs(torso_model_dir=dirs["torso"], device="cpu")
    assert alone.a2m_model is None
    for a, b in ((alone.head_model, t_inf.head_model), (alone.sr_model, t_inf.sr_model),
                 (alone.torso_model, t_inf.torso_model)):
        _state_equal(a, b.state_dict())
    assert (alone.head_crop, alone.torso_crop) == (t_inf.head_crop, t_inf.torso_crop)


def test_a_checkpoint_that_matches_nothing_raises(dirs):
    with pytest.raises(ValueError, match="matched no parameters"):
        TInfer.from_work_dirs(head_model_dir=dirs["bad"], device="cpu")
    with pytest.raises(ValueError, match="matched no parameters"):
        JInfer(head_model_dir=dirs["bad"])


def test_a_config_only_dir_keeps_the_seeded_init(dirs, capsys):
    t_inf = TInfer.from_work_dirs(audio2secc_dir=dirs["a2m_config_only"], head_model_dir=dirs["trained"],
                                  device="cpu")
    assert "no checkpoint; the a2m keeps the port's initial weights" in capsys.readouterr().out
    _state_equal(t_inf.a2m_model, a2m_model_from_hparams(A2M, generator=torch.Generator().manual_seed(0)).state_dict())


def test_postnet_dirs_raise(dirs):
    """A postnet dir whose checkpoint restores no tensor of the postnet (an
    a2m's) raises."""
    with pytest.raises(ValueError, match="matched no parameters"):
        TInfer.from_work_dirs(postnet_dir=dirs["a2m"], head_model_dir=dirs["trained"], device="cpu")


# ---------------------------------------------------------------- frames and files


@pytest.fixture(scope="module")
def trained(dirs):
    j_inf = _JInfer(audio2secc_dir=dirs["a2m"], head_model_dir=dirs["trained"])
    t_inf = TInfer.from_work_dirs(audio2secc_dir=dirs["a2m"], head_model_dir=dirs["trained"], device="cpu")
    return j_inf, t_inf


def test_trained_head_dir_loads_like_jax(trained):
    j_inf, t_inf = trained
    _state_equal(t_inf.head_model, convert_flax_params(_np(j_inf.head_params), TRADNeRF(t_inf.head_cfg)))
    np.testing.assert_array_equal(t_inf.occupancy.numpy(), np.asarray(j_inf.occupancy))
    assert t_inf.sr_model is None and t_inf.torso_model is None
    assert t_inf.head_crop == j_inf.head_crop


def read_avi(path):
    """(frames [T, H, W, 3] RGB, int16 PCM) of an uncompressed AVI, from its
    RIFF chunks (independent of the writer)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI " and struct.unpack("<I", data[4:8])[0] == len(data) - 8
    frames, pcm, bmp = [], [], []

    def walk(lo, hi):
        i = lo
        while i < hi:
            ck, n = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])[0]
            body = data[i + 8:i + 8 + n]
            if ck == b"LIST":
                walk(i + 12, i + 8 + n)
            elif ck == b"strf" and n == 40:
                bmp.append(struct.unpack("<IiiHH", body[:16]))
            elif ck == b"00db":
                _, w, h, _, bits = bmp[0]
                assert bits == 24 and h > 0  # bottom-up BGR
                stride = (w * 3 + 3) // 4 * 4
                frames.append(np.frombuffer(body, np.uint8).reshape(h, stride)[::-1, :w * 3]
                              .reshape(h, w, 3)[:, :, ::-1])
            elif ck == b"01wb":
                pcm.append(np.frombuffer(body, "<i2"))
            i += 8 + n + (n & 1)

    walk(12, len(data))
    return np.stack(frames), (np.concatenate(pcm) if pcm else np.zeros(0, np.int16))


def _features(tmp_path, T50=24, seed=3):
    rs = np.random.RandomState(seed)
    t = np.arange(T50 * 320) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * (140.0 + 60.0 * t) * t) + 0.003 * rs.randn(len(t))).astype(np.float32)
    feats = {"hubert": rs.randn(T50, 64).astype(np.float32), "f0": t_audio.extract_f0(wav, mel_len=T50),
             "wav16k": np.concatenate([wav, wav[:517] * 1.7])}  # past the frames, and past [-1, 1]
    path = str(tmp_path / "feats.npy")
    np.save(path, feats, allow_pickle=True)
    return path, feats


def _psnr_ok(got, ref):
    for a, b in zip(got, ref):
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        assert (math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)) >= MIN_PSNR
        assert np.abs(d).mean() <= MAX_MEAN_ABS


def test_infer_once_and_the_cli_write_the_frames(trained, dirs, tmp_path, monkeypatch):
    """Both write an AVI whose frames are the port's frames for the same
    draw (JAX's), exactly, and >= 42 dB against JAX's; its PCM is
    pcm16(wav16k); `.mp4` becomes `.avi`."""
    j_inf, t_inf = trained
    path, feats = _features(tmp_path)
    inp = default_inp(drv_aud_features=path)
    T = 12
    _, sub = jax.random.split(j_inf.rng)  # JAX's next draw
    draw = np.array(jax.random.normal(sub, (1, t_inf.a2m_model.vae.latent_length(T), 16)))
    jb = j_inf.forward_audio2secc(j_inf.prepare_batch_from_inp(inp), inp)
    ref = list(j_serving._render_frames(j_inf, jb, inp))
    monkeypatch.setattr(TInfer, "forward_audio2secc",
                        functools.partialmethod(TInfer.forward_audio2secc, noise=torch.from_numpy(draw)))
    tb = t_inf.forward_audio2secc(t_inf.prepare_batch_from_inp(inp), inp)
    got = list(t_inf.forward_secc2video(tb, inp))
    assert len(got) == len(ref) == T
    _psnr_ok(got, ref)

    out = t_inf.infer_once(dict(inp, out_name=str(tmp_path / "once.mp4")))
    assert out == str(tmp_path / "once.avi") and not os.path.exists(str(tmp_path / "once.mp4"))
    printed = cli.main(["--device", "cpu", "--a2m_ckpt", dirs["a2m"], "--head_ckpt", dirs["trained"],
                        "--drv_aud_features", path, "--out_name", str(tmp_path / "cli.mp4")])
    assert printed == str(tmp_path / "cli.avi")
    for p in (out, printed):
        frames, pcm = read_avi(p)
        assert frames.shape == (T, H, W, 3) and frames.dtype == np.uint8
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pcm, t_audio.pcm16(feats["wav16k"]))
        assert os.path.getsize(p) == t_video.avi_bytes(T, H, W, len(feats["wav16k"]))


def test_a_clip_past_the_segment_size_renders_and_reads_back(trained, tmp_path, monkeypatch):
    """A clip past the writer's RIFF segment size (here 20 kB, 1 GiB by
    default) is written as AVI 2.0 in several segments: its frames are the
    rendered frames and its PCM pcm16(wav16k), bit for bit."""
    _, t_inf = trained
    path, feats = _features(tmp_path)
    seg = 20_000
    rendered = []
    forward = t_inf.forward_secc2video
    monkeypatch.setattr(t_inf, "forward_secc2video", lambda *a: (rendered.append(f) or f for f in forward(*a)))
    monkeypatch.setattr(t_pipeline, "StreamingVideoWriter",
                        functools.partial(t_video.StreamingVideoWriter, segment_bytes=seg))
    out = t_inf.infer_once(default_inp(drv_aud_features=path, out_name=str(tmp_path / "long.avi")))
    frames, pcm = t_video.read_avi(out)
    assert len(rendered) == len(frames) == 12
    np.testing.assert_array_equal(frames, np.stack(rendered))
    np.testing.assert_array_equal(pcm, t_audio.pcm16(feats["wav16k"]))
    assert os.path.getsize(out) == t_video.avi_bytes(12, H, W, len(feats["wav16k"]), segment_bytes=seg)
    with open(out, "rb") as f:
        assert f.read().count(b"AVIXLIST") >= 2
    assert sorted(os.listdir(tmp_path)) == ["feats.npy", "long.avi"]


@pytest.mark.parametrize("argv,match", [
    (["--debug"], "panels"), (["--color_topk", "4"], "top-k"),
    (["--compact_frac", "auto"], "compaction"), (["--compact_frac", "0.5"], "compaction"),
    (["--n_devices", "2"], "one card"),
])
def test_unported_flags_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["--device", "cpu", "--head_ckpt", "unused"] + argv)


def test_a_bare_wav_raises_and_the_cli_needs_a_card(dirs, tmp_path, monkeypatch):
    wav = str(tmp_path / "a.wav")
    t_audio.save_wav_16k(np.zeros(8000, np.float32), wav)
    with pytest.raises(RuntimeError, match="drv_aud_features"):
        cli.main(["--device", "cpu", "--a2m_ckpt", dirs["a2m"], "--head_ckpt", dirs["trained"], "--drv_aud", wav])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--a2m_ckpt", dirs["a2m"], "--head_ckpt", dirs["trained"], "--drv_aud", wav])


# ---------------------------------------------------------------- the writers


def test_save_wav_16k_matches_jax(tmp_path):
    wav = np.concatenate([np.linspace(-1.5, 1.5, 4001), np.random.RandomState(0).randn(999) * 0.4]).astype(np.float32)
    t_audio.save_wav_16k(wav, str(tmp_path / "t.wav"))
    j_audio.save_wav_16k(wav, str(tmp_path / "j.wav"))
    from scipy.io import wavfile

    (rt, dt), (rj, dj) = wavfile.read(str(tmp_path / "t.wav")), wavfile.read(str(tmp_path / "j.wav"))
    assert rt == rj == 16000 and dt.dtype == dj.dtype == np.int16
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(t_audio.load_wav_16k(str(tmp_path / "t.wav")),
                                  j_audio.load_wav_16k(str(tmp_path / "j.wav")))


@pytest.mark.parametrize("T,h,w,n", [(5, 6, 7, 3000), (4, 8, 8, 0), (3, 5, 5, 1), (6, 16, 16, 640 * 6),
                                     (2, 4, 4, 640 * 5 + 13)])
def test_avi_round_trip(tmp_path, T, h, w, n):
    rs = np.random.RandomState(T)
    frames = rs.randint(0, 256, (T, h, w, 3)).astype(np.uint8)
    wav = (rs.randn(n) * 0.7).astype(np.float32)
    writer = t_video.StreamingVideoWriter(str(tmp_path / "v.avi"), audio=wav)
    for f in frames:
        writer.append(f)
    path = writer.close()
    got, pcm = read_avi(path)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(pcm, t_audio.pcm16(wav))
    assert os.path.getsize(path) == t_video.avi_bytes(T, h, w, n)


def test_avi_names_and_segments(tmp_path):
    assert t_video.avi_path("a/b.mp4") == "a/b.avi" and t_video.avi_path("c.AVI") == "c.avi"
    with pytest.raises(ValueError, match="uncompressed AVI"):
        t_video.avi_path("x.mkv")
    # the first 1 GiB RIFF holds 1,362 frames of 512^2 with their audio (AVI 1.0 readers read it
    # alone); 1,400 frames, chip_smoke.py's long clip, take two RIFFs
    assert t_video.avi_bytes(1362, 512, 512, 1362 * 640) <= t_video.AVI_MAX_BYTES < \
        t_video.avi_bytes(1363, 512, 512, 1363 * 640)
    assert t_video.avi_bytes(1400, 512, 512, 1400 * 640) == 1_102_894_194
    frames = np.random.RandomState(0).randint(0, 256, (16, 16, 16, 3)).astype(np.uint8)
    writer = t_video.StreamingVideoWriter(str(tmp_path / "v.avi"), segment_bytes=6000)
    for f in frames:
        writer.append(f)
    path = writer.close()
    np.testing.assert_array_equal(t_video.read_avi(path)[0], frames)
    with open(path, "rb") as f:
        assert f.read().count(b"AVIXLIST") >= 2
    writer = t_video.StreamingVideoWriter(str(tmp_path / "w.avi"), segment_bytes=4000)
    with pytest.raises(ValueError, match="does not fit"):
        writer.append(frames[0])
    assert os.listdir(tmp_path) == ["v.avi"]
