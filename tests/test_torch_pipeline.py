"""The slice as a whole: the port's GeneFaceInfer (plain bf16 fused field on
the CPU) vs the JAX GeneFaceInfer + serving._render_frames (float32 flax
field) on the same synthetic identity, weights, occupancy and GT batch;
plus the port's import rule, chip_smoke.py's CPU behaviour and its config.

Frame tolerance: the two differ by the field's precision (the fused
field's bf16 products vs the flax field's float32), measured on these six
frames at PSNR 46.9-49.1 dB and mean |d| 0.48-0.77 levels of 255; the
bounds are PSNR >= 42 dB and mean |d| <= 1.5 levels per frame."""

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys

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
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import synthetic as t_synthetic
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, RADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
HEAD = {"with_sr": False, "grid_size": 16, "smo_win_size": 5, "cond_win_size": 1,
        "individual_embedding_num": 16, "add_eye_blink_cond": True}
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5


def _bench_occupancy(g):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpts")
    a2m_dir, head_dir = str(tmp / "a2m"), str(tmp / "head")
    save_config({"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp",
                 "a2m_hidden_channels": 64, "a2m_enc_layers": 2, "a2m_dec_layers": 2,
                 "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}, a2m_dir)
    save_config(HEAD, head_dir)
    j_ds = JDataset(j_synthetic(num_frames=12, H=H, W=W), split="train", smo_win_size=5, with_sr=False)
    j_inf = JInfer(audio2secc_dir=a2m_dir, head_model_dir=head_dir, dataset=j_ds)
    occ = _bench_occupancy(16)
    j_inf.occupancy = jnp.asarray(occ)
    j_inf.head_crop = j_inf._auto_head_crop()

    cfg = TConfig.from_hparams(HEAD)
    model = RADNeRF(cfg)
    params = convert_flax_params(jax.tree.map(np.asarray, j_inf.head_params), model)
    t_ds = TDataset(t_synthetic(num_frames=12, H=H, W=W), smo_win_size=5)
    t_inf = TInfer(cfg, params, t_ds, occ, device="cpu")
    return j_inf, t_inf


def test_config_matches_jax(pair):
    j_inf, t_inf = pair
    assert dataclasses.asdict(t_inf.head_cfg) == dataclasses.asdict(j_inf.head_cfg)


def test_synthetic_dataset_identical_to_jax(pair):
    j_inf, t_inf = pair
    a, b = j_synthetic(num_frames=12, H=H, W=W), t_synthetic(num_frames=12, H=H, W=W)
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith("_samples"):
            for sa, sb in zip(a[k], b[k]):
                for f in sa:
                    np.testing.assert_array_equal(np.asarray(sb[f]), np.asarray(sa[f]))
        else:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    jd, td = j_inf.dataset, t_inf.dataset
    assert td.intrinsics == jd.intrinsics and (td.H, td.W) == (jd.H, jd.W)
    for name in ("poses", "conds_all", "conds", "eye_area_percents", "bg_img",
                 "idexp_lm3d_mean", "idexp_lm3d_std"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name), err_msg=name)
    for i in range(len(td)):
        np.testing.assert_array_equal(td.frame_cond_window(i), jd.frame_cond_window(i))
    assert t_inf.head_crop == j_inf.head_crop


def test_gt_driven_frames_match_jax(pair):
    j_inf, t_inf = pair
    frame_ids = [0, 3, 4, 5, 9, 2]
    batch = t_inf.prepare_gt_batch(frame_ids)
    assert batch["cond"].shape == (6, 1, 204) and batch["lm68"].shape == (6, 68, 2)
    inp = {"frames_per_dispatch": 4}  # 6 frames: one full chunk and a ragged one
    ref = list(serving._render_frames(j_inf, batch, inp))
    got = list(t_inf.forward_secc2video(batch, inp))
    assert len(got) == len(ref) == 6
    bg = (np.clip(t_inf.dataset.bg_img, 0, 1) * 255).astype(np.uint8)
    for a, b in zip(got, ref):
        assert a.shape == (H, W, 3) and a.dtype == np.uint8
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        psnr = math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)
        assert psnr >= MIN_PSNR, psnr
        assert np.abs(d).mean() <= MAX_MEAN_ABS
        assert (np.abs(a.astype(np.int16) - bg) > 8).any()  # the head is in the frame
    assert not np.array_equal(got[0], got[1])


def test_port_imports_no_jax_yaml_or_cv2():
    """Importing every module of the port, and running the inference and
    training CLIs' --help, loads none of jax, flax, yaml, msgpack, cv2, PIL,
    imageio or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import genefaceplusplus_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'msgpack', 'cv2', 'PIL', 'imageio', 'genefaceplusplus_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "new = ['ops.freq_encoder', 'ops.bias_act', 'ops.upfirdn2d', 'models.superresolution',\n"
        "       'models.radnerf_torso', 'models.full_renderer', 'data.dataset', 'inference.pipeline',\n"
        "       'utils.convert_jax', 'utils.pitch', 'utils.lm_projection', 'utils.rotation',\n"
        "       'models.audio2motion.wavenet', 'models.audio2motion.flow', 'models.audio2motion.fvae',\n"
        "       'models.audio2motion.vae_model', 'models.postnet.lle', 'data.face3d', 'data.landmarks',\n"
        "       'data.audio', 'utils.msgpack', 'utils.ckpt', 'config.config', 'config.yaml_io', 'data.video',\n"
        "       'inference.metrics', 'inference.serving', 'inference.cli', 'training.run',\n"
        "       'training.perceptual', 'training.tasks.sr_task', 'training.tasks.torso_task',\n"
        "       'training.trainer', 'training.schedulers', 'data.image_io', 'models.postnet.models',\n"
        "       'training.tasks.a2m_task', 'training.tasks.postnet_task',\n"
        "       'utils.build']\n"
        "assert all('genefaceplusplus_tpu_torch.' + m in sys.modules for m in new)\n"
        "print('modules', sum(k.startswith('genefaceplusplus_tpu_torch') for k in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 49
    code = ("import runpy, sys\n"
            "sys.argv = ['cli', '--help']\n"
            "try:\n"
            "    runpy.run_module('genefaceplusplus_tpu_torch.inference.cli', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = [m for m in ('jax', 'flax', 'yaml', 'msgpack', 'cv2', 'PIL', 'imageio', 'genefaceplusplus_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    for module, flags in (("inference.cli", ("--drv_aud_features", "--device")),
                          ("training.run", ("--config", "--hparams", "--device"))):
        run = code.replace("genefaceplusplus_tpu_torch.inference.cli", "genefaceplusplus_tpu_torch." + module)
        out = subprocess.run([sys.executable, "-c", run], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert all(f in out.stdout for f in flags), out.stdout


@pytest.mark.parametrize("name,yaml_path", [
    ("MAY_LM3D_RADNERF", "egs/datasets/May/lm3d_radnerf.yaml"),
    ("MAY_LM3D_RADNERF_SR", "egs/datasets/May/lm3d_radnerf_sr.yaml"),
    ("MAY_LM3D_RADNERF_TORSO_SR", "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"),
    ("MAY_AUDIO2MOTION_VAE", "egs/datasets/May/audio2motion_vae.yaml"),
])
def test_hard_coded_may_configs_are_the_yaml(monkeypatch, name, yaml_path):
    """Each MAY_* dict agrees, key for key, with the port's own set_hparams
    of its egs/ file."""
    from genefaceplusplus_tpu_torch.config import set_hparams as t_set_hparams
    from genefaceplusplus_tpu_torch.models import radnerf
    from genefaceplusplus_tpu_torch.models.audio2motion import vae_model

    monkeypatch.chdir(REPO)
    d = getattr(radnerf, name, None) or getattr(vae_model, name)
    hp = t_set_hparams(config=yaml_path)
    assert {k: hp[k] for k in d} == d


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_config_is_may_lm3d_radnerf():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ref = JConfig.from_hparams(set_hparams(config=os.path.join(REPO, "egs/datasets/May/lm3d_radnerf.yaml")))
    assert dataclasses.asdict(cs.head_config()) == dataclasses.asdict(ref)
    assert cs.head_config() == TConfig.from_hparams(MAY_LM3D_RADNERF)


def test_chip_smoke_a2m_config_is_may_audio2motion_vae():
    """chip_smoke's a2m is the model GeneFaceInfer builds from
    egs/datasets/May/audio2motion_vae.yaml: 11,840,768 variables."""
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    yaml_hp = set_hparams(config=os.path.join(REPO, "egs/datasets/May/audio2motion_vae.yaml"))
    ref = {k: tuple(v.shape) for k, v in a2m_model_from_hparams(yaml_hp).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in a2m_model_from_hparams(cs.a2m_hparams()).state_dict().items()}
    assert got == ref
    assert sum(math.prod(s) for k, s in got.items() if not k.endswith("num_batches_tracked")) == 11_840_768


@pytest.mark.parametrize("entry", ["GeneFaceInfer", "GeneFaceInfer_audio", "HeadNeRFTask"])
def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch, entry):
    """Without `device` the entry points target the CUDA card; with no card
    they raise instead of running on the CPU. The audio-driven GeneFaceInfer
    (with a2m weights) runs on the CPU when asked."""
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig.from_hparams(HEAD)
    ds = TDataset(t_synthetic(num_frames=12, H=H, W=W), smo_win_size=5)
    a2m_hp = {"audio_in_dim": 64, "a2m_hidden_channels": 16, "a2m_enc_layers": 1, "a2m_dec_layers": 1,
              "a2m_flow_hidden": 8, "a2m_flow_blocks": 1}
    a2m = {"a2m_hparams": a2m_hp, "a2m_params": a2m_model_from_hparams(a2m_hp).state_dict()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "GeneFaceInfer":
            TInfer(cfg, RADNeRF(cfg).state_dict(), ds, _bench_occupancy(16))
        elif entry == "GeneFaceInfer_audio":
            TInfer(cfg, RADNeRF(cfg).state_dict(), ds, _bench_occupancy(16), **a2m)
        else:
            HeadNeRFTask(ds, cfg)
    if entry == "GeneFaceInfer_audio":
        infer = TInfer(cfg, RADNeRF(cfg).state_dict(), ds, _bench_occupancy(16), device="cpu", **a2m)
        assert infer.a2m_model.cond_proj.weight.device == torch.device("cpu")
        assert infer.face3d_helper.key_exp_base.device == torch.device("cpu")


def test_default_device_is_the_card(monkeypatch):
    from genefaceplusplus_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
