"""The port's training CLI trains grid heads into JAX work dirs, on the CPU:
a tiledgrid head (lip steps from step 1), then head + SR, then a tiledgrid
torso over the SR dir, 2 steps each, from `egs/datasets/May/*.yaml` with
small grid heads (desired resolution 64, tables of 2^10 rows a level,
narrow MLPs, grid 16) over a 32^2 identity rendered at 16^2. JAX's
`Trainer` restores the head and SR dirs; JAX's `GeneFaceInfer` serves the torso dir (and, through its config, the
SR dir's head and SR).

flax's init is skipped where it would run the 16-level grids eagerly:
JAX's templates are seeded port models' trees, whose values differ from
the trained ones, so a leaf that is not restored shows. Tolerances:
checkpoints equal to the live states and restores exact; frames against
JAX's >= 42 dB (tests/test_torch_train_cli.py's bar)."""

import json
import math
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.inference import serving as j_serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.training import radnerf_task as j_task
from genefaceplusplus_tpu.training import run as j_run
from genefaceplusplus_tpu.training import trainer as j_trainer
from genefaceplusplus_tpu.training.tasks import head_task as j_head
from genefaceplusplus_tpu.training.tasks import sr_task as j_sr
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, HW = 16, 32
CONFIGS = {"head": "egs/datasets/May/lm3d_radnerf.yaml", "sr": "egs/datasets/May/lm3d_radnerf_sr.yaml",
           "torso": "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"}
STAGE = {"head": "n_rays=64,num_samples=4,finetune_lips_start_iter=0,lip_window=8",
         "sr": "num_samples=4,lpips_start_iters=1,lip_window=8",
         "torso": "lambda_torso_deform=0.01"}
GRID = ("grid_type=tiledgrid,desired_resolution=64,log2_hashmap_size=10,hidden_dim_ambient=32,"
        "hidden_dim_sigma=32,hidden_dim_color=32,geo_feat_dim=16")
MIN_PSNR = 42.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    root = tmp_path_factory.mktemp("binary")
    d = synthetic(num_frames=12, H=HW, W=HW, seed=0)
    rs = np.random.RandomState(1)
    for s in d["train_samples"] + d["val_samples"]:
        t = rs.rand(HW, HW, 4).astype(np.float32)
        t[..., 3] = t[..., 3] > 0.5
        s["torso_img"] = t
    os.makedirs(root / "syn")
    np.save(root / "syn" / "trainval_dataset.npy", d, allow_pickle=True)
    return str(root)


def _argv(binary, stage, work_dir, steps=2, **extra):
    hp = (f"binary_data_dir={binary},video_id=syn,grid_size={G},individual_embedding_num=16,"
          f"max_updates={steps},val_check_interval=2,update_extra_interval=1,tb_log_interval=1,{GRID},"
          f"{STAGE[stage]}" + "".join(f",{k}={v}" for k, v in extra.items()))
    return ["--config", os.path.join(REPO, CONFIGS[stage]), "--work_dir", work_dir, "--device", "cpu",
            "--hparams", hp]


def _leaves_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def _has_leaf(tree):
    """A tree holds an array (optax's masked leaves are empty dicts)."""
    return any(_has_leaf(v) for v in tree.values()) if isinstance(tree, dict) else True


def _port_cfg(jax_cfg):
    return RADNeRFConfig(**{k: getattr(jax_cfg, k) for k in RADNeRFConfig.__dataclass_fields__})


def _seeded(module_cls, *args):
    return jax.tree.map(jnp.asarray, export_flax_params(module_cls(*args, generator=torch.Generator().manual_seed(99))))


def _head_state(self):
    """JAX's HeadNeRFTask.create_state on a seeded port template."""
    p = _seeded(RADNeRF, _port_cfg(self.cfg))
    return j_task.TrainState(params=p, opt_state=self.tx.init(p), global_step=jnp.asarray(0, jnp.int32),
                             lambda_ambient=jnp.asarray(1.0, jnp.float32), rng=jax.random.PRNGKey(self.seed))


def _sr_state(self):
    """JAX's SRHeadNeRFTask.create_state on seeded port templates."""
    p = {"head": _seeded(RADNeRF, _port_cfg(self.cfg)), "sr": _seeded(Superresolution, 3, self.dataset.H)}
    return j_sr.SRTrainState(params=p, opt_state=self.tx.init(p), global_step=jnp.asarray(0, jnp.int32),
                             lambda_ambient=jnp.asarray(1.0, jnp.float32), rng=jax.random.PRNGKey(self.seed))


class _JInfer(JInfer):
    """JAX's GeneFaceInfer on seeded port templates."""

    def _init_head(self):
        return _seeded(RADNeRF, _port_cfg(self.head_cfg))

    def _init_torso(self):
        from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig

        return _seeded(TorsoField, TorsoConfig(**{k: getattr(self.torso_cfg, k)
                                                  for k in TorsoConfig.__dataclass_fields__}))

    def _init_sr(self):
        return _seeded(Superresolution, 3, 256)


def _jax_fit(monkeypatch, argv):
    out = {}
    fit = j_trainer.Trainer.fit

    def capture(self, resume=True):
        out["state"] = fit(self, resume)
        return out["state"]

    monkeypatch.setattr(j_trainer.Trainer, "fit", capture)
    j_run.main(argv[:4] + ["--hparams", argv[-1]])
    return out["state"]


def test_cli_trains_grid_stages_that_jax_resumes_and_serves(binary, tmp_path, monkeypatch):
    dirs = {}
    for stage in ("head", "sr", "torso"):
        d = str(tmp_path / stage)
        extra = {"head_model_dir": dirs["sr"]} if stage == "torso" else {}
        state = run.main(_argv(binary, stage, d, **extra))
        dirs[stage] = d
        ckpt = get_last_checkpoint(d)[0]
        _leaves_equal(ckpt["state_dict"], state_to_flax(state))
        assert state.global_step == 2 and int(ckpt["global_step"]) == 2
        with open(os.path.join(d, "metrics.jsonl")) as f:
            steps = [m for m in map(json.loads, f) if "total_loss" in m]
        assert [m["step"] for m in steps] == [1, 2] and all(math.isfinite(m["total_loss"]) for m in steps)
        if stage == "head":
            assert any("lpips_loss" in m for m in steps)  # a lip step of the grid head
    for stage, tables in (("head", {"position_embedder", "ambient_embedder"}), ("torso", {"torso_embedder"})):
        mu = get_last_checkpoint(dirs[stage])[0]["state_dict"]["opt_state"]["inner_states"]["grid"][
            "inner_state"]["0"]["mu"]["params"]
        assert {k for k, v in mu.items() if _has_leaf(v)} == tables  # optax's 'grid' label: the tables only

    # JAX's Trainer restores the head and SR dirs exactly (max_updates 2:
    # restore only; tests/test_torch_grid_train.py holds JAX's grid steps to
    # the port's)
    monkeypatch.setattr(j_head.HeadNeRFTask, "create_state", _head_state)
    monkeypatch.setattr(j_sr.SRHeadNeRFTask, "create_state", _sr_state)
    for stage in ("head", "sr"):
        work = str(tmp_path / f"jax_{stage}")
        shutil.copytree(dirs[stage], work)
        restored = _jax_fit(monkeypatch, _argv(binary, stage, work))
        _leaves_equal(_np(flax.serialization.to_state_dict(restored)), get_last_checkpoint(work)[0]["state_dict"])

    # JAX's GeneFaceInfer serves the torso dir and, through its config, the SR dir
    j_inf = _JInfer(torso_model_dir=dirs["torso"])
    t_inf = TInfer.from_work_dirs(torso_model_dir=dirs["torso"], device="cpu")
    assert t_inf.head_cfg.grid_type == "tiledgrid" and t_inf.torso_cfg.grid_type == "tiledgrid"
    np.testing.assert_array_equal(t_inf.occupancy.numpy(), np.asarray(j_inf.occupancy))
    np.testing.assert_array_equal(t_inf.torso_occupancy_2d.numpy(), np.asarray(j_inf.torso_occupancy_2d))
    batch = t_inf.prepare_gt_batch([0, 3])
    inp = {"frames_per_dispatch": 2}
    ref = list(j_serving._render_frames(j_inf, batch, inp))
    got = list(t_inf.forward_secc2video(batch, inp))
    assert len(got) == len(ref) == 2 and got[0].shape == (HW, HW, 3)
    for a, b in zip(got, ref):
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        assert (math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)) >= MIN_PSNR
