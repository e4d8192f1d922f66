"""Training grid heads in the port against the JAX package, on the CPU: a
head converted from the reference by `tools/convert_ckpt.py --type head`
(tiledgrid and hashgrid) restored by both CLIs, refreshed and stepped;
one step of the head + SR and of the tiledgrid torso over a tiledgrid
head; validation's chunking and the fused field's refusal of a grid head.
tests/test_torch_grid_train_cli.py drives the CLI's stages.

The configs are the CLI's: `egs/datasets/May/*.yaml` with small grid
heads, as tests/test_torch_grid_field.py's (desired resolution 64, tables
of 2^10 rows a level, so the hash grid hashes; narrow MLPs; grid 16), over
a 32^2 identity rendered at 16^2 (SR to 32^2); the torso's tiled grid is
the reference's spec. JAX's steps run jitted. flax's init is skipped where
it would run the 16-level grids eagerly (~20 s): JAX's template is a
seeded port model's tree (`export_flax_params`), and every value a step
reads is restored or carried over. Each step starts both packages from the
same weights (the grid tables scaled to +-0.2, so they move the field),
occupancy, batch, ray noise (JAX's draw, replayed into the port) and
seeded Adam moments and count: Adam's first step from zero moments is lr x
sign(g), which turns float noise in a near-zero table gradient into a full
lr. Tolerances: losses, gradient norms and updated parameters atol 1e-4
(the port's float32 precedent); restores exact."""

import math
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.training import radnerf_task as j_task
from genefaceplusplus_tpu.training import run as j_run
from genefaceplusplus_tpu.training import trainer as j_trainer
from genefaceplusplus_tpu.training.tasks import head_task as j_head
from genefaceplusplus_tpu.training.tasks import sr_task as j_sr
from genefaceplusplus_tpu.training.tasks import torso_task as j_torso
from genefaceplusplus_tpu.utils.ckpt import restore_into as j_restore_into
from genefaceplusplus_tpu_torch.config import set_hparams as t_set_hparams
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.testing import reference_head_state, save_reference_ckpt
from genefaceplusplus_tpu_torch.tools import convert_ckpt
from genefaceplusplus_tpu_torch.training import grid_updater as t_grid
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.tasks import head_task as t_head
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import (
    export_flax_params, export_flax_tree, flax_tree_leaves, load_flax_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, HW, ATOL = 16, 32, 1e-4
CONFIGS = {"head": "egs/datasets/May/lm3d_radnerf.yaml", "sr": "egs/datasets/May/lm3d_radnerf_sr.yaml",
           "torso": "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"}
SMALL = ("desired_resolution=64,log2_hashmap_size=10,hidden_dim_ambient=32,hidden_dim_sigma=32,"
         "hidden_dim_color=32,geo_feat_dim=16")
STAGE = {"head": "n_rays=64,num_samples=4",
         "sr": "num_samples=4,lpips_start_iters=1,lip_window=8",
         "torso": "lambda_torso_deform=0.01"}
CONVERTED_STEP = 100


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


def _scaled(tree):
    """The tree with each grid table ('embeddings', [n_rows, 2]) x 2000."""
    if isinstance(tree, dict):
        return {k: np.asarray(v) * 2000.0 if k == "embeddings" else _scaled(v) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """A 32^2 synthetic identity with torso images, as the binarizer writes it."""
    root = tmp_path_factory.mktemp("binary")
    d = synthetic(num_frames=8, H=HW, W=HW, seed=3)
    rs = np.random.RandomState(4)
    for s in d["train_samples"] + d["val_samples"]:
        torso = rs.rand(HW, HW, 4).astype(np.float32)
        torso[..., 3] = torso[..., 3] > 0.5
        s["torso_img"] = torso
    os.makedirs(root / "syn")
    np.save(root / "syn" / "trainval_dataset.npy", d, allow_pickle=True)
    return str(root)


def _hparams(binary, stage, grid_type="tiledgrid", steps=2, **extra):
    interp = "smoothstep" if grid_type == "hashgrid" else "linear"
    common = (f"binary_data_dir={binary},video_id=syn,grid_size={G},individual_embedding_num=16,"
              f"max_updates={steps},val_check_interval=2,update_extra_interval=1,tb_log_interval=1,"
              f"grid_type={grid_type},grid_interpolation_type={interp},{SMALL}")
    return common + f",{STAGE[stage]}" + "".join(f",{k}={v}" for k, v in extra.items())


def _argv(binary, stage, work_dir, grid_type="tiledgrid", steps=2, **extra):
    return ["--config", os.path.join(REPO, CONFIGS[stage]), "--work_dir", work_dir, "--device", "cpu",
            "--hparams", _hparams(binary, stage, grid_type, steps, **extra)]


def _tasks(binary, tmp_path, monkeypatch, stage, **extra):
    """(JAX's task, the port's) as each CLI builds it from the same config
    (JAX's: its CLI with `Trainer.fit` stubbed)."""
    argv = _argv(binary, stage, str(tmp_path / "jax_task"), **extra)
    out = {}
    monkeypatch.setattr(j_trainer.Trainer, "fit", lambda self, resume=True: out.setdefault("task", self.task))
    j_run.main(argv[:4] + ["--hparams", argv[-1]])
    return out["task"], run.build_task(t_set_hparams(config=argv[1], hparams_str=argv[-1]), device="cpu")


def _seeded_opt_state(opt_state, seed=0, count=10):
    """optax's state dict with every moment leaf seeded (mu ~ N(0, 1e-3),
    nu ~ U(1e-4, 1e-3)) and every count `count`."""
    rs = np.random.RandomState(seed)

    def fill(path, x):
        if path[-1].key == "count":
            return np.asarray(count, np.int32)
        if any(getattr(p, "key", None) == "mu" for p in path):
            return np.asarray(rs.randn(*x.shape) * 1e-3, np.float32)
        return np.asarray(rs.uniform(1e-4, 1e-3, x.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(flax.serialization.to_state_dict(opt_state)))


def _seed_optimizers(tx, state_j, state_t, seed=0):
    """Both optimizers' moments and counts seeded alike; JAX's new state."""
    seeded = _seeded_opt_state(state_j.opt_state, seed)
    state_t.opt.load_optax(seeded)
    return state_j.replace(opt_state=flax.serialization.from_state_dict(state_j.opt_state, seeded))


def _start(task_j, state_cls, state_t, params_key="params", seed=0, **fields):
    """JAX's state from the port's model (its tables scaled, carried back
    into the port), both optimizers seeded alike."""
    params = _scaled(export_flax_tree(state_t.model))
    load_flax_tree(state_t.model, params)
    jparams = jax.tree.map(jnp.asarray, params)
    state_j = state_cls(**{params_key: jparams}, opt_state=task_j.tx.init(jparams),
                        global_step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(5), **fields)
    return _seed_optimizers(task_j.tx, state_j, state_t, seed)


def _noise(state_j, n):
    """The ray noise JAX's step draws from its state's key."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(state_j.rng)[1], (n,))))


def _assert_step_close(new_t, m_t, params_j, m_j, keys=None):
    """Metrics and every updated tensor atol 1e-4; returns the worst tensor
    error."""
    m_j = {k: float(v) for k, v in m_j.items()}
    for k in (keys or sorted(m_j)):
        np.testing.assert_allclose(float(m_t[k]), m_j[k], rtol=0, atol=ATOL, err_msg=k)
    ref = flax_tree_leaves(_np(params_j), new_t.model)
    got = {k: v.detach().numpy() for k, v in new_t.model.state_dict().items()}
    assert set(ref) == set(got)
    worst = max((float(np.abs(got[k] - ref[k]).max()), k) for k in ref)
    assert worst[0] <= ATOL, worst
    return worst


def _same_frames(task_j, task_t):
    """The port's frame store takes JAX's torso-composited background and
    face mask (cv2's hull and resize differ from the port's at a few
    pixels, tests/test_torch_train_steps.py)."""
    f_j, f_t = task_j._device_frames(), task_t._device_frames()
    f_t["bg"], f_t["mask"] = torch.from_numpy(np.array(f_j["bg"])), torch.from_numpy(np.array(f_j["mask"]))


def _template_params(cfg):
    """A seeded port model's variables for JAX's config `cfg`."""
    return export_flax_params(TRADNeRF(TConfig(**{k: getattr(cfg, k) for k in TConfig.__dataclass_fields__}),
                                       generator=torch.Generator().manual_seed(99)))


def _template_state(self):
    """JAX's HeadNeRFTask.create_state with a seeded port model's tree as
    the template in place of flax's eager init."""
    params = jax.tree.map(jnp.asarray, _template_params(self.cfg))
    return j_task.TrainState(params=params, opt_state=self.tx.init(params), global_step=jnp.asarray(0, jnp.int32),
                             lambda_ambient=jnp.asarray(self.hp.lambda_ambient, jnp.float32),
                             rng=jax.random.PRNGKey(self.seed))


def _jax_fit(monkeypatch, argv):
    """JAX's CLI on `argv` (it has no --device); returns its Trainer's task
    and final state."""
    out = {}
    fit = j_trainer.Trainer.fit

    def capture(self, resume=True):
        out["task"], out["state"] = self.task, fit(self, resume)
        return out["state"]

    monkeypatch.setattr(j_trainer.Trainer, "fit", capture)
    j_run.main(argv[:4] + ["--hparams", argv[-1]])
    return out["task"], out["state"]


def _leaves_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def _refresh_as_jax(task_j, state_j, task_t, state_t, ckpt):
    """JAX's own grid refresh (`update_extra_state`), then the port's
    through `RADNeRF.density` at JAX's jitter and the same drawn condition:
    grid and mean atol 1e-4 of the grid's scale, occupancy equal; the port's
    task takes the result."""
    sub = jax.random.split(task_j._grid_rng)[1]
    jitter = jax.random.uniform(sub, (G ** 3, 3), minval=-1.0 / G, maxval=1.0 / G)
    task_j.update_extra_state(state_j)
    idx = int(task_t.np_rng.randint(len(task_t.dataset)))
    model = state_t.model
    with torch.no_grad():
        feat = model.cal_cond_feat(torch.from_numpy(task_t.dataset.frame_cond_window(idx)))
        grid_t, occ_t, mean_t = t_grid.update_density_grid(
            lambda pts: model.density(pts, feat), task_t.density_grid, jitter=torch.from_numpy(np.array(jitter)))
    scale = float(np.abs(np.asarray(task_j.density_grid)).max())
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(task_j.density_grid), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(float(mean_t), task_j.mean_density, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(task_j.occupancy))
    assert not np.array_equal(occ_t.numpy(), np.asarray(ckpt["extra_state"]["occupancy"]))
    task_t.density_grid, task_t.occupancy = grid_t, occ_t


# ---------------------------------------------------------------- the head


@pytest.mark.parametrize("grid_type", ["tiledgrid", "hashgrid"])
def test_converted_head_resumes_refreshes_and_steps_as_jax(binary, tmp_path, monkeypatch, grid_type):
    """A reference head converted by `--type head` (params and grids only,
    at step 100; tiledgrid, or hashgrid with smoothstep):

    - the port's CLI restores the file's params exactly and keeps a fresh
      optimizer (count 0, no moments), step and lambda_ambient, as JAX's
      does, and both load the same density grid and occupancy;
    - JAX's Trainer keeps its template's params: the converter writes
      `{'params': <param tree>}` (the inference template's nesting) where
      its TrainState holds `{'params': {'params': <param tree>}}`, and its
      non-strict `restore_into` matches nothing (ROADMAP queue C). JAX's
      state takes the file's params as its GeneFaceInfer reads them
      (`restore_into` of the variables) for what follows;
    - tiledgrid: the grid refresh through `RADNeRF.density` at JAX's
      jitter (its own `update_extra_state`): grid and mean atol 1e-4 of the
      grid's scale, occupancy equal;
    - one head step from there (64 rays, the float32 field) with seeded
      moments: losses, gradient norms (the tables under grad_norm/grid) and
      every updated tensor atol 1e-4; the tables train in the grid group at
      10x the lr;
    - the port's CLI fine-tunes it to step 102 (tiledgrid: also a torso
      over it, 2 steps)."""
    src = str(tmp_path / "ref" / f"model_ckpt_steps_{CONVERTED_STEP}.ckpt")
    os.makedirs(os.path.dirname(src))
    hp = dict(t_set_hparams(config=os.path.join(REPO, CONFIGS["head"]), hparams_str=_hparams(binary, "head",
                                                                                              grid_type)))
    save_reference_ckpt(src, reference_head_state(hp, seed=1, occupancy=_occupancy()), global_step=CONVERTED_STEP)
    conv = str(tmp_path / "converted")
    convert_ckpt.main(["--input", src, "--type", "head", "--grid_size", str(G), "--out", conv])
    ckpt = get_last_checkpoint(conv)[0]
    assert set(ckpt["state_dict"]) == {"params"} and int(ckpt["global_step"]) == CONVERTED_STEP
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(conv, d)

    monkeypatch.setattr(j_head.HeadNeRFTask, "create_state", _template_state)
    task_j, state_j = _jax_fit(monkeypatch, _argv(binary, "head", dirs["jax"], grid_type, steps=CONVERTED_STEP))
    state_t = run.main(_argv(binary, "head", dirs["port"], grid_type, steps=CONVERTED_STEP))
    _leaves_equal(export_flax_tree(state_t.model), {"params": ckpt["state_dict"]["params"]})
    _leaves_equal(_np(state_j.params), _template_params(task_j.cfg))
    state_j = state_j.replace(params=jax.tree.map(jnp.asarray, j_restore_into(_np(state_j.params),
                                                                             ckpt["state_dict"])))
    _leaves_equal(export_flax_tree(state_t.model), _np(state_j.params))
    assert state_t.opt.count == 0 and not state_t.opt.opt.state  # fresh: no moments
    assert int(state_j.global_step) == state_t.global_step == 0 and float(state_t.lambda_ambient) == 1.0

    task_t = run.build_task(t_set_hparams(config=os.path.join(REPO, CONFIGS["head"]),
                                          hparams_str=_hparams(binary, "head", grid_type)), device="cpu")
    task_t.load_extra_state(ckpt["extra_state"])
    for k in ("density_grid", "occupancy"):
        np.testing.assert_array_equal(getattr(task_t, k).numpy(), np.asarray(getattr(task_j, k)), err_msg=k)

    if grid_type == "tiledgrid":
        _refresh_as_jax(task_j, state_j, task_t, state_t, ckpt)

    # one step
    state_j = _seed_optimizers(task_j.tx, state_j, state_t)
    _same_frames(task_j, task_t)
    model = state_t.model
    groups = {g["label"]: g for g in state_t.opt.opt.param_groups}
    assert groups["grid"]["mult"] == 10.0 and {id(p) for p in groups["grid"]["params"]} == {
        id(model.position_embedder.embeddings), id(model.ambient_embedder.embeddings)}
    b_j = task_j.sample_train_batch(global_step=CONVERTED_STEP)
    b_t = task_t.sample_train_batch(global_step=CONVERTED_STEP)
    np.testing.assert_array_equal(b_t["inds"], b_j["inds"])
    new_j, m_j = task_j.train_step(state_j, dict(b_j))
    new_t, m_t = task_t.train_step(state_t, dict(b_t), noise=_noise(state_j, len(b_j["inds"])))
    assert float(m_j["grad_norm/grid"]) > 0
    _assert_step_close(new_t, m_t, new_j.params, m_j, keys=[k for k in m_j if not k.startswith("density_grid/")])

    state = run.main(_argv(binary, "head", dirs["port"], grid_type, steps=CONVERTED_STEP + 2))
    assert state.opt.count == 2 and os.path.basename(get_last_checkpoint(dirs["port"])[1]) == \
        f"model_ckpt_steps_{CONVERTED_STEP + 2}.ckpt"
    if grid_type == "tiledgrid":
        torso = run.main(_argv(binary, "torso", str(tmp_path / "torso"), head_model_dir=dirs["port"]))
        assert torso.global_step == 2


# ---------------------------------------------------------------- head + SR, torso


def test_sr_step_matches_jax(binary, tmp_path, monkeypatch):
    """One full-frame head + SR step with a tiledgrid head (float32 SR, its
    mse on; the perceptual terms, a function of the SR frame alone, are
    held by tests/test_torch_train_steps.py): losses and gradient norms
    atol 1e-4, every updated tensor (the head's tables and the SR's
    noise_const included) atol 1e-4."""
    task_j, task_t = _tasks(binary, tmp_path, monkeypatch, "sr", sr_dtype="float32")
    occ = _occupancy()
    task_j.occupancy, task_t.occupancy = jnp.asarray(occ), torch.from_numpy(occ)
    state_t = task_t.create_state()
    state_j = _start(task_j, j_sr.SRTrainState, state_t, seed=1, lambda_ambient=jnp.asarray(1.0, jnp.float32))
    _same_frames(task_j, task_t)
    b_j, b_t = task_j.sample_train_batch(global_step=0), task_t.sample_train_batch(global_step=0)
    assert b_j["frame_idx"] == b_t["frame_idx"]
    new_j, m_j = task_j.train_step(state_j, b_j)
    new_t, m_t = task_t.train_step(state_t, b_t, noise=_noise(state_j, task_t.dataset.H * task_t.dataset.W))
    assert float(m_j["sr_mse_loss"]) > 0 and float(m_j["grad_norm/grid"]) > 0
    _assert_step_close(new_t, m_t, new_j.params, m_j)


def test_torso_step_matches_jax(binary, tmp_path, monkeypatch):
    """One step of the tiledgrid torso (the reference's spec: 16 levels,
    desired resolution 2048) behind a frozen tiledgrid head: losses and
    gradient norms atol 1e-4, every updated torso tensor atol 1e-4 (its
    table in the grid group); the head untouched."""
    head = {}
    monkeypatch.setattr(j_torso.TorsoNeRFTask, "_load_head",
                        lambda self, d: head.setdefault("params", jax.tree.map(jnp.asarray, _scaled(
                            _template_params(self.head_cfg)))))
    task_j, task_t = _tasks(binary, tmp_path, monkeypatch, "torso")
    assert task_t.torso_cfg.grid_type == "tiledgrid" and task_t.head_cfg.grid_type == "tiledgrid"
    load_flax_tree(task_t.head_model, _np(head["params"]))
    occ = _occupancy()
    task_j.occupancy, task_t.occupancy = jnp.asarray(occ), torch.from_numpy(occ)
    state_t = task_t.create_state()
    state_j = _start(task_j, j_torso.TorsoTrainState, state_t, params_key="torso_params", seed=2)
    head_before = {k: v.clone() for k, v in task_t.head_model.state_dict().items()}
    new_j, m_j = task_j.train_step(state_j, {"frame_idx": 3})
    new_t, m_t = task_t.train_step(state_t, {"frame_idx": 3})
    assert float(m_j["deform_reg"]) > 0 and float(m_j["grad_norm/grid"]) > 0
    _assert_step_close(new_t, m_t, new_j.torso_params, m_j)
    assert all(torch.equal(v, head_before[k]) for k, v in task_t.head_model.state_dict().items())


# ---------------------------------------------------------------- validation, refusal


def test_validation_chunks_and_fused_refusal(binary, tmp_path):
    """A hashgrid head's validation renders in chunks of 16,384 rays (JAX's);
    whole and 100-ray chunks give the same PSNR and PNG exactly.
    use_fused_field=True with a grid head raises, naming the Fourier-only
    kernel."""
    task = run.build_task(t_set_hparams(config=os.path.join(REPO, CONFIGS["head"]),
                                        hparams_str=_hparams(binary, "head", "hashgrid")), device="cpu")
    assert task.val_ray_chunk == 16384
    state = task.create_state()
    load_flax_tree(state.model, _scaled(export_flax_params(state.model)))
    task.occupancy = torch.from_numpy(_occupancy())
    out = {}
    for chunk in (None, 100):
        d = tmp_path / str(chunk)
        out[chunk] = (task.validate(state, max_frames=1, save_dir=str(d), ray_chunk=chunk),
                      (d / "validation_results" / "val_0_0.png").read_bytes())
    assert out[None] == out[100] and math.isfinite(out[None][0]["val_psnr"])
    with pytest.raises(ValueError, match="Fourier-only kernel"):
        t_head.HeadNeRFTask(task.dataset, task.cfg, t_head.HeadTaskConfig(use_fused_field=True), device="cpu")


def test_a_dir_that_restores_no_tensor_raises(binary, tmp_path):
    """The params-only resume still refuses a checkpoint whose params match
    no tensor of the model (another model's tree): the trainer raises
    before any step, where JAX's non-strict restore would train from its
    initial weights."""
    from genefaceplusplus_tpu_torch.utils.ckpt import save_flax_checkpoint

    work = str(tmp_path / "other")
    save_flax_checkpoint(work, 7, {"state_dict": {"params": {"params": {"postnet": {"kernel": np.ones((2, 2))}}}},
                                   "extra_state": {}})
    with pytest.raises(KeyError, match="no such port parameter"):
        run.main(_argv(binary, "head", work, steps=8))
    assert not os.path.exists(os.path.join(work, "metrics.jsonl"))  # no step was taken
